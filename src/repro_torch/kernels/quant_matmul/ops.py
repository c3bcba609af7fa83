"""Public wrappers: weight-only quantized GEMMs for serving.

``PackedWeight`` is the serving-side parameter of a quantized projection:
the packed codes (int32 tensor holding the reference's uint32 words, packed
along d_in), the per-group fp32 ``(scale, zero)`` and the static geometry
``(bits, group_size, d_in)``.  It stands in a param tree wherever an fp
``(d_in, d_out)`` matrix would, and ``models.layers.linear`` routes it
through :func:`quant_matmul`.  It may carry a leading head axis: MLA's
per-head views of a packed ``wkv_b`` (:func:`mla_latent_weights`), which
:func:`quant_matmul` (expand) and :func:`quant_matmul_t` (absorb) take in
one launch for all heads.

Dispatch is by the activation's device and nothing else: a CPU tensor takes
the plain version (``ref``); a CUDA tensor launches the kernel, at every bit
width (2/3/4/8, the ragged 3-bit word included) and every shape, or raises.
Zeros are integers in [0, 2^bits - 1] (``check_zero``, where a weight is
packed or loaded): the kernels rely on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantizer import (QuantSpec, pack_codes,
                                        values_per_word, words_from_numpy)
from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul.ref import (quant_matmul_ref,
                                                  quant_matmul_t_ref)

BITS = (2, 3, 4, 8)


@dataclasses.dataclass
class PackedWeight:
    """Packed quantized projection.

    ``w_packed``: (ceil(d_in / vpw), d_out) int32 words; ``scale``/``zero``:
    (d_in // group_size, d_out) fp32; or the same with a leading head axis
    (H, ...), which may be a strided view of a 2-D parent."""

    w_packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    d_in: int

    def __post_init__(self):
        if self.bits not in BITS:
            raise ValueError(f"bits must be one of {BITS}, got {self.bits}")
        vpw = values_per_word(self.bits)
        lead = tuple(self.w_packed.shape[:-2])
        n_words, d_out = self.w_packed.shape[-2:]
        n_groups = self.d_in // self.group_size
        if (self.w_packed.dtype != torch.int32 or len(lead) > 1
                or n_words != -(-self.d_in // vpw)
                or self.d_in % self.group_size
                or self.scale.shape != lead + (n_groups, d_out)
                or self.zero.shape != lead + (n_groups, d_out)):
            raise ValueError(
                f"inconsistent packed weight: words {tuple(self.w_packed.shape)}"
                f" {self.w_packed.dtype}, scale {tuple(self.scale.shape)}, "
                f"zero {tuple(self.zero.shape)}, bits={self.bits}, "
                f"group_size={self.group_size}, d_in={self.d_in}")

    @property
    def nbytes(self) -> int:
        """Resident bytes of the packed representation."""
        return sum(a.numel() * a.element_size()
                   for a in (self.w_packed, self.scale, self.zero))

    def to(self, device) -> "PackedWeight":
        return dataclasses.replace(
            self, w_packed=self.w_packed.to(device).contiguous(),
            scale=self.scale.to(device, torch.float32).contiguous(),
            zero=self.zero.to(device, torch.float32).contiguous())


def is_packed(w) -> bool:
    return isinstance(w, PackedWeight)


def check_zero(zero: torch.Tensor, bits: int) -> None:
    """Raises unless every zero is an integer in [0, 2^bits - 1], as RTN
    and GPTQ make it (``core.quantizer.find_params`` rounds it).  The bf16
    prefill kernel feeds ``code - zero`` to the tensor cores as an exact
    bf16 integer, so a fractional zero would give other results on the card
    than the plain version; the weight is checked once, where it is built
    or loaded."""
    z = zero.float()
    bad = (z != torch.round(z)) | (z < 0) | (z > 2 ** bits - 1)
    if bool(bad.any()):
        raise ValueError(f"packed weight zeros must be integers in [0, "
                         f"{2 ** bits - 1}] at {bits} bits; got "
                         f"{int(bad.sum())} others, e.g. {z[bad][0].item()}")


def pack_weight(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                spec: QuantSpec) -> PackedWeight:
    d_in = q.shape[-2]
    gs = d_in if spec.group_size == -1 else spec.group_size
    check_zero(zero, spec.bits)
    return PackedWeight(w_packed=pack_codes(q, spec.bits),
                        scale=scale.float(), zero=zero.float(),
                        bits=spec.bits, group_size=gs, d_in=d_in)


def packed_weight_from_artifact(entry: dict, em: dict, spec: dict,
                                device="cuda") -> PackedWeight:
    """One packed-artifact entry (numpy ``codes``/``scale``/``zero``) ->
    ``PackedWeight`` on ``device``; the codes move still packed.  Raises
    if a zero is not an integer in range (:func:`check_zero`)."""
    device = resolve_device(device)
    pw = PackedWeight(
        w_packed=words_from_numpy(entry["codes"]),
        scale=torch.from_numpy(entry["scale"].astype("float32")),
        zero=torch.from_numpy(entry["zero"].astype("float32")),
        bits=int(spec["bits"]), group_size=int(em["group_size"]),
        d_in=int(em["d_in"]))
    check_zero(pw.zero, pw.bits)
    return pw.to(device)


def _check_cuda(name: str, x: torch.Tensor, pw: PackedWeight,
                dtypes) -> None:
    """What the kernels take: x on the card in one of ``dtypes``; codes,
    scale and zero on x's device with unit column stride, scale and zero
    with one layout (head-batched views are strided, not copied)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} kernel takes {dtypes} x, not {x.dtype}")
    for field in ("w_packed", "scale", "zero"):
        a = getattr(pw, field)
        if a.device != x.device or a.stride(-1) != 1:
            raise ValueError(f"packed weight {field} must lie on {x.device} "
                             f"with unit column stride (use PackedWeight.to)")
    if pw.scale.dtype != torch.float32 or pw.zero.dtype != torch.float32:
        raise TypeError("packed weight scale/zero must be float32")
    if pw.scale.stride() != pw.zero.stride():
        raise ValueError("packed weight scale and zero must share a layout")


def _heads_of(x: torch.Tensor, pw: PackedWeight, name: str) -> int:
    """1 for a 2-D weight and x (m, ·); H for a head-batched weight and x
    (H, m, ·); raises otherwise."""
    if pw.w_packed.ndim == 2 and x.ndim == 2:
        return 1
    if pw.w_packed.ndim == 3 and x.ndim == 3 and \
            x.shape[0] == pw.w_packed.shape[0]:
        return x.shape[0]
    raise ValueError(f"{name}: x {tuple(x.shape)} does not match packed "
                     f"weight {tuple(pw.w_packed.shape)} (2-D x for a 2-D "
                     f"weight, (H, m, ·) for H heads)")


def quant_matmul(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y = x @ dequant(pw).  x: (m, d_in) fp32 or bf16 -> (m, d_out) in
    x's dtype, fp32 accumulation; with a head-batched ``pw``, x: (H, m,
    d_in) -> (H, m, d_out), one launch for all heads."""
    heads = _heads_of(x, pw, "quant_matmul")
    if x.shape[-1] != pw.d_in:
        raise ValueError(f"x must be (..., m, {pw.d_in}), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero,
                                bits=pw.bits, group_size=pw.group_size,
                                d_in=pw.d_in)
    _check_cuda("quant_matmul", x, pw, (torch.float32, torch.bfloat16))
    from repro_torch.kernels.quant_matmul.kernel import (qmm_kernel,
                                                         quant_matmul_cuda)

    out = quant_matmul_cuda(x.reshape(heads, *x.shape[-2:]).contiguous(),
                            pw.w_packed, pw.scale, pw.zero, bits=pw.bits,
                            group_size=pw.group_size)
    quant_matmul.launches += 1
    quant_matmul.by_kernel[qmm_kernel(x.shape[-2], x.dtype)] += 1
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


def quant_matmul_t(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Latent-layout product y = x @ dequant(pw)ᵀ: the packed axis (d_in)
    is the output, the contraction runs over the weight's columns (MLA
    absorbs W_k into its queries this way without an fp weight).  x: (m,
    d_out) -> (m, d_in), or (H, m, d_out) -> (H, m, d_in) with a
    head-batched ``pw``, one launch for all heads.  fp32 in and out."""
    _heads_of(x, pw, "quant_matmul_t")
    if x.shape[-1] != pw.w_packed.shape[-1]:
        raise ValueError(f"x must be (..., m, {pw.w_packed.shape[-1]}), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_t_ref(x, pw.w_packed, pw.scale, pw.zero,
                                  bits=pw.bits, group_size=pw.group_size,
                                  d_in=pw.d_in)
    _check_cuda("quant_matmul_t", x, pw, (torch.float32,))
    from repro_torch.kernels.quant_matmul.kernel import (qmm_t_kernel,
                                                         quant_matmul_t_cuda)

    heads = x.shape[0] if x.ndim == 3 else 1
    kernel = qmm_t_kernel(x.shape[-2], pw.bits, pw.group_size)
    out = quant_matmul_t_cuda(x.reshape(heads, *x.shape[-2:]).contiguous(),
                              pw.w_packed, pw.scale, pw.zero, bits=pw.bits,
                              group_size=pw.group_size, d_in=pw.d_in,
                              kernel=kernel)
    quant_matmul_t.launches += 1
    quant_matmul_t.by_kernel[kernel] += 1
    return out.reshape(x.shape[:-1] + (pw.d_in,))


def mla_latent_weights(pw: PackedWeight, n_heads: int, dn: int, dv: int
                       ) -> tuple[PackedWeight, PackedWeight]:
    """Per-head views (pw_k, pw_v) of a packed MLA ``wkv_b`` (kvr, H·(dn +
    dv)): packing runs along kvr, so a head's columns are an exact slice of
    the codes, scales and zeros.  ``pw_k`` has (H, ceil(kvr/vpw), dn)
    codes, for :func:`quant_matmul_t` (absorb W_k into the queries);
    ``pw_v`` (H, ceil(kvr/vpw), dv), for :func:`quant_matmul` (expand the
    latent context through W_v).  Both are strided views of the parent:
    nothing is copied; the kernels take the parent's row stride and a
    per-head column offset."""
    if pw.w_packed.ndim != 2 or pw.w_packed.shape[1] != n_heads * (dn + dv):
        raise ValueError(f"wkv_b codes {tuple(pw.w_packed.shape)} are not "
                         f"(words, {n_heads} x ({dn} + {dv}))")

    def view(a, lo, hi):
        return a.reshape(a.shape[0], n_heads, dn + dv)[:, :, lo:hi] \
            .permute(1, 0, 2)

    def mk(lo, hi):
        return PackedWeight(w_packed=view(pw.w_packed, lo, hi),
                            scale=view(pw.scale, lo, hi),
                            zero=view(pw.zero, lo, hi), bits=pw.bits,
                            group_size=pw.group_size, d_in=pw.d_in)

    return mk(0, dn), mk(dn, dn + dv)


quant_matmul.launches = 0
# the launches above split by the CUDA kernel that ran (kernel.qmm_kernel)
quant_matmul.by_kernel = {"qmm_decode": 0, "qmm_tc": 0, "qmm_tc_f32": 0}
quant_matmul_t.launches = 0
quant_matmul_t.by_kernel = {"qmm_t_decode": 0, "qmm_t_tile": 0}
