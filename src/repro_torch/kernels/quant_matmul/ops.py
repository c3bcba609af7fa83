"""Public wrapper: weight-only quantized GEMM for serving.

``PackedWeight`` is the serving-side parameter of a quantized projection:
the packed codes (int32 tensor holding the reference's uint32 words, packed
along d_in), the per-group fp32 ``(scale, zero)`` and the static geometry
``(bits, group_size, d_in)``.  It stands in a param tree wherever an fp
``(d_in, d_out)`` matrix would, and ``models.layers.linear`` routes it
through :func:`quant_matmul`.

Dispatch is by the activation's device and nothing else: a CPU tensor takes
the plain version (``ref``); a CUDA tensor launches the kernel, at every bit
width (2/3/4/8, the ragged 3-bit word included) and every shape, or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantizer import (QuantSpec, pack_codes,
                                        values_per_word, words_from_numpy)
from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

BITS = (2, 3, 4, 8)


@dataclasses.dataclass
class PackedWeight:
    """Packed quantized projection.

    ``w_packed``: (ceil(d_in / vpw), d_out) int32 words; ``scale``/``zero``:
    (d_in // group_size, d_out) fp32."""

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
        n_words, d_out = self.w_packed.shape
        n_groups = self.d_in // self.group_size
        if (self.w_packed.dtype != torch.int32
                or n_words != -(-self.d_in // vpw)
                or self.d_in % self.group_size
                or self.scale.shape != (n_groups, d_out)
                or self.zero.shape != (n_groups, d_out)):
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


def pack_weight(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                spec: QuantSpec) -> PackedWeight:
    d_in = q.shape[-2]
    gs = d_in if spec.group_size == -1 else spec.group_size
    return PackedWeight(w_packed=pack_codes(q, spec.bits),
                        scale=scale.float(), zero=zero.float(),
                        bits=spec.bits, group_size=gs, d_in=d_in)


def packed_weight_from_artifact(entry: dict, em: dict, spec: dict,
                                device="cuda") -> PackedWeight:
    """One packed-artifact entry (numpy ``codes``/``scale``/``zero``) ->
    ``PackedWeight`` on ``device``; the codes move still packed."""
    return PackedWeight(
        w_packed=words_from_numpy(entry["codes"]),
        scale=torch.from_numpy(entry["scale"].astype("float32")),
        zero=torch.from_numpy(entry["zero"].astype("float32")),
        bits=int(spec["bits"]), group_size=int(em["group_size"]),
        d_in=int(em["d_in"])).to(resolve_device(device))


def quant_matmul(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y = x @ dequant(pw).  x: (m, d_in) fp32 or bf16 -> (m, d_out) in
    x's dtype, fp32 accumulation."""
    if x.ndim != 2 or x.shape[1] != pw.d_in:
        raise ValueError(f"x must be (m, {pw.d_in}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero,
                                bits=pw.bits, group_size=pw.group_size,
                                d_in=pw.d_in)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_cuda

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul kernel takes fp32/bf16 x, not {x.dtype}")
    for name in ("w_packed", "scale", "zero"):
        a = getattr(pw, name)
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"packed weight {name} must be contiguous on "
                             f"{x.device} (use PackedWeight.to)")
    if pw.scale.dtype != torch.float32 or pw.zero.dtype != torch.float32:
        raise TypeError("packed weight scale/zero must be float32")
    out = quant_matmul_cuda(x.contiguous(), pw.w_packed, pw.scale, pw.zero,
                            bits=pw.bits, group_size=pw.group_size)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
