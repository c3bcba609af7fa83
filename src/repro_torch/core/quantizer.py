"""Scalar weight quantizer: 2/3/4/8-bit, symmetric/asymmetric, per-group
scales along the input dim, plus uint32 bit-packing for the serving kernel.

Layout convention (as in the reference): weights are (d_in, d_out); a group
is ``group_size`` consecutive d_in rows sharing one (scale, zero) pair per
output column.  Codes pack ``32 // bits`` per 32-bit word along d_in, code
``c`` of a word in bits ``[c*bits, (c+1)*bits)``; 3-bit stores 10 codes per
word and zero-pads the last word.  Every function here is bitwise equal to
the reference on the same inputs.

Packed words are held in ``torch.int32`` tensors carrying the uint32 bit
pattern: torch on the CPU has no shifts for ``uint32``, so unpacking
shifts an ``int64`` widening of the words and masks.  ``words_to_numpy`` /
``words_from_numpy`` convert to and from the reference's numpy ``uint32``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 3
    group_size: int = 128  # -1: one group spanning all of d_in
    sym: bool = True

    @property
    def maxq(self) -> int:
        return 2 ** self.bits - 1

    def groups_for(self, d_in: int) -> int:
        gs = d_in if self.group_size == -1 else self.group_size
        if d_in % gs:
            raise ValueError(f"d_in {d_in} is not a multiple of group {gs}")
        return d_in // gs


def find_params(w_group: torch.Tensor, spec: QuantSpec):
    """w_group: (gs, d_out) -> (scale, zero) each (d_out,) fp32.

    The sym scale is one correctly rounded division of ``amax`` by the
    exactly representable ``maxq * 0.5`` (never a mul+div chain), which is
    what keeps it bitwise equal to the reference."""
    wf = w_group.float()
    maxq = spec.maxq
    if spec.sym:
        amax = wf.abs().amax(dim=0)
        scale = torch.clamp_min(amax / (maxq * 0.5), 1e-9)
        zero = torch.full_like(scale, float((maxq + 1) // 2))
    else:
        lo = torch.clamp_max(wf.amin(dim=0), 0.0)
        hi = torch.clamp_min(wf.amax(dim=0), 0.0)
        scale = torch.clamp_min((hi - lo) / maxq, 1e-9)
        zero = torch.round(-lo / scale)
    return scale, zero


def quantize_rtn(w: torch.Tensor, scale, zero, spec: QuantSpec) -> torch.Tensor:
    """Round-to-nearest (half to even, as ``jnp.round``). -> int32 codes."""
    q = torch.clamp(torch.round(w.float() / scale) + zero, 0, spec.maxq)
    return q.to(torch.int32)


def dequantize(q: torch.Tensor, scale, zero) -> torch.Tensor:
    return scale * (q.float() - zero)


def quantize_weight_rtn(w: torch.Tensor, spec: QuantSpec):
    """Plain RTN over the whole weight. Returns (w_deq, q, scales, zeros)."""
    d_in, d_out = w.shape
    g = spec.groups_for(d_in)
    wg = w.reshape(g, d_in // g, d_out)
    params = [find_params(wg[i], spec) for i in range(g)]
    scale = torch.stack([p[0] for p in params])
    zero = torch.stack([p[1] for p in params])
    q = quantize_rtn(wg, scale[:, None], zero[:, None], spec)
    deq = dequantize(q, scale[:, None], zero[:, None])
    return (deq.reshape(d_in, d_out).to(w.dtype), q.reshape(d_in, d_out),
            scale, zero)


# ------------------------------------------------------------------- packing


def values_per_word(bits: int) -> int:
    return 32 // bits  # 3-bit stores 10 values (2 bits wasted)


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """q: (..., d_in, d_out) int codes -> (..., ceil(d_in/vpw), d_out) words
    (int32 tensor holding the uint32 bit pattern).

    Rows that do not fill the last word are padded with zero codes, which
    the ``d_in`` argument of :func:`unpack_codes` strips again."""
    vpw = values_per_word(bits)
    d_in, d_out = q.shape[-2:]
    pad = (-d_in) % vpw
    q64 = q.to(torch.int64)
    if pad:
        q64 = torch.cat(
            [q64, q64.new_zeros(q64.shape[:-2] + (pad, d_out))], dim=-2)
    qw = q64.reshape(q64.shape[:-2] + (-1, vpw, d_out))
    shifts = (torch.arange(vpw, dtype=torch.int64, device=q.device)
              * bits)[:, None]
    words = (qw << shifts).sum(dim=-2) & 0xFFFFFFFF
    # reinterpret [0, 2^32) as the int32 with the same bit pattern
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int, d_in: int) -> torch.Tensor:
    """(..., n_words, d_out) words -> (..., d_in, d_out) int32 codes."""
    vpw = values_per_word(bits)
    w64 = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = (torch.arange(vpw, dtype=torch.int64, device=packed.device)
              * bits)[:, None]
    vals = (w64[..., :, None, :] >> shifts) & (2 ** bits - 1)
    out = vals.reshape(packed.shape[:-2] + (-1, packed.shape[-1]))
    return out[..., :d_in, :].to(torch.int32)


def dequantize_packed(packed: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, *, bits: int, d_in: int
                      ) -> torch.Tensor:
    """Packed codes + per-group params -> fp32 weight (..., d_in, d_out)."""
    q = unpack_codes(packed, bits, d_in)
    g = scale.shape[-2]
    if d_in % g:
        raise ValueError(f"d_in {d_in} is not a multiple of {g} groups")
    qg = q.reshape(q.shape[:-2] + (g, d_in // g, q.shape[-1]))
    deq = dequantize(qg, scale[..., :, None, :].float(),
                     zero[..., :, None, :].float())
    return deq.reshape(q.shape)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> the reference's numpy ``uint32`` layout."""
    return words.detach().cpu().numpy().view(np.uint32)


def words_from_numpy(words: np.ndarray) -> torch.Tensor:
    """numpy ``uint32`` words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))
