"""Public wrapper: multi-head AttnCon scores for the RSQ pipeline.

Takes (B, T, H, Dh) q and (B, T, KV, Dh) k and returns the paper's
R_j = sum_{heads, queries} A[h, i, j] of shape (B, T), A the causal
softmax attention map.  The GQA head
mapping (query head h reads key head h // (H // KV)) is handed to the
kernel, which reads the un-repeated keys; the sum over heads happens here.
Dispatch is by device only: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attn_colsum.ref import attn_colsum_ref

MAX_SPLITS = 4  # query-tile splits per key tile (pass 2)
TILE = 64  # the kernel's query / key tile


def attn_colsum(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be (B, T, H, Dh) and k (B, T, KV, Dh)")
    b, t, h, dh = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != dh \
            or h % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    if q.device.type == "cpu":
        return attn_colsum_ref(q, k)
    if q.device.type != "cuda":
        raise ValueError(f"attn_colsum runs on cpu or cuda, not {q.device}")
    from repro_torch.kernels.attn_colsum.kernel import attn_colsum_cuda

    if k.device != q.device:
        raise ValueError(f"q on {q.device} but k on {k.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise TypeError(f"attn_colsum kernel takes fp32/bf16 q and k of one "
                        f"type, not {q.dtype}/{k.dtype}")
    n_tiles = -(-t // TILE)
    col = attn_colsum_cuda(q.contiguous(), k.contiguous(),
                           min(MAX_SPLITS, n_tiles))
    attn_colsum.launches += 1
    return col.view(b, h, t).sum(1)


attn_colsum.launches = 0
