"""Top-k routed experts with shared experts (DeepSeek style): the
counterpart of the reference's ``models/moe.py`` on one device (its
``axis=None`` path; the port has no expert parallelism).

Every shape is static, as the reference's: the tokens routed to each expert
go into a buffer of ``moe_capacity`` slots (from the token count alone),
assignments beyond it are dropped (GShard semantics), the expert FFNs run
as batched products over the (E, C, d) buffers, and the slot outputs go
back to their tokens.  No step reads a value back to the host (no
``.item()``, no ``nonzero``, no boolean indexing), so a decode step with
routed experts can be captured in a CUDA graph and replayed.

Where the reference scatters with ``mode="drop"``, the port scatters into
one extra trash row and slices it off.  The reference adds the slot
outputs into their tokens with a scatter-add, slot by slot; the port
gathers each token's k slot outputs and adds them in ascending slot order,
the reference's order, with no atomics (whose order would change from run
to run on the card).  The reference's ``_capture_shared`` is
``layers.capture_dense_ffn``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import matmul
from repro_torch.models.layers import (apply_dense_ffn, capture_dense_ffn,
                                       dense_init, init_dense_ffn, linear)


def init_moe(gen: torch.Generator, cfg, dtype, device) -> dict:
    e, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff

    def experts_init(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, device=device,
                        dtype=torch.float32) * d_in ** -0.5
        return w.to(dtype)

    p = {"router": dense_init(gen, d, e, torch.float32, device),
         "experts": {"wi": experts_init(d, f), "wu": experts_init(d, f),
                     "wd": experts_init(f, d)}}
    if cfg.n_shared_experts:
        p["shared"] = init_dense_ffn(gen, d, cfg.n_shared_experts * f, dtype,
                                     device)
    return p


def route(router_w: torch.Tensor, x2d: torch.Tensor, top_k: int):
    """Returns (top_idx (T, k) int64, top_w (T, k) fp32, gates (T, E)).
    The router stays fp32.  ``jax.lax.top_k`` gives tied gates to the
    lower expert first; a stable descending sort does the same."""
    logits = matmul(x2d.float(), router_w.float())
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_idx = vals[:, :top_k], idx[:, :top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_idx, top_w, gates


def load_balance_loss(gates: torch.Tensor, top_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E · sum_e f_e · P_e."""
    dispatch = F.one_hot(top_idx, n_experts).float().sum(1)
    return n_experts * torch.sum(dispatch.mean(0) * gates.mean(0))


def moe_capacity(cfg, n_tokens: int) -> int:
    cap = n_tokens * cfg.moe_top_k / cfg.n_routed_experts * cfg.capacity_factor
    return max(8, int(math.ceil(cap / 8) * 8))


def _slots(top_idx: torch.Tensor, n_experts: int, capacity: int
           ) -> torch.Tensor:
    """(T, k) destination slot of every assignment: expert · C + its rank
    among that expert's assignments in token order, or E · C (the trash
    slot) where the rank reaches the capacity."""
    flat_e = top_idx.reshape(-1)
    n = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    ar = torch.arange(n, device=flat_e.device)
    rank_sorted = ar - torch.searchsorted(sorted_e, sorted_e)
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    dest = torch.where(rank < capacity, flat_e * capacity + rank,
                       n_experts * capacity)
    return dest.reshape(top_idx.shape)


def _expert_buffers(x2d: torch.Tensor, top_idx: torch.Tensor,
                    top_w: torch.Tensor, n_experts: int, capacity: int):
    """Gather routed tokens into (E, C, d) with drop-overflow.

    Returns (buf, slot_token, slot_w, dest): slot_token (E·C,) maps each
    slot to its source token (T for an empty slot, whose row of ``buf`` is
    zeros), slot_w (E·C,) is each slot's routing weight (0 when empty), and
    dest (T, k) each assignment's slot (E·C where it was dropped)."""
    t, k = top_idx.shape
    d = x2d.shape[-1]
    n_slots = n_experts * capacity
    dest = _slots(top_idx, n_experts, capacity)
    flat_dest = dest.reshape(-1)
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
    slot_token = torch.full((n_slots + 1,), t, dtype=torch.int64,
                            device=x2d.device).scatter_(0, flat_dest, flat_t)
    slot_w = torch.zeros((n_slots + 1,), dtype=top_w.dtype,
                         device=x2d.device).scatter_(
        0, flat_dest, top_w.reshape(-1))
    slot_token, slot_w = slot_token[:n_slots], slot_w[:n_slots]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    buf = x_pad[slot_token].reshape(n_experts, capacity, d)
    return buf, slot_token, slot_w, dest


def _combine(h: torch.Tensor, slot_w: torch.Tensor, dest: torch.Tensor
             ) -> torch.Tensor:
    """y (T, d): each token's slot outputs h (E·C, d), weighted by their
    routing weight in h's dtype, added in ascending slot order (a dropped
    assignment adds nothing)."""
    n_slots, d = h.shape
    hw = h * slot_w[:, None].to(h.dtype)
    hw = torch.cat([hw, hw.new_zeros((1, d))], dim=0)
    order = torch.sort(dest, dim=-1).values  # trash slot E·C sorts last
    y = hw[order[:, 0]]
    for j in range(1, dest.shape[1]):
        y = y + hw[order[:, j]]
    return y


def _expert_ffn(experts: dict, buf: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU over (E, C, d) buffers (``linear`` keeps
    the expert axis: a batched product for fp stacks, one head-batched
    ``quant_matmul`` launch for a packed stack)."""
    gate = F.silu(linear(buf, experts["wi"]))
    up = linear(buf, experts["wu"])
    return linear(gate * up, experts["wd"])


def apply_moe(p: dict, cfg, x: torch.Tensor):
    """x: (B, T, D) -> (y, aux_loss): the routed experts and, where the
    layer has them, the shared experts."""
    b, t, d = x.shape
    x2d = x.reshape(b * t, d)
    e = cfg.n_routed_experts
    top_idx, top_w, gates = route(p["router"], x2d, cfg.moe_top_k)
    aux = load_balance_loss(gates, top_idx, e)
    buf, _, slot_w, dest = _expert_buffers(x2d, top_idx, top_w, e,
                                           moe_capacity(cfg, b * t))
    h = _expert_ffn(p["experts"], buf).reshape(-1, d)
    y = _combine(h, slot_w, dest).to(x.dtype)
    if "shared" in p:
        y = y + apply_dense_ffn(p["shared"], x2d)
    return y.reshape(b, t, d), aux


def capture_moe(p: dict, cfg, x: torch.Tensor):
    """Forward returning per-weight calibration inputs for RSQ: (y, aux,
    caps).  The router and shared FFN see every token; each expert's
    wi / wu / wd see only its capacity buffer: ``experts/wi`` and
    ``experts/wu`` the (E, C, d) buffer (one tensor), ``experts/wd`` the
    (E, C, f) hidden, and ``__slot_token`` (E·C,) maps each slot to its
    token (T for an empty slot)."""
    b, t, d = x.shape
    x2d = x.reshape(b * t, d)
    e = cfg.n_routed_experts
    top_idx, top_w, gates = route(p["router"], x2d, cfg.moe_top_k)
    buf, slot_token, slot_w, dest = _expert_buffers(
        x2d, top_idx, top_w, e, moe_capacity(cfg, b * t))
    ex = p["experts"]
    hidden = F.silu(linear(buf, ex["wi"])) * linear(buf, ex["wu"])
    h = linear(hidden, ex["wd"]).reshape(-1, d)
    y = _combine(h, slot_w, dest).to(x.dtype)
    caps = {"experts/wi": buf, "experts/wu": buf, "experts/wd": hidden,
            "__slot_token": slot_token}
    if "shared" in p:
        sh, sh_caps = capture_dense_ffn(p["shared"], x2d)
        y = y + sh
        caps.update({f"shared/{k}": v for k, v in sh_caps.items()})
    aux = load_balance_loss(gates, top_idx, e)
    return y.reshape(b, t, d), aux, caps
