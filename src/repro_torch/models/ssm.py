"""Mamba-2 (SSD, state-space duality) mixer, the reference's
``models/ssm.py`` in PyTorch: the chunked matmul form of the scan.

Within a chunk the output is a (chunk x chunk) decay-weighted product; the
state (B, nh, hd, st) carries from chunk to chunk, so the decay matrix
exists for one chunk at a time.  The reference writes this with einsums
inside a ``lax.scan`` (no Pallas kernel), and so does the port: plain
PyTorch on tensors, one chunk a Python iteration.  The four projections go
through ``layers.linear``, so a packed model runs them through
``quant_matmul``.

Projections as the reference splits them: ``wzx`` (the gate z and the
input x, 2·d_inner columns), ``wbc`` (the shared B and C, 2·state), ``wdt``
(one dt a head), ``out_proj`` (d_inner -> d_model).  ``A_log``, ``D`` and
``dt_bias`` are fp32 whatever the model's dtype; the carried SSM state is
fp32 and the conv window is in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, linear, rms_norm


def _dims(cfg) -> tuple[int, int, int, int]:
    return cfg.d_inner, cfg.ssm_d_state, cfg.ssm_n_heads, cfg.ssm_head_dim


def init_mamba(gen, cfg, dtype, device) -> dict:
    d, (di, st, nh, _) = cfg.d_model, _dims(cfg)
    w = cfg.ssm_conv_width

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * 0.1).to(dtype)

    def full(n, value, dt):
        return torch.full((n,), value, dtype=dt, device=device)

    return {
        "wzx": dense_init(gen, d, 2 * di, dtype, device),
        "wbc": dense_init(gen, d, 2 * st, dtype, device),
        "wdt": dense_init(gen, d, nh, dtype, device),
        "conv_x": normal((w, di)),
        "conv_bc": normal((w, 2 * st)),
        "conv_b": full(di + 2 * st, 0.0, dtype),
        "A_log": full(nh, 0.0, torch.float32),
        "D": full(nh, 1.0, torch.float32),
        "dt_bias": full(nh, 0.0, torch.float32),
        "norm": full(di, 1.0, dtype),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (W, C), b (C,); the taps
    added to the bias one at a time, in the reference's order."""
    width, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = b
    for i in range(width):
        out = out + xp[:, i:i + t] * w[i]
    return out


def _ssd_scan(x, dt, B, C, A, chunk: int):
    """Chunked SSD. x: (B, T, nh, hd); dt: (B, T, nh) fp32; B / C: (B, T,
    st); A: (nh,).  ``chunk = min(chunk, T)`` must divide T.  Returns y
    (B, T, nh, hd) fp32 and the final state (B, nh, hd, st) fp32."""
    b, t, nh, hd = x.shape
    st = B.shape[-1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    log_a = dt * A  # (B, T, nh), negative
    xdt = (x * dt[..., None]).float()
    Bf, Cf = B.float(), C.float()
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    h = torch.zeros((b, nh, hd, st), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        x_c, la_c, b_c, c_c = xdt[:, sl], log_a[:, sl], Bf[:, sl], Cf[:, sl]
        cs = torch.cumsum(la_c, dim=1)  # (B, cl, nh)
        # intra-chunk decay L[l, s] = exp(cs_l - cs_s) for l >= s
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # (B, l, s, nh)
        L = torch.where(mask, torch.exp(diff), 0.0)
        scores = torch.einsum("bln,bsn->bls", c_c, b_c)  # one for all heads
        y_diag = torch.einsum("blsh,bshp->blhp", scores[..., None] * L, x_c)
        # the carried state's contribution
        y_off = torch.einsum("bln,bhpn->blhp", c_c, h) \
            * torch.exp(cs)[..., None]
        chunk_end = cs[:, -1, :]  # (B, nh)
        decay_in = torch.exp(chunk_end[:, None, :] - cs)  # (B, cl, nh)
        s_c = torch.einsum("bln,blhp->bhpn", b_c, x_c * decay_in[..., None])
        h = torch.exp(chunk_end)[..., None, None] * h + s_c
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), h


def _forward(p: dict, cfg, x: torch.Tensor):
    """Full-sequence mixer: (out, the gated input of ``out_proj``, the
    conv's input (B, T, d_inner + 2·state), final SSM state)."""
    b, t, _ = x.shape
    di, st, nh, hd = _dims(cfg)
    zx = linear(x, p["wzx"])
    z, xin = zx[..., :di], zx[..., di:]
    bc = linear(x, p["wbc"])
    dt_raw = linear(x, p["wdt"]).float()
    pre_act = torch.cat([xin, bc], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    xbc = F.silu(_causal_conv(pre_act, conv_w, p["conv_b"]))
    xc, Bc, Cc = xbc[..., :di], xbc[..., di:di + st], xbc[..., di + st:]
    dt = F.softplus(dt_raw + p["dt_bias"])  # (B, T, nh)
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(b, t, nh, hd)
    y, h_final = _ssd_scan(xh, dt, Bc, Cc, A, cfg.ssm_chunk)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(b, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), y, pre_act, h_final


def conv_state(pre_act: torch.Tensor, width: int) -> torch.Tensor:
    """The last W - 1 rows of the conv's input (B, T, C), zero-padded in
    front when T < W - 1: the decode's conv window."""
    t = pre_act.shape[1]
    if t >= width - 1:
        return pre_act[:, t - (width - 1):]
    return F.pad(pre_act, (0, 0, width - 1 - t, 0))


def apply_mamba(p: dict, cfg, x: torch.Tensor, *, return_state: bool = False):
    """x: (B, T, D) -> (B, T, D); with ``return_state`` also (conv state
    (B, W-1, d_inner + 2·state), SSM state (B, nh, hd, state) fp32)."""
    out, _, pre_act, h_final = _forward(p, cfg, x)
    if return_state:
        return out, (conv_state(pre_act, cfg.ssm_conv_width), h_final)
    return out


def capture_mamba(p: dict, cfg, x: torch.Tensor):
    """Forward with each projection's calibration input: wzx, wbc and wdt
    see the (normed) stream, out_proj the gated output."""
    out, y, _, _ = _forward(p, cfg, x)
    return out, {"wzx": x, "wbc": x, "wdt": x, "out_proj": y}


def mamba_decode(p: dict, cfg, x: torch.Tensor, conv: torch.Tensor,
                 ssm: torch.Tensor) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``conv`` (B, W-1, d_inner + 2·state)
    and ``ssm`` (B, nh, hd, state) are the cache's buffers, advanced in
    place (copies into them, so a captured graph that reads them sees the
    new state at its next replay)."""
    b = x.shape[0]
    di, st, nh, hd = _dims(cfg)
    zx = linear(x, p["wzx"])
    z, xin = zx[..., :di], zx[..., di:]
    bc = linear(x, p["wbc"])
    dt_raw = linear(x, p["wdt"]).float()[:, 0]  # (B, nh)
    xbc_t = torch.cat([xin, bc], dim=-1)  # (B, 1, C)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)  # (W, C)
    window = torch.cat([conv, xbc_t], dim=1)  # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, conv_w)
                      + p["conv_b"])
    xc, Bc, Cc = (conv_out[:, :di], conv_out[:, di:di + st],
                  conv_out[:, di + st:])
    dt = F.softplus(dt_raw + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)
    xh = xc.reshape(b, nh, hd).float()
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bc.float())
    h_new = a[..., None, None] * ssm + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, Cc.float())
    y = y + p["D"][:, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = linear(y, p["out_proj"])
    conv.copy_(window[:, 1:])
    ssm.copy_(h_new)
    return out
