"""The port's sampling stream: stateless per (seed, token index).

Token ``j`` of a request with seed ``s`` is greedy at temperature 0, else
``argmax(logits / temperature + g)`` with Gumbel noise ``g`` drawn from a
counter-based hash of ``(s, j, vocabulary index)``.  Nothing is carried
from one draw to the next, so ``launch.serve.generate`` and the engine's
decode bursts (and a later replay of a preempted request) draw the same
token from the same logits, on the device, without a host sync.  The
stream cannot match the reference's ``jax.random``; it is this port's own.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding [0, 2^32):
    xor-shifts and multiplies by odd constants below 2^31, so no product
    leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B,) seeds and (B,) token indices -> (B, vocab) fp32 Gumbel noise."""
    h = _mix32(_mix32(seeds.long() & _M32) ^ (index.long() & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    x = _mix32(_mix32((h[:, None] + v[None, :] * 0x9E3779B9) & _M32))
    u = ((x >> 8).float() + 0.5) * 2.0 ** -24     # exact, in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  seeds: torch.Tensor, index: torch.Tensor, *,
                  sampled: bool = True) -> torch.Tensor:
    """(B, V) fp32 logits -> (B,) int64 tokens.  temperature: (B,) (0 =
    greedy); seeds/index: (B,) ints.  ``sampled=False`` (every row greedy)
    skips the noise."""
    greedy = logits.argmax(-1)
    if not sampled:
        return greedy
    safe = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    noise = gumbel_noise(seeds, index, logits.shape[-1])
    drawn = (logits / safe[:, None] + noise).argmax(-1)
    return torch.where(temperature > 0, drawn, greedy)
