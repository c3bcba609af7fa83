"""Map the reference's parameter tree (as numpy arrays) to the port's.

The reference keeps its first ``first_dense_layers`` decoder layers as a
list (``params["prefix"]``) and stacks the rest in layer groups of
``scan_period`` blocks, each block position on a leading axis of its own
(``params["groups"]["b0"][...]`` ... ``["b{P-1}"]``, from
``jax.vmap(init_group)``); the port keeps them all as one list, prefix
layers first, then group by group: layer prefix + g·P + o is block ``o``
of group ``g``.  ``embed``, ``head``, ``final_norm`` and a rotated
enc-dec model's ``frame_proj`` carry over as they are (a tied model has no
``head``); an encoder's stacked blocks (``encoder.groups.b0``, one block a
group) become the list ``encoder.layers`` beside its ``final_norm``.  The
tests use this to run both
packages on the same weights; the port's own entry points draw their
weights from a ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig, *,
                    device="cuda") -> dict:
    """Reference params (nested dicts of numpy arrays) -> port params."""
    device = resolve_device(device)
    groups = np_params["groups"]
    period = cfg.scan_period
    if set(groups) != {f"b{o}" for o in range(period)}:
        raise ValueError(f"{cfg.name}: layer groups of {sorted(groups)}, "
                         f"expected b0 ... b{period - 1}")
    n_groups = np.asarray(groups["b0"]["mixer_norm"]).shape[0]

    def layer(i, tree):
        """Block ``i`` of a stacked tree, or the whole of an unstacked one
        (``i`` None)."""
        return {k: layer(i, v) if isinstance(v, dict)
                else _tensor(np.asarray(v) if i is None else
                             np.asarray(v)[i], device)
                for k, v in tree.items()}

    out = {"embed": _tensor(np_params["embed"], device),
           "final_norm": _tensor(np_params["final_norm"], device)}
    # a tied model has no head, and only a rotated enc-dec has frame_proj
    for name in ("head", "frame_proj"):
        if name in np_params:
            out[name] = _tensor(np_params[name], device)
    out["layers"] = ([layer(None, blk) for blk in np_params.get("prefix", [])]
                     + [layer(g, groups[f"b{o}"]) for g in range(n_groups)
                        for o in range(period)])
    if "encoder" in np_params:
        enc = np_params["encoder"]
        blocks = enc["groups"]["b0"]
        out["encoder"] = {
            "layers": [layer(li, blocks) for li in range(
                np.asarray(blocks["mixer_norm"]).shape[0])],
            "final_norm": _tensor(enc["final_norm"], device)}
    return out
