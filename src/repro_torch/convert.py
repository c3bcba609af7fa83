"""Map the reference's parameter tree (as numpy arrays) to the port's.

The reference stacks its decoder layers on a leading axis
(``params["groups"]["b0"][...]``, from ``jax.vmap(init_group)``); the port
keeps them as a list.  ``embed``, ``head`` and ``final_norm`` carry over as
they are.  The tests use this to run both packages on the same weights; the
port's own entry points draw their weights from a ``torch.Generator``.
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
    if cfg.family != "dense" or "prefix" in np_params or \
            set(np_params["groups"]) != {"b0"}:
        raise NotImplementedError("params_from_jax maps dense decoders "
                                  "(one block per scan group) only")
    stacked = np_params["groups"]["b0"]
    n_layers = np.asarray(stacked["mixer_norm"]).shape[0]

    def layer(i, tree):
        return {k: layer(i, v) if isinstance(v, dict)
                else _tensor(np.asarray(v)[i], device)
                for k, v in tree.items()}

    head = np_params.get("head")
    if head is None:  # tied embeddings: the head is the table's transpose
        head = np.asarray(np_params["embed"]).T
    return {
        "embed": _tensor(np_params["embed"], device),
        "final_norm": _tensor(np_params["final_norm"], device),
        "head": _tensor(head, device),
        "layers": [layer(i, stacked) for i in range(n_layers)],
    }
