"""RSQ layer-wise quantization pipeline (Rotate -> Scale -> Quantize).

  1. fuse norms + rotate the model (skippable -> GPTQ baseline);
  2. layer by layer: capture every weight's input with the block's AttnCon
     column sums, turn them into token importances R, accumulate
     H_w = 2 X R² Xᵀ per weight (``gram`` kernel), run GPTQ, write the
     dequantized weights back and propagate the *quantized* block's
     outputs to the next layer (the standard GPTQ error-feedback scheme).

Baselines are config points: GPTQ = no rotation + uniform; QuaRot =
rotation + uniform; RSQ = rotation + a token-importance strategy.  This is
the reference's sequential schedule, one weight solve at a time; with
``pack_output`` every solve's (q, scale, zero) is also packed into the
serving artifact (``RSQPipeline.artifact``, saved by
``checkpoint.packed.save_packed_artifact``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.core import hessian as hess
from repro_torch.core.gptq import gptq_quantize
from repro_torch.core.importance import ImportanceInputs, get_strategy
from repro_torch.core.quantizer import QuantSpec, pack_codes
from repro_torch.core.rotation import rotate_model
from repro_torch.device import generator
from repro_torch.models.lm import Model, apply_block, capture_block


@dataclasses.dataclass(frozen=True)
class RSQConfig:
    bits: int = 3
    group_size: int = 128
    sym: bool = True
    rotate: bool = True
    importance: str = "attn_con"  # see core.importance.STRATEGIES
    r_min: float = 0.01
    r_max: float = 1.0
    damp: float = 0.01
    gptq_block: int = 128
    seed: int = 0  # draws the rotation when none is given
    # collect every solve's packed codes into ``RSQPipeline.artifact``
    pack_output: bool = False

    def spec(self) -> QuantSpec:
        return QuantSpec(bits=self.bits, group_size=self.group_size,
                         sym=self.sym)


def _strategy_kwargs(rsq: RSQConfig) -> dict:
    if rsq.importance == "uniform":
        return {}
    return {"r_min": rsq.r_min, "r_max": rsq.r_max}


def _is_quantizable(w: torch.Tensor) -> bool:
    return w.ndim >= 2 and min(w.shape[-2:]) >= 16


def _solve_spec(rsq: RSQConfig, d_in: int) -> tuple[QuantSpec, int]:
    """Per-d_in GPTQ block size and group-size fallback (as the reference:
    a group that cannot tile the block becomes one per-tensor group)."""
    block = min(rsq.gptq_block, d_in)
    spec = rsq.spec()
    gs = spec.group_size
    if gs != -1 and (gs > block or block % gs or d_in % gs):
        spec = dataclasses.replace(spec, group_size=-1)
    return spec, block


def quantize_layer_weights(p_block: dict, hessians: dict[str, torch.Tensor],
                           rsq: RSQConfig, *,
                           collect: Optional[dict] = None) -> tuple[dict, dict]:
    """GPTQ-solve every captured weight of one block.

    Returns (new block params with dequantized weights, {path: proxy
    loss}).  ``collect`` receives {path: {"q", "scale", "zero", "dtype"}}."""
    new_p = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in p_block.items()}
    report = {}
    for path, h in hessians.items():
        sub, name = path.split("/")
        w = new_p[sub][name]
        if not _is_quantizable(w):
            continue
        spec, block = _solve_spec(rsq, w.shape[0])
        out = gptq_quantize(w, h, spec, damp=rsq.damp, block=block)
        new_p[sub][name] = out["w_deq"].to(w.dtype)
        report[path] = float(out["err"])
        if collect is not None:
            collect[path] = {"q": out["q"], "scale": out["scale"],
                             "zero": out["zero"],
                             "dtype": str(w.dtype).removeprefix("torch.")}
    return new_p, report


class RSQPipeline:
    def __init__(self, model: Model, rsq: RSQConfig):
        self.model = model
        self.cfg = model.cfg
        self.rsq = rsq
        self.strategy = get_strategy(rsq.importance)
        self.skw = _strategy_kwargs(rsq)
        self.artifact: Optional[dict] = None

    def _importance(self, z_in, colsum) -> torch.Tensor:
        inp = ImportanceInputs(z_in=z_in, attn_colsum=colsum)
        return self.strategy(inp, **self.skw)

    def run(self, params: dict, calib_tokens: torch.Tensor, *,
            batch_size: int = 8, rotation: Optional[torch.Tensor] = None,
            verbose: bool = False) -> tuple[dict, dict]:
        """Quantize ``params``. calib_tokens: (N, T) integer tokens.

        ``rotation``: the (d_model, d_model) Q to rotate with; drawn from
        ``torch.Generator(rsq.seed)`` when None.  Returns (new_params,
        report)."""
        model, cfg, rsq = self.model, self.cfg, self.rsq
        report: dict[str, Any] = {"layers": {}, "rsq": dataclasses.asdict(rsq)}
        if rsq.rotate:
            gen = None if rotation is not None else generator(
                rsq.seed, model.device)
            params, _ = rotate_model(params, cfg, rotation, gen=gen)
            report["rotated"] = True
        new_params = dict(params)
        new_params["layers"] = list(params["layers"])

        calib = calib_tokens.to(model.device)
        acts = [model.embed(params, calib[i:i + batch_size])
                for i in range(0, calib.shape[0], batch_size)]
        entries: dict[str, dict] = {}
        meta: dict[str, dict] = {}
        def clock() -> float:  # wall time after the device has caught up
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            return time.perf_counter()

        for li, p_blk in enumerate(params["layers"]):
            t0 = clock()
            hessians: dict[str, torch.Tensor] = {}
            for x_b in acts:
                _, caps, _, colsum = capture_block(p_blk, cfg, x_b)
                r = self._importance(x_b, colsum).reshape(-1)
                for path, x_c in caps.items():
                    hessians[path] = hess.accumulate(
                        hessians.get(path), x_c.reshape(-1, x_c.shape[-1]), r)
                del caps
            t1 = clock()
            collect = {} if rsq.pack_output else None
            p_new, weights = quantize_layer_weights(p_blk, hessians, rsq,
                                                    collect=collect)
            del hessians
            new_params["layers"][li] = p_new
            tag = f"layer{li}"
            for path, sol in (collect or {}).items():
                name = f"{tag}/{path}"
                entries[name] = {"codes": pack_codes(sol["q"], rsq.bits),
                                 "scale": sol["scale"], "zero": sol["zero"]}
                d_in = int(sol["q"].shape[-2])
                meta[name] = {"path": path, "tag": tag, "d_in": d_in,
                              "group_size": d_in // int(sol["scale"].shape[-2]),
                              "dtype": sol["dtype"],
                              "loc": ["groups", li, 0]}
            t2 = clock()
            if li + 1 < len(params["layers"]):
                acts = [apply_block(p_new, cfg, x_b)[0] for x_b in acts]
            t3 = clock()
            rep = {"weights": weights, "seconds": round(t3 - t0, 4),
                   "capture_s": round(t1 - t0, 4),
                   "solve_s": round(t2 - t1, 4),
                   "apply_s": round(t3 - t2, 4)}
            report["layers"][tag] = rep
            if verbose:
                print(f"  [{tag}] {len(weights)} weights quantized in "
                      f"{rep['seconds']}s", flush=True)
        if rsq.pack_output:
            self.artifact = {
                "entries": entries, "meta": meta,
                "spec": {"bits": rsq.bits, "sym": rsq.sym,
                         "group_size": rsq.group_size, "method": "gptq"}}
            report["packed"] = {"entries": len(entries)}
        return new_params, report


def quantize_model(model: Model, params: dict, calib_tokens,
                   rsq: RSQConfig, **kw):
    return RSQPipeline(model, rsq).run(params, calib_tokens, **kw)
