"""RSQ quantization entry point of the PyTorch port.

Builds the model (random weights from ``torch.Generator(seed)``), draws the
calibration set, runs Rotate-Scale-Quantize, reports perplexity against
the fp model and optionally writes the packed serving artifact.

  PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama3-8b \\
      --n-layers 2 --n-calib 8 --calib-seq 512 --pack-out /tmp/rsq_art

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--n-layers`` cuts the
depth of the chosen architecture and keeps its widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.checkpoint.packed import save_packed_artifact
from repro_torch.configs import get_config
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.data.calibration import calibration_set, heldout_set
from repro_torch.device import generator, resolve_device
from repro_torch.models.lm import Model


@torch.no_grad()
def eval_ppl(model: Model, params: dict, tokens: torch.Tensor,
             batch: int = 8) -> float:
    """exp of the mean next-token loss (labels = tokens rolled by one)."""
    total, n = 0.0, 0
    tokens = tokens.to(model.device)
    for i in range(0, tokens.shape[0], batch):
        b = tokens[i:i + batch]
        loss = model.loss(params, b, torch.roll(b, -1, dims=1))
        total += float(loss) * b.shape[0]
        n += b.shape[0]
    return math.exp(total / n)


def model_config(arch: str, n_layers: int, dtype: str):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b-smoke")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                    "architecture's own); widths are kept")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--importance", default="attn_con")
    ap.add_argument("--r-min", type=float, default=0.01)
    ap.add_argument("--no-rotate", action="store_true")
    ap.add_argument("--n-calib", type=int, default=32)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--pack-out", default=None, metavar="DIR",
                    help="write the packed serving artifact here; serve it "
                    "with repro_torch.launch.serve --packed DIR")
    ap.add_argument("--out", default=None, help="write report JSON here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.n_layers, args.dtype)
    model = Model(cfg, device)
    params = model.init(generator(args.seed, device))
    calib = calibration_set(cfg.vocab_size, args.n_calib, args.calib_seq,
                            seed=args.seed)
    heldout = heldout_set(cfg.vocab_size, args.n_calib, args.calib_seq,
                          seed=args.seed)
    rsq = RSQConfig(bits=args.bits, group_size=args.group_size,
                    rotate=not args.no_rotate, importance=args.importance,
                    r_min=args.r_min, seed=args.seed,
                    pack_output=args.pack_out is not None)
    base_ppl = eval_ppl(model, params, heldout, args.batch)
    pipe = RSQPipeline(model, rsq)
    qparams, report = pipe.run(params, calib, batch_size=args.batch,
                               verbose=True)
    q_ppl = eval_ppl(model, qparams, heldout, args.batch)
    summary = {
        "arch": args.arch, "n_layers": cfg.n_layers, "device": str(device),
        "rsq": dataclasses.asdict(rsq), "n_calib": args.n_calib,
        "calib_seq": args.calib_seq, "ppl_fp": base_ppl,
        "ppl_quant": q_ppl, "ppl_ratio": q_ppl / base_ppl,
        "layer_seconds": {
            t: {k: rep[k] for k in ("seconds", "capture_s", "solve_s",
                                    "apply_s")}
            for t, rep in report["layers"].items()},
        "n_weights": sum(len(r["weights"]) for r in report["layers"].values()),
    }
    if args.pack_out:
        save_packed_artifact(args.pack_out, pipe.artifact, params=qparams,
                             extra={"arch": args.arch,
                                    "n_layers": cfg.n_layers,
                                    "rsq": dataclasses.asdict(rsq)})
        summary["pack_out"] = args.pack_out
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "report": report}, f, indent=2,
                      default=str)
    return {"params": qparams, "summary": summary, "report": report}


if __name__ == "__main__":
    main()
