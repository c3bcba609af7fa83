"""RSQ quantization entry point of the PyTorch port.

Builds the model (random weights from ``torch.Generator(seed)``), draws the
calibration set, runs Rotate-Scale-Quantize, reports perplexity against
the fp model and optionally writes the packed serving artifact.

  PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama3-8b \\
      --n-layers 2 --n-calib 8 --calib-seq 512 --pack-out /tmp/rsq_art

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--n-layers`` cuts the
depth of the chosen architecture and keeps its widths: ``--arch
deepseek-v2-236b --n-layers 2`` quantizes its dense MLA layer 0 and its
first routed-expert layer (160 experts, top-6, 2 shared; ``--dtype
bfloat16`` keeps its weights at 10.7 GB); ``--arch deepseek-v3-671b
--n-layers 2`` two of its three dense MLA layers.  ``--arch qwen1.5-4b``
(qkv bias), ``command-r-35b`` (tied embeddings: the rotation unties the
head; ``--no-rotate`` keeps none), ``minitron-4b`` and ``mamba2-780m``
(Mamba-2 blocks, whose AttnCon falls back to ActNorm) take the same
flags; ``--arch jamba-v0.1-52b --n-layers 8 --dtype bfloat16`` quantizes
its first layer group (Mamba and GQA blocks, dense and 16-expert FFNs;
26.5 GB of weights), and a depth that is not a whole number of layer
groups (``scan_period`` blocks) is refused.  ``--arch whisper-medium``
(enc-dec) and ``llama-3.2-vision-11b`` (cross-attention layers) are
refused too: they calibrate on frames or media, which this CLI does not
draw (nor does the reference's); ``RSQPipeline.run(..., media=, frames=)``
and ``checkpoint.packed.save_packed_artifact`` quantize them from Python.
The CLI keeps one copy of
the weights: it hands the layers to the pipeline (``handover``) after the
fp perplexity, and each block is freed once rotated.  ``--importance``
picks any of the paper's eight token-importance strategies and
``--expansion M`` adds M - 1 circular shifts of every calibration sample.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.packed import save_packed_artifact
from repro_torch.configs import get_config
from repro_torch.core.pipeline import RSQConfig, RSQPipeline, handover
from repro_torch.core.resume import QuantizeRunner
from repro_torch.data.calibration import calibration_set, heldout_set
from repro_torch.device import generator, resolve_device
from repro_torch.models.lm import Model
from repro_torch.runtime.fault import FaultPlan, RetryPolicy


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


def refuse_media(cfg, entry: str) -> None:
    """The CLIs' refusal of a model that takes frames or media."""
    if cfg.family in ("encdec", "vlm"):
        what = "frames" if cfg.family == "encdec" else "media"
        raise ValueError(
            f"{cfg.name} ({cfg.family}) takes {what}=, which the CLIs do "
            f"not draw (nor do the reference's); run it from Python: "
            f"{entry}")


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
                    "architecture's own); widths are kept, and each kept "
                    "layer is of the architecture's own kind (deepseek's "
                    "dense prefix, then its routed-expert layers); a whole "
                    "number of layer groups (jamba: 8 blocks a group)")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--importance", default="attn_con",
                    help="token-importance strategy: uniform, first_n, "
                    "first_last_n, token_freq, act_norm, act_diff, "
                    "token_sim or attn_con")
    ap.add_argument("--r-min", type=float, default=0.01)
    ap.add_argument("--no-rotate", action="store_true")
    ap.add_argument("--expansion", type=int, default=1,
                    help="dataset expansion factor M: each calibration "
                    "sample and its M - 1 circular shifts")
    ap.add_argument("--n-calib", type=int, default=32)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--pack-out", default=None, metavar="DIR",
                    help="write the packed serving artifact here; serve it "
                    "with repro_torch.launch.serve --packed DIR (GPTQ only)")
    ap.add_argument("--method", default="gptq", choices=["gptq", "ldlq"],
                    help="the solver: GPTQ, or LDLQ with the E8 rounder")
    ap.add_argument("--scheduler", default="auto",
                    choices=["auto", "sequential", "overlapped"],
                    help="layer schedule (auto: sequential on the CPU, "
                    "overlapped on CUDA)")
    ap.add_argument("--save-every-layers", type=int, default=0, metavar="N",
                    help="checkpoint the quantization's progress every N "
                    "layer solves into --progress-dir (0: none); a killed "
                    "run goes on with --resume")
    ap.add_argument("--progress-dir", default=None, metavar="DIR",
                    help="progress checkpoints (default <pack-out>.progress, "
                    "or ./quantize_progress without --pack-out)")
    ap.add_argument("--resume", action="store_true",
                    help="go on from the latest checkpoint in --progress-dir "
                    "(without it an existing one is refused)")
    ap.add_argument("--fail-at", action="append", default=[],
                    metavar="LAYER:STAGE[:COUNT]",
                    help="inject a failure at a stage point (stage: "
                    "capture|solve|apply|pack); repeatable")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="in-process retries after a recoverable failure")
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="the serving KV cache recorded in the artifact's "
                    "meta: 0 (activation dtype), 8 (int8) or 2 (log codes); "
                    "weight quantization is unaffected")
    ap.add_argument("--out", default=None, help="write report JSON here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.n_layers, args.dtype)
    if args.kv_bits is not None:
        if args.kv_bits not in (0, 2, 8):
            ap.error(f"--kv-bits {args.kv_bits} is not supported — use 0 "
                     f"(KV cache in the activation dtype), 8 (int8 + "
                     f"per-token scales) or 2 (packed log codes + "
                     f"per-chunk scales)")
        cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits)
    refuse_media(cfg, "core.pipeline.RSQPipeline(model, rsq).run(params, "
                 "calib, media=, frames=), then checkpoint.packed."
                 "save_packed_artifact")
    model = Model(cfg, device)
    params = model.init(generator(args.seed, device))
    calib = calibration_set(cfg.vocab_size, args.n_calib, args.calib_seq,
                            seed=args.seed)
    heldout = heldout_set(cfg.vocab_size, args.n_calib, args.calib_seq,
                          seed=args.seed)
    rsq = RSQConfig(bits=args.bits, group_size=args.group_size,
                    rotate=not args.no_rotate, importance=args.importance,
                    r_min=args.r_min, expansion=args.expansion,
                    seed=args.seed, method=args.method,
                    scheduler=(None if args.scheduler == "auto"
                               else args.scheduler),
                    pack_output=args.pack_out is not None)
    pipe = RSQPipeline(model, rsq)  # refuses ldlq with --pack-out
    runner = None
    if (args.resume or args.save_every_layers > 0
            or args.progress_dir is not None or args.fail_at):
        progress = args.progress_dir or (
            args.pack_out + ".progress" if args.pack_out
            else "quantize_progress")
        ckpt = CheckpointManager(progress)
        if ckpt.latest_step() is not None and not args.resume:
            ap.error(f"progress dir {progress!r} holds checkpoints from a "
                     f"previous run; pass --resume to continue it, or "
                     f"remove the directory to start over")
        runner = QuantizeRunner(
            pipe, ckpt, save_every_layers=max(args.save_every_layers, 1),
            policy=RetryPolicy(max_restarts=args.max_restarts),
            resume=args.resume, verbose=True)
    base_ppl = eval_ppl(model, params, heldout, args.batch)
    if runner is None:
        params["layers"] = handover(params["layers"])
        qparams, report = pipe.run(params, calib, batch_size=args.batch,
                                   verbose=True)
    else:
        fault = FaultPlan.parse(args.fail_at) if args.fail_at else None
        qparams, report = runner.run(params, calib, fault=fault,
                                     batch_size=args.batch, verbose=True)
    del params
    q_ppl = eval_ppl(model, qparams, heldout, args.batch)
    summary = {
        "arch": args.arch, "n_layers": cfg.n_layers, "device": str(device),
        "rsq": dataclasses.asdict(rsq), "n_calib": args.n_calib,
        "calib_seq": args.calib_seq, "ppl_fp": base_ppl,
        "ppl_quant": q_ppl, "ppl_ratio": q_ppl / base_ppl,
        "scheduler": report["scheduler"],
        "layer_seconds": {
            t: {k: rep[k] for k in ("seconds", "capture_s", "solve_s",
                                    "apply_s") if k in rep}
            for t, rep in report["layers"].items()},
        "n_weights": sum(len(r["weights"]) for r in report["layers"].values()),
    }
    if runner is not None:
        summary["fault_tolerance"] = {
            "restarts": runner.restarts,
            "ckpt_overhead_s": round(runner.ckpt_overhead_s, 4),
            "events": [e["kind"] for e in runner.events]}
    if args.pack_out:
        save_packed_artifact(args.pack_out, pipe.artifact, params=qparams,
                             extra={"arch": args.arch,
                                    "n_layers": cfg.n_layers,
                                    "rsq": dataclasses.asdict(rsq),
                                    "kv_bits": cfg.kv_bits})
        summary["pack_out"] = args.pack_out
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "report": report}, f, indent=2,
                      default=str)
    return {"params": qparams, "summary": summary, "report": report}


if __name__ == "__main__":
    main()
