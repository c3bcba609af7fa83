"""Greedy serving entry point of the PyTorch port: prefill + a plain Python
decode loop over an fp KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --n-layers 2 --packed /tmp/rsq_art --dtype bfloat16

``--packed DIR`` serves a packed RSQ artifact (from launch.quantize
--pack-out).  The default keeps the codes packed on the device
(``--keep-packed``): every block projection runs through the
``quant_matmul`` kernel.  ``--no-keep-packed`` dequantizes the weights once
at load time instead, for comparison.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint.packed import (load_packed_forward_params,
                                           load_packed_params,
                                           resident_weight_bytes)
from repro_torch.data.calibration import SyntheticCorpus
from repro_torch.device import generator, resolve_device
from repro_torch.launch.quantize import model_config
from repro_torch.models.lm import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(model: Model, params: dict, prompts: torch.Tensor, n_gen: int,
             *, stats: dict | None = None) -> torch.Tensor:
    """prompts: (B, T) -> (B, n_gen) greedy tokens.  Token 0 comes from the
    prefill logits, then n_gen - 1 decode steps.  ``stats`` (optional)
    receives ``prefill_s``, ``decode_s`` and the prefill ``first_logits``."""
    b, t = prompts.shape
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache_len=t + n_gen)
    tok = logits.argmax(-1, keepdim=True)
    if stats is not None:
        _sync(model.device)
        stats["prefill_s"] = time.perf_counter() - t0
        stats["first_logits"] = logits
    t1 = time.perf_counter()
    toks = [tok]
    for i in range(n_gen - 1):
        logits = model.decode_step(params, cache, tok, t + i)
        tok = logits.argmax(-1, keepdim=True)
        toks.append(tok)
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(model.device)
        stats["decode_s"] = time.perf_counter() - t1
    return out


@torch.no_grad()
def profile_generate(model: Model, params: dict, prompts: torch.Tensor,
                     n_gen: int, top: int = 12) -> dict:
    """One traced ``generate`` under ``torch.profiler``: device time by
    kernel name and the summed device-busy time (the profiler slows the
    host, so the traced wall time is not the run's; compare the busy time
    with an untraced run of the same work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(model.device)
    with profile(activities=activities) as prof:
        generate(model, params, prompts, n_gen)
        _sync(model.device)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only, not the ops
            continue  # that launched them (those carry the same time)
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "ms": dev_us / 1e3,
                         "calls": ev.count})
    rows.sort(key=lambda r: -r["ms"])
    return {"device_busy_ms": sum(r["ms"] for r in rows), "top": rows[:top]}


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b-smoke")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                    "architecture's own); must match the artifact")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--packed", default=None, metavar="DIR",
                    help="serve from a packed RSQ artifact")
    ap.add_argument("--keep-packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --packed: keep codes packed on the device and "
                    "run every block projection through quant_matmul "
                    "(default); --no-keep-packed dequantizes at load time")
    ap.add_argument("--no-verify", action="store_true",
                    help="with --packed: skip the SHA-256 integrity check")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed run, trace one more generate with "
                    "torch.profiler and report device time by kernel and "
                    "the device's idle share")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.n_layers, args.dtype)
    model = Model(cfg, device)
    result: dict = {"arch": args.arch, "n_layers": cfg.n_layers,
                    "device": str(device)}
    if args.packed:
        loader = (load_packed_forward_params if args.keep_packed
                  else load_packed_params)
        params, meta = loader(args.packed, device=device, dtype=model.dtype,
                              verify=not args.no_verify)
        extra = meta.get("extra", {})
        if extra.get("arch") not in (None, args.arch) or \
                extra.get("n_layers") not in (None, cfg.n_layers):
            raise ValueError(
                f"artifact was quantized for --arch {extra.get('arch')} "
                f"--n-layers {extra.get('n_layers')}, serving {args.arch} "
                f"with {cfg.n_layers} layers")
        packed_b, fp_b = resident_weight_bytes(params)
        mode = "keep-packed" if args.keep_packed else "dequantized"
        print(f"packed artifact: {len(meta['entries'])} weights ({mode}, "
              f"bits={meta['spec']['bits']}); resident bytes: "
              f"{packed_b} packed + {fp_b} fp")
        result.update(mode=mode, resident_packed_bytes=packed_b,
                      resident_fp_bytes=fp_b)
    else:
        params = model.init(generator(args.seed, device))
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=args.seed)
    prompts = corpus.sample(generator(args.seed + 1), args.batch,
                            args.prompt_len).to(device)
    generate(model, params, prompts, min(args.gen, 2))  # warm-up, untimed
    stats: dict = {}
    out = generate(model, params, prompts, args.gen, stats=stats)
    result.update(
        tokens=out.cpu().tolist(), first_logits=stats["first_logits"],
        prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
        prefill_tok_s=args.batch * args.prompt_len / stats["prefill_s"],
        decode_tok_s=(args.batch * (args.gen - 1) / stats["decode_s"]
                      if args.gen > 1 else 0.0))
    if args.profile:
        prof = profile_generate(model, params, prompts, args.gen)
        wall_ms = (stats["prefill_s"] + stats["decode_s"]) * 1e3
        prof["untraced_wall_ms"] = wall_ms
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / wall_ms
        result["profile"] = prof
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("tokens", "first_logits")}))
    print("sample:", result["tokens"][0][:16])
    return result


if __name__ == "__main__":
    main()
