#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:
  1. card and build: the card's name and power limit, then every CUDA
     kernel built from ``src/repro_torch/csrc`` (one nvcc per source, all
     started together);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (llama3-8b widths), with times for the kernel, the plain
     version, a one-call PyTorch yardstick (``library_ms``, used nowhere in
     the port) and the least time the card could take (``bound_ms``);
  3. the main path: RSQ quantize of llama3-8b at full width and 2 layers
     (random weights from a seed) -> packed artifact -> keep-packed greedy
     serve in bf16, with every kernel's launches counted over that run;
     the keep-packed serve is compared with a serve of the same artifact
     with weights dequantized at load time, and two of layer 0's GPTQ
     solves (Hessians from the kernels, solver on the card) are compared
     with the same solves done on the host CPU with the plain versions.
The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
reference package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# main path: llama3-8b, depth cut to 2 layers; 8 x 512 calibration tokens
ARCH, N_LAYERS = "llama3-8b", 2
N_CALIB, CALIB_SEQ, CALIB_BATCH = 8, 512, 4
SERVE_BATCH, PROMPT_LEN, N_GEN = 4, 64, 16
BITS, GROUP, SEED = 3, 128, 0
# layer 0's attention-input and FFN-input weights, solved again on the CPU
SOLVE_CHECK = ("mixer/wk", "ffn/wi")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances, relative to the largest reference magnitude
TOL_FP32 = 1e-5  # fp32 products summed in another order
TOL_COLSUM = 1e-4  # exp in two passes, fp32 atomics in run-dependent order
TOL_BF16 = 8e-3  # one bf16 rounding (2^-8) of the fp32 result
# keep-packed (fp32 dequant + sums in the kernel, bf16 out) vs weights
# dequantized to fp32 at load (cuBLAS fp32, bf16 out): every projection's
# bf16 rounding may land one ulp (2^-8) apart, compounding over 2 layers
TOL_SERVE_LOGITS = 2e-2
# GPTQ on the card vs on the CPU: Hessians and Cholesky factors in fp32
# summed in another order.  A code on a rounding boundary may flip, and its
# error feedback moves every later row of that column, so over 4096 rows
# codes drift apart with no fault at all; each check also re-solves on the
# CPU after perturbing H by fp32 summation noise (relative 2^-24 * sqrt of
# the calibration tokens) and reports how many codes that alone keeps.
# Losses do not drift: a broken Hessian or solve moves them, and leaves far
# fewer codes equal than fp32 noise does.
MIN_CODE_MATCH = 0.90
TOL_PROXY = 0.01  # relative: proxy loss, and output error on the CPU's H


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Device time per call, free of host launch overhead: ``iters`` calls
    are captured in one CUDA graph and the graph is replayed between two
    CUDA events.  Calls cycle over input copies whose total size exceeds
    the 50 MB L2 twice over, so each call finds its inputs cold, as the
    main path does (its weights are read once per step)."""

    L2_BYTES = 50e6

    def __init__(self, torch):
        self.torch = torch

    def copies(self, nbytes: int) -> int:
        return max(1, min(64, math.ceil(2 * self.L2_BYTES / max(nbytes, 1))))

    def ms(self, fns, iters: int = 20, reps: int = 3) -> float:
        torch = self.torch
        fns = list(fns)
        iters = max(iters, len(fns))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            for fn in fns:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fns[i % len(fns)]()
        graph.replay()
        best = float("inf")
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / iters)
        del graph
        return best


def errors(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def check_kernels(torch, timer) -> dict:
    """Phase 2: every kernel vs its plain version at the main path's
    shapes.  Returns the representative row of each kernel."""
    from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.attn_colsum.ref import attn_colsum_ref
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.gram.ref import weighted_gram_ref
    from repro_torch.kernels.quant_matmul.ops import pack_weight, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, bad = {}, []

    def record(name, shape, got, want, tol, ms, plain_ms, library_ms, nbytes,
               flops, dtype, representative):
        abs_err, rel_err = errors(got, want)
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = {"name": name, "shape": shape, "max_abs_err": abs_err,
               "rel_err": rel_err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
        log({"check": row})
        if not (rel_err <= tol):
            bad.append(f"{name} {shape}: rel err {rel_err:.3g} > {tol}")
        if representative:
            rows[name] = row

    def clones(tensors, nbytes):
        """Independent copies of ``tensors`` so timed calls run cold."""
        n = timer.copies(nbytes)
        return [tensors] + [tuple(t.clone() for t in tensors)
                            for _ in range(n - 1)]

    # gram: one calibration batch (B*T tokens) of the 4096- and 14336-wide
    # weight inputs, fp32, accumulated into the weight's Hessian
    n = CALIB_BATCH * CALIB_SEQ
    for d in (4096, 14336):
        x = torch.randn((n, d), generator=g, device=dev)
        r = torch.rand((n,), generator=g, device=dev)
        want = weighted_gram_ref(x, r)
        got = weighted_gram(x, r)
        # read x and r once, read and write the (d, d) accumulator
        nbytes = n * d * 4 + n * 4 + 2 * d * d * 4
        sets = clones((x, r, torch.zeros_like(want)), nbytes)
        ms = timer.ms(lambda a=a: weighted_gram(a[0], a[1], out=a[2],
                                                alpha=2.0) for a in sets)
        plain_ms = timer.ms(lambda a=a: weighted_gram_ref(a[0], a[1])
                            for a in sets)
        xrs = [(a[0] * a[1][:, None],) for a in sets]
        library_ms = timer.ms(lambda a=a: torch.mm(a[0].T, a[0]) for a in xrs)
        # the product is symmetric: d(d+1)/2 distinct entries, n
        # multiply-adds each (the kernel computes both triangles)
        record("gram", {"n": n, "d": d}, got, want, TOL_FP32, ms, plain_ms,
               library_ms, nbytes, 1.0 * n * d * (d + 1), "float32",
               d == 14336)
        del x, r, want, got, sets, xrs

    # attn_colsum: the calibration batch's q (32 heads) and k (8 KV heads)
    b, t, h, kv, dh = CALIB_BATCH, CALIB_SEQ, 32, 8, 128
    q = torch.randn((b, t, h, dh), generator=g, device=dev)
    k = torch.randn((b, t, kv, dh), generator=g, device=dev)
    want = attn_colsum_ref(q, k)
    got = attn_colsum(q, k)
    nbytes = (q.numel() + k.numel()) * 4 + b * t * 4
    sets = clones((q, k), nbytes)
    ms = timer.ms(lambda a=a: attn_colsum(*a) for a in sets)
    plain_ms = timer.ms(lambda a=a: attn_colsum_ref(*a) for a in sets)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()

    def materialized(qq, kk):
        kr = kk.repeat_interleave(h // kv, dim=2)
        s = torch.einsum("bthd,bshd->bhts", qq, kr) * dh ** -0.5
        return torch.softmax(s.masked_fill(~causal, -1e30), -1).sum((1, 2))

    library_ms = timer.ms(lambda a=a: materialized(*a) for a in sets)
    flops = 2.0 * b * h * (t * (t + 1) / 2) * dh  # one causal q kᵀ
    record("attn_colsum", {"B": b, "T": t, "H": h, "KV": kv, "Dh": dh}, got,
           want, TOL_COLSUM, ms, plain_ms, library_ms, nbytes, flops,
           "float32", True)
    del q, k, want, got, sets

    # quant_matmul: every llama3-8b block projection, decode (m = serve
    # batch) and prefill (m = batch * prompt), 3- and 4-bit, group 128, bf16
    shapes = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
              "wi/wu": (4096, 14336), "wd": (14336, 4096)}
    for bits in (3, 4):
        spec = QuantSpec(bits=bits, group_size=GROUP)
        for wname, (kk, nn) in shapes.items():
            w = torch.randn((kk, nn), generator=g, device=dev) * kk ** -0.5
            _, qc, sc, zr = quantize_weight_rtn(w, spec)
            pw = pack_weight(qc, sc, zr, spec)
            w_bf16 = ((qc.float().reshape(-1, GROUP, nn) - zr[:, None])
                      * sc[:, None]).reshape(kk, nn).to(torch.bfloat16)
            del w, qc
            for m in (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN):
                x = torch.randn((m, kk), generator=g, device=dev).to(
                    torch.bfloat16)
                want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale,
                                        pw.zero, bits=bits, group_size=GROUP)
                got = quant_matmul(x, pw)
                nbytes = m * kk * 2 + pw.nbytes + m * nn * 2
                sets = clones((x, pw.w_packed, pw.scale, pw.zero), nbytes)
                pws = [(a[0], dataclasses.replace(pw, w_packed=a[1],
                                                  scale=a[2], zero=a[3]))
                       for a in sets]
                ms = timer.ms(lambda a=a: quant_matmul(*a) for a in pws)
                plain_ms = timer.ms(lambda a=a: quant_matmul_ref(
                    a[0], a[1], a[2], a[3], bits=bits, group_size=GROUP)
                    for a in sets)
                libs = clones((x, w_bf16), m * kk * 2 + kk * nn * 2 + m * nn * 2)
                library_ms = timer.ms(lambda a=a: a[0] @ a[1] for a in libs)
                record("quant_matmul",
                       {"weight": wname, "m": m, "k": kk, "n": nn,
                        "bits": bits}, got, want, TOL_BF16, ms, plain_ms,
                       library_ms, nbytes, 2.0 * m * nn * kk, "bfloat16",
                       bits == BITS and wname == "wd" and m == SERVE_BATCH)
                del sets, pws, libs
            del pw, w_bf16
    torch.cuda.empty_cache()
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    return rows


def check_solves(torch, entries: dict, proxy_card: dict) -> dict:
    """The main path's layer-0 GPTQ solves against the same solves on the
    host CPU.  The card's came from Hessians built by the ``attn_colsum``
    and ``gram`` kernels and from GPTQ with ``torch.linalg`` on the card;
    the CPU rebuilds layer 0's rotated weights and calibration inputs from
    the same seed and solves with the plain versions.  Each weight must
    keep MIN_CODE_MATCH of its codes, its proxy loss and its
    Hessian-weighted output error tr(ΔᵀHΔ) within TOL_PROXY of the CPU's,
    and that output error must be smaller than round-to-nearest's."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.gptq import gptq_quantize
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig
    from repro_torch.core.quantizer import (dequantize_packed,
                                            quantize_weight_rtn,
                                            unpack_codes, words_from_numpy)
    from repro_torch.core.rotation import rotate_model
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.launch.quantize import model_config
    from repro_torch.models.lm import Model, capture_block

    t0 = time.perf_counter()
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED)
    cfg = model_config(ARCH, N_LAYERS, "float32")
    dev = torch.device("cuda")
    model = Model(cfg, dev)  # the quantize CLI's draws, in its order
    params = model.init(generator(SEED, dev))
    params, _ = rotate_model(params, cfg, gen=generator(rsq.seed, dev))
    calib = calibration_set(cfg.vocab_size, N_CALIB, CALIB_SEQ, seed=SEED)
    acts = [model.embed(params, calib[i:i + CALIB_BATCH].to(dev)).cpu()
            for i in range(0, N_CALIB, CALIB_BATCH)]
    blk = {k: ({kk: vv.cpu() for kk, vv in v.items()}
               if isinstance(v, dict) else v.cpu())
           for k, v in params["layers"][0].items()}
    del params
    torch.cuda.empty_cache()

    hs: dict = {}
    for x_b in acts:  # CPU tensors: every wrapper takes its plain version
        _, caps, _, colsum = capture_block(blk, cfg, x_b)
        r = attn_con(ImportanceInputs(z_in=x_b, attn_colsum=colsum),
                     r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
        for path in SOLVE_CHECK:
            x_c = caps[path]
            hs[path] = hess.accumulate(hs.get(path),
                                       x_c.reshape(-1, x_c.shape[-1]), r)
    rows, bad = {}, []
    for path in SOLVE_CHECK:
        sub, name = path.split("/")
        w, h = blk[sub][name], hs[path]
        d_in = w.shape[0]
        block = min(rsq.gptq_block, d_in)
        host = gptq_quantize(w, h, rsq.spec(), damp=rsq.damp, block=block)
        noise = torch.randn(h.shape, generator=torch.Generator()
                            .manual_seed(SEED))
        rel = 2.0 ** -24 * math.sqrt(N_CALIB * CALIB_SEQ)
        noisy = gptq_quantize(w, h * (1 + rel * 0.5 * (noise + noise.T)),
                              rsq.spec(), damp=rsq.damp, block=block)
        del noise
        e = entries[f"layer0/{path}"]
        words = words_from_numpy(e["codes"])
        match = float((unpack_codes(words, BITS, d_in) == host["q"])
                      .float().mean())
        floor = float((noisy["q"] == host["q"]).float().mean())
        w_card = dequantize_packed(words, torch.from_numpy(e["scale"]),
                                   torch.from_numpy(e["zero"]), bits=BITS,
                                   d_in=d_in)
        w_rtn = quantize_weight_rtn(w, rsq.spec())[0]
        h_dev, w_dev = h.to(dev), w.to(dev)

        def out_err(wq) -> float:  # tr(ΔᵀHΔ), on the card for speed
            delta = w_dev - wq.to(dev)
            return float((delta * (h_dev @ delta)).sum())

        p_card, p_host = proxy_card[path], float(host["err"])
        row = {"code_match": match, "code_match_fp32_noise": floor,
               "proxy_card": p_card, "proxy_cpu": p_host,
               "proxy_rel_diff": abs(p_card - p_host) / p_host,
               "out_err_card": out_err(w_card), "out_err_cpu":
               out_err(host["w_deq"]), "out_err_rtn": out_err(w_rtn)}
        row["out_err_rel_diff"] = (abs(row["out_err_card"]
                                       - row["out_err_cpu"])
                                   / row["out_err_cpu"])
        rows[path] = row
        if not match >= MIN_CODE_MATCH:
            bad.append(f"{path}: {match:.4f} of codes equal "
                       f"< {MIN_CODE_MATCH}")
        if not row["proxy_rel_diff"] <= TOL_PROXY:
            bad.append(f"{path}: proxy loss {p_card} (card) vs {p_host} "
                       f"(cpu) > {TOL_PROXY} relative")
        if not row["out_err_rel_diff"] <= TOL_PROXY:
            bad.append(f"{path}: output error {row['out_err_card']} (card "
                       f"codes) vs {row['out_err_cpu']} (cpu) > {TOL_PROXY} "
                       f"relative")
        if not row["out_err_card"] < row["out_err_rtn"]:
            bad.append(f"{path}: GPTQ output error {row['out_err_card']} "
                       f"not below RTN's {row['out_err_rtn']}")
        del h_dev, w_dev
    torch.cuda.empty_cache()
    log({"solve_check": {"layer": 0, "weights": rows,
                         "seconds": time.perf_counter() - t0,
                         "min_code_match": MIN_CODE_MATCH,
                         "tol_proxy": TOL_PROXY}})
    if bad:
        fail("GPTQ on the card disagrees with the CPU: " + "; ".join(bad))
    return rows


def main_path(torch) -> tuple[dict, dict]:
    """Phase 3: quantize -> artifact -> keep-packed serve, launches counted."""
    from repro_torch.checkpoint.packed import load_packed_artifact
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch import quantize, serve

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul}
    art = ROOT / "build" / "chip_smoke_artifact"
    shutil.rmtree(art, ignore_errors=True)
    common = ["--arch", ARCH, "--n-layers", str(N_LAYERS), "--device", "cuda"]
    serve_args = common + ["--packed", str(art), "--dtype", "bfloat16",
                           "--batch", str(SERVE_BATCH), "--prompt-len",
                           str(PROMPT_LEN), "--gen", str(N_GEN)]
    try:
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        q = quantize.main(common + [
            "--bits", str(BITS), "--group-size", str(GROUP),
            "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
            "--batch", str(CALIB_BATCH), "--dtype", "float32",
            "--seed", str(SEED), "--pack-out", str(art)])
        quantize_s = time.perf_counter() - t0
        summary = q["summary"]
        proxy0 = q["report"]["layers"]["layer0"]["weights"]
        del q
        entries = {name: e for name, e in load_packed_artifact(art)[0].items()
                   if name.removeprefix("layer0/") in SOLVE_CHECK}
        torch.cuda.empty_cache()
        packed = serve.main(serve_args)
        launches = {name: fn.launches for name, fn in counted.items()}
        dequant = serve.main(serve_args + ["--no-keep-packed"])
        traced = serve.main(serve_args + ["--profile"])["profile"]
    finally:
        shutil.rmtree(art, ignore_errors=True)

    log({"main_path": {
        "arch": ARCH, "widths": {"d_model": 4096, "d_ff": 14336,
                                 "vocab": 128256},
        "reduced": {"n_layers": f"{N_LAYERS} of 32"},
        "n_calib": N_CALIB, "calib_seq": CALIB_SEQ,
        "calib_tokens": N_CALIB * CALIB_SEQ, "quantize_s": quantize_s,
        "layer_seconds": summary["layer_seconds"],
        "ppl_fp": summary["ppl_fp"], "ppl_quant": summary["ppl_quant"],
        "ppl_ratio": summary["ppl_ratio"],
        "prefill_tok_s": packed["prefill_tok_s"],
        "decode_tok_s": packed["decode_tok_s"],
        "dequantized_prefill_tok_s": dequant["prefill_tok_s"],
        "dequantized_decode_tok_s": dequant["decode_tok_s"],
        "resident_packed_bytes": packed["resident_packed_bytes"],
        "resident_fp_bytes": packed["resident_fp_bytes"],
        "launches": launches}})
    log({"decode_profile": traced})

    tokens = torch.tensor(packed["tokens"])
    same = float((tokens == torch.tensor(dequant["tokens"])).float().mean())
    abs_err, rel_err = errors(packed["first_logits"], dequant["first_logits"])
    log({"serve_agreement": {"token_match": same,
                             "first_logits_max_abs_diff": abs_err,
                             "first_logits_rel_diff": rel_err,
                             "tol": TOL_SERVE_LOGITS}})
    if tokens.shape != (SERVE_BATCH, N_GEN) or not bool(
            ((tokens >= 0) & (tokens < 128256)).all()):
        fail(f"bad generated tokens {tuple(tokens.shape)}")
    if not bool(torch.isfinite(packed["first_logits"]).all()):
        fail("non-finite logits from the keep-packed serve")
    if not (rel_err <= TOL_SERVE_LOGITS):
        fail(f"keep-packed vs dequantized first-step logits differ by "
             f"{rel_err:.3g} > {TOL_SERVE_LOGITS}")
    ratio = summary["ppl_ratio"]
    if not (math.isfinite(ratio) and ratio < 1.5):
        fail(f"quantized/fp perplexity ratio {ratio} (expected finite, < 1.5)")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        fail(f"main path never launched: {missing}")
    check_solves(torch, entries, proxy0)
    return launches, summary


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
             f"checkout of the repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels import build

    built = build.build_all()
    log({"build": built})
    for name in build.SOURCES:  # nvcc -Xptxas -v of this run's builds
        report = build.ptxas_report(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             report)]
        if regs:
            log({"ptxas": {"source": name, "kernels": len(regs),
                           "max_registers": max(regs),
                           "max_spill_store_bytes": max(spills or [0])}})

    rows = check_kernels(torch, Timer(torch))
    launches, _ = main_path(torch)

    sources = {"gram": "src/repro_torch/csrc/gram.cu",
               "attn_colsum": "src/repro_torch/csrc/attn_colsum.cu",
               "quant_matmul": "src/repro_torch/csrc/quant_matmul.cu"}
    replaces = {"gram": "src/repro/kernels/gram/kernel.py:33",
                "attn_colsum": "src/repro/kernels/attn_colsum/kernel.py:74",
                "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:66"}
    kernels = []
    for name in ("gram", "attn_colsum", "quant_matmul"):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
