"""Serving entry point of the PyTorch port: prefill + a decode loop
(``--mode batch``), or the continuous-batching engine over paged
quantized KV pools (``--mode engine``).

``--loop graph`` (the default, the counterpart of the reference's ``--loop
scan``) captures the decode steps of a generation, or of an engine burst,
once as a CUDA graph and replays it; ``--loop python`` launches every
step from Python (the debug loop; the same tokens bit for bit).  Decode
tokens/s exclude the capture, which the JSON line reports apart
(``captures``, ``capture_s``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --n-layers 2 --packed /tmp/rsq_art --dtype bfloat16 --kv-bits 8

``--arch deepseek-v3-671b --n-layers 2`` serves MLA layers (absorbed
latent attention on a latent cache) the same way, and ``--arch
deepseek-v2-236b --n-layers 2`` its dense layer 0 and a routed-expert
layer (every expert stack one ``quant_matmul`` launch for all 160
experts).  ``--arch qwen1.5-4b`` (qkv bias) and ``command-r-35b`` (tied
embeddings) serve as llama3-8b does; ``--arch mamba2-780m`` serves its
Mamba-2 blocks in batch mode only, the recurrent state in the flat cache
(``--mode engine`` refuses it, as the reference's engine does), and
``--arch jamba-v0.1-52b --n-layers 8`` its first layer group (7 Mamba-2
blocks and one GQA block, dense and 16-expert FFNs) the same way: the
cache holds each Mamba block's state beside the GQA block's K/V (fp or
``--kv-bits`` codes), and ``--mode engine`` refuses it too.  An
encoder-decoder (whisper-medium) and a model with cross-attention layers
(llama-3.2-vision-11b) take frames or media that this CLI does not draw
(nor does the reference's): it refuses them and names the library entry
point, ``generate(..., media=, frames=)``, which serves both.

``--packed DIR`` serves a packed RSQ artifact (from launch.quantize
--pack-out).  The default keeps the codes packed on the device
(``--keep-packed``): every block projection runs through the
``quant_matmul`` kernel.  ``--no-keep-packed`` dequantizes the weights once
at load time instead, for comparison.  Runs on ``cuda`` unless
``--device cpu`` is given.

``--kv-bits 8|2`` quantizes the KV cache (int8 codes with per-(token, head)
scales, or 2-bit log codes with per-(``kv_chunk``, head) scales): prefill
writes codes, decode appends codes and attends on them through the
``flash_decode`` kernels; the cache is never held in fp.  ``--mode engine``
serves ``--batch`` requests arriving on a Poisson trace (``--arrival-rate``
per scheduling round) through ``serving.Engine``: ``--max-slots`` decode
slots over ``--n-pages`` shared pages (page = ``kv_chunk`` tokens), bursts
of ``--burst-steps`` decode steps, and ``--prefill-chunk N`` to admit
prompts in page-aligned chunks between bursts, with the tokens of
whole-prompt admission (the lossy ``prefill_attn="paged"`` mode is the
``Engine``'s, from Python).  The engine needs ``--kv-bits 8`` or ``2``.
``--temperature`` samples every token, the first included, from the (seed,
token index) stream of ``serving.sampling``; request ``i`` uses seed
``--seed + i``.  The engine's overload policy: ``--deadline-s`` ends a
request that has not finished that many seconds after its submit,
``--queue-depth`` bounds the queue (a refused submit is counted as shed),
and ``--fail-at-round ROUND:STAGE[:COUNT]`` injects failures at a round's
admit, ingest, burst or retire stage.  The run fails unless every
submitted request ends with a status and every page comes back.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
import weakref

import torch

from repro_torch.checkpoint.packed import (load_packed_forward_params,
                                           load_packed_params,
                                           resident_weight_bytes)
from repro_torch.data.calibration import SyntheticCorpus
from repro_torch.device import generator, resolve_device
from repro_torch.launch.quantize import model_config, refuse_media
from repro_torch.models.lm import Model
from repro_torch.runtime.fault import FaultPlan
from repro_torch.runtime.graphs import LOOPS, Replay
from repro_torch.serving import (Engine, SamplingParams, ServeRequest,
                                 poisson_trace, run_trace)
from repro_torch.serving.sampling import sample_tokens


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_graph(model: Model, params: dict, b: int, t: int, n_gen: int,
                 sampled: bool, media_len: int = 0) -> tuple[Replay, dict]:
    """The counterpart of the reference's ``_scan_decode_fn``: the n_gen - 1
    decode steps of a (b, t) prompt batch as one region, sampling inside it
    with the token index on the device, captured as one CUDA graph on the
    card.  Kept on ``model.graphs`` by (params, b, t, n_gen, sampled),
    with media_len after them where there is media, as the reference's
    ``lru_cache`` keeps its programs by (model, n_gen, sampled); the
    temperature and the seeds are buffer values, not keys.  Returns the
    ``Replay`` and its static inputs:
    ``cache`` (the one static storage of the flat cache, which the caller
    loads with the prefill's: cross-attention's K/V of ``media_len``
    media rows too, computed by the prefill outside the graph and read by
    every replayed step), ``tok`` (B, 1) token 0, ``temp`` and ``seeds``
    (B,)."""
    key = (id(params), b, t, n_gen, sampled) + (
        (media_len,) if media_len else ())
    if key not in model.graphs:
        dev = model.device
        static = {"cache": model.init_cache(b, t + n_gen, media_len),
                  "tok": torch.zeros((b, 1), dtype=torch.int64, device=dev),
                  "pos": torch.full((1,), t, dtype=torch.int64, device=dev),
                  "temp": torch.zeros((b,), device=dev),
                  "seeds": torch.zeros((b,), dtype=torch.int64, device=dev)}
        # the region is kept on the model: a proxy, not a cycle through it
        owner = weakref.proxy(model)

        def steps(n: int) -> torch.Tensor:
            tok, pos, toks = static["tok"], static["pos"], []
            for i in range(n):
                logits = owner.decode_step(params, static["cache"], tok, pos)
                index = torch.full((b,), i + 1, dtype=torch.int64,
                                   device=dev)
                tok = sample_tokens(logits, static["temp"], static["seeds"],
                                    index, sampled=sampled)[:, None]
                toks.append(tok)
                pos = pos + 1
            return torch.cat(toks, dim=1)

        model.graphs[key] = (Replay(lambda: steps(n_gen - 1), dev,
                                    warm_up=lambda: steps(1), params=params),
                             static)
    return model.graphs[key]


def graph_stats(replays) -> dict:
    """``captures`` (graphs captured) and ``capture_s`` (seconds spent on
    their warm-ups and captures) of some ``Replay``s."""
    replays = list(replays)
    return {"captures": sum(r.captured for r in replays),
            "capture_s": sum(r.capture_s for r in replays)}


@torch.no_grad()
def generate(model: Model, params: dict, prompts: torch.Tensor, n_gen: int,
             *, media: torch.Tensor | None = None,
             frames: torch.Tensor | None = None, temperature: float = 0.0,
             seed: int = 0, stats: dict | None = None,
             loop: str = "graph") -> torch.Tensor:
    """prompts: (B, T) -> (B, n_gen) tokens.  Token 0 comes from the
    prefill logits, then n_gen - 1 decode steps, through the quantized
    cache when the model's ``kv_bits`` is set.  ``media`` (B, Tm, D) feeds
    a vision model's cross-attention layers, ``frames`` (B, Tf, D) an
    encoder-decoder's encoder; the prefill computes their cross-attention
    K/V once, which stay fp in the cache.  Greedy at temperature 0;
    otherwise row ``i`` draws token ``j`` from the (seed + i, j) stream,
    the engine's for a request with that seed.

    ``loop="graph"`` (default) runs the decode steps as one captured
    region (:func:`decode_graph`): a CUDA graph replay on the card, the
    same region called on the CPU.  ``"python"`` is the debug loop, a
    ``decode_step`` a token from Python with the position as an int; the
    tokens are the same bit for bit.  ``stats`` (optional) receives
    ``prefill_s``, ``decode_s`` (without the capture), ``capture_s`` (0.0
    when the graph was already captured) and the prefill
    ``first_logits``."""
    if loop not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
    b, t = prompts.shape
    dev = model.device
    temp = torch.full((b,), float(temperature), device=dev)
    seeds = seed + torch.arange(b, device=dev)
    sampled = temperature > 0

    def draw(logits, j: int) -> torch.Tensor:
        index = torch.full((b,), j, dtype=torch.int64, device=dev)
        return sample_tokens(logits, temp, seeds, index,
                             sampled=sampled)[:, None]

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, media=media,
                                  frames=frames, cache_len=t + n_gen)
    extra = media if media is not None else frames
    tok = draw(logits, 0)
    if stats is not None:
        _sync(dev)
        stats["prefill_s"] = time.perf_counter() - t0
        stats["first_logits"] = logits
    capture_s = 0.0
    if loop == "graph" and n_gen > 1:
        replay, static = decode_graph(
            model, params, b, t, n_gen, sampled,
            0 if extra is None else extra.shape[1])
        # captured first: the warm-up step advances the static cache in
        # place (a Mamba block's state too), so the prefill's goes in after
        capture_s = replay.ready()
        for dst, src in zip(static["cache"], cache):
            for key, a in src.items():
                dst[key].copy_(a)
        static["tok"].copy_(tok)
        static["temp"].copy_(temp)
        static["seeds"].copy_(seeds)
        t1 = time.perf_counter()
        out = torch.cat([tok, replay.run()], dim=1)
    else:
        t1 = time.perf_counter()
        toks = [tok]
        for i in range(n_gen - 1):
            logits = model.decode_step(params, cache, tok, t + i)
            tok = draw(logits, i + 1)
            toks.append(tok)
        out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
        stats["capture_s"] = capture_s
    return out


def kv_cache_bytes(model: Model, batch: int, cache_len: int,
                   media_len: int = 0) -> tuple[int, int]:
    """Bytes of a flat cache of ``batch`` x ``cache_len`` tokens as
    ``model.init_cache`` lays it out (codes and scales for a quantized
    cache), and of the same cache held in the activation dtype; from the
    codec's layout alone, no tensor allocated.  GQA holds K and V of each
    KV head (Dh values each) per token and layer; MLA the latent
    (kv_lora_rank values) and the rope key (qk_rope_dim values).  A Mamba
    layer's entry is its recurrent state, of no token axis and never
    quantized: the conv window (W - 1 rows of d_inner + 2·state) in the
    activation dtype and the fp32 SSM state (nh x hd x state), the same
    bytes either way.  Counted layer by layer, by kind: a hybrid holds
    both.  A cross-attention layer (an enc-dec decoder block's sub-layer
    too) holds K and V of every KV head for ``media_len`` media rows, in
    the activation dtype whatever the codec."""
    cfg, codec = model.cfg, model.codec
    kinds = cfg.layer_kinds()
    n_mamba = kinds.count("mamba")
    n_attn = len(kinds) - n_mamba - kinds.count("cross")
    n_cross = len(kinds) if model.encdec else kinds.count("cross")
    state = n_mamba * batch * (
        (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_d_state)
        * model.dtype.itemsize
        + cfg.ssm_n_heads * cfg.ssm_head_dim * cfg.ssm_d_state * 4)
    state += 2 * n_cross * batch * media_len * cfg.n_kv_heads \
        * cfg.head_dim * model.dtype.itemsize
    if cfg.attn_kind == "mla":  # one row each of c and r, no head axis
        rows, widths = n_attn * batch, (cfg.kv_lora_rank, cfg.qk_rope_dim)
    else:  # K and V of every KV head
        rows, widths = 2 * n_attn * batch * cfg.n_kv_heads, (cfg.head_dim,)
    fp = rows * cache_len * sum(widths) * model.dtype.itemsize
    if not codec.quantized:
        return state + fp, state + fp
    s = model._cache_len(cache_len)
    per_row = sum(s * codec.code_cols(w) * codec.code_dtype.itemsize
                  + codec.scale_rows(s) * codec.scale_dtype.itemsize
                  for w in widths)
    return state + rows * per_row, state + fp


def serve_engine(model: Model, params: dict, prompts: torch.Tensor,
                 n_gen: int, *, temperature: float = 0.0, seed: int = 0,
                 max_slots: int = 4, n_pages: int = 64,
                 burst_steps: int = 8, arrival_rate: float = 0.5,
                 prefill_chunk: int | None = None,
                 prefill_attn: str = "exact", deadline_s: float = 0.0,
                 queue_depth: int | None = None,
                 fault_plan: FaultPlan | None = None, loop: str = "graph"
                 ) -> tuple[Engine, dict]:
    """Serve each prompt row as one request of ``n_gen`` tokens through the
    engine on a Poisson trace; returns the engine and ``run_trace``'s
    summary (every page is back on the free list when it returns).
    ``deadline_s``, ``queue_depth`` and ``fault_plan`` are the engine's
    overload settings; ``loop`` its burst loop (the engine captures its
    graphs when it is built, before the trace starts)."""
    reqs = [ServeRequest(tokens=prompts[i].tolist(), max_new_tokens=n_gen,
                         sampling=SamplingParams(temperature=temperature,
                                                 seed=seed + i,
                                                 deadline_s=deadline_s))
            for i in range(prompts.shape[0])]
    need = -(-(prompts.shape[1] + n_gen) // model.codec.page_tokens)
    engine = Engine(model, params, max_slots=max_slots, n_pages=n_pages,
                    max_pages_per_request=need, burst_steps=burst_steps,
                    prefill_chunk=prefill_chunk, prefill_attn=prefill_attn,
                    queue_depth=queue_depth, fault_plan=fault_plan,
                    loop=loop)
    stats = run_trace(engine, poisson_trace(reqs, rate=arrival_rate,
                                            seed=seed))
    return engine, stats


@torch.no_grad()
def profile_generate(model: Model, params: dict, prompts: torch.Tensor,
                     n_gen: int, top: int = 12, loop: str = "graph",
                     **inputs) -> dict:
    """One traced greedy ``generate`` under ``torch.profiler``: device time
    by kernel name and the summed device-busy time (the profiler slows the
    host, so the traced wall time is not the run's; compare the busy time
    with an untraced run of the same work).  The decode graph is captured
    by an untraced call first, so the trace holds replays only.
    ``inputs``: ``media`` or ``frames``, as ``generate`` takes them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    generate(model, params, prompts, n_gen, loop=loop, **inputs)
    _sync(model.device)
    with profile(activities=activities) as prof:
        generate(model, params, prompts, n_gen, loop=loop, **inputs)
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
                    "architecture's own; deepseek's dense prefix, then its "
                    "routed-expert layers); must match the artifact")
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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy); every token, "
                    "the first included, is drawn from the (seed, token "
                    "index) stream; request i uses seed --seed + i")
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="KV-cache precision: 0 = activation dtype "
                    "(default), 8 = int8 codes + per-token scales, 2 = "
                    "packed log codes + per-chunk scales; decode attends on "
                    "the codes (kernels.flash_decode)")
    ap.add_argument("--mode", choices=("batch", "engine"), default="batch",
                    help="'batch' (default): one fixed-shape generate(); "
                    "'engine': continuous batching on block-paged quantized "
                    "KV pools, requests on a Poisson trace (needs --kv-bits "
                    "8 or 2)")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="engine mode: concurrent decode slots")
    ap.add_argument("--n-pages", type=int, default=64,
                    help="engine mode: allocatable KV pages shared by all "
                    "requests (page = kv_chunk tokens, every layer)")
    ap.add_argument("--burst-steps", type=int, default=8,
                    help="engine mode: decode steps per scheduling round")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="engine mode: Poisson arrivals per scheduling round")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine mode: admit prompts in chunks of this many "
                    "tokens (rounded up to a page multiple) between decode "
                    "bursts; 0 (default) admits whole prompts")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="engine mode: per-request deadline in seconds from "
                    "submit; a request still queued or decoding then ends "
                    "with status deadline_exceeded; 0 (default): none")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="engine mode: bound on queued requests; a submit "
                    "beyond it is refused (EngineSaturated with a "
                    "retry-after hint) and counted as shed; 0 (default): "
                    "unbounded")
    ap.add_argument("--fail-at-round", action="append", default=[],
                    metavar="ROUND:STAGE[:COUNT]",
                    help="engine mode: inject COUNT failures (default 1) at "
                    "a round's stage, one of admit, ingest, burst, retire; "
                    "a failed burst is retried, a request whose admit or "
                    "ingest fails ends failed; repeatable")
    ap.add_argument("--loop", choices=LOOPS, default="graph",
                    help="decode loop: 'graph' (default) captures the "
                    "decode steps of a generation (batch mode) or of a "
                    "burst (engine mode) once as a CUDA graph and replays "
                    "it; 'python' launches every step from Python (debug; "
                    "the same tokens bit for bit)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed run, trace one more generate with "
                    "torch.profiler and report device time by kernel and "
                    "the device's idle share")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.n_layers, args.dtype)
    refuse_media(cfg, "launch.serve.generate(model, params, prompts, n_gen, "
                 "media=, frames=)")
    if args.kv_bits is not None:
        cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits)
    if args.mode == "engine" and not cfg.kv_bits:
        ap.error("--mode engine pages *quantized* KV codes — pass "
                 "--kv-bits 8 or --kv-bits 2")
    model = Model(cfg, device)  # raises on an unsupported --kv-bits
    result: dict = {"arch": args.arch, "n_layers": cfg.n_layers,
                    "device": str(device), "kv_bits": cfg.kv_bits,
                    "loop": args.loop}
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
    if args.mode == "engine":
        engine, st = serve_engine(
            model, params, prompts, args.gen, temperature=args.temperature,
            seed=args.seed, max_slots=args.max_slots, n_pages=args.n_pages,
            burst_steps=args.burst_steps, arrival_rate=args.arrival_rate,
            prefill_chunk=args.prefill_chunk or None,
            deadline_s=args.deadline_s, queue_depth=args.queue_depth or None,
            fault_plan=(FaultPlan.parse(args.fail_at_round)
                        if args.fail_at_round else None), loop=args.loop)
        admit = (f"chunked ({engine.prefill_chunk} tokens/chunk, "
                 f"{engine.prefill_attn})" if engine.prefill_chunk
                 else "whole-prompt")
        result.update({k: v for k, v in st.items() if k != "outputs"},
                      admission=admit,
                      free_pages=engine.pools.free_pages(),
                      **graph_stats(engine.graphs.values()),
                      events=dict(collections.Counter(engine.events.kinds())),
                      tokens={rid: o.tokens
                              for rid, o in st["outputs"].items()})
        print(json.dumps({k: v for k, v in result.items()
                          if k != "tokens"}))
        # every submitted request ends with a status: no hangs, no losses
        if st["n_requests"] != args.batch:
            raise RuntimeError(
                f"{args.batch - st['n_requests']} of {args.batch} requests "
                "never reached a terminal status")
        print(f"all {st['n_requests']} requests terminal: {st['statuses']}; "
              f"preemptions {st['n_preemptions']} "
              f"({st['n_preempted_requests']} requests), shed "
              f"{st['n_shed']}, deadline {st['n_deadline']}, failed "
              f"{st['n_failed']}; events {result['events']}; pages "
              f"quiescent")
        return result
    sampling = dict(temperature=args.temperature, seed=args.seed,
                    loop=args.loop)
    generate(model, params, prompts, min(args.gen, 2), **sampling)  # warm-up
    stats: dict = {}
    out = generate(model, params, prompts, args.gen, stats=stats, **sampling)
    result.update(
        tokens=out.cpu().tolist(), first_logits=stats["first_logits"],
        prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
        **graph_stats(r for r, _ in model.graphs.values()),
        prefill_tok_s=args.batch * args.prompt_len / stats["prefill_s"],
        decode_tok_s=(args.batch * (args.gen - 1) / stats["decode_s"]
                      if args.gen > 1 else 0.0))
    if cfg.kv_bits or "mamba" in cfg.layer_kinds():
        result["kv_cache_bytes"], result["kv_cache_fp_bytes"] = kv_cache_bytes(
            model, args.batch, args.prompt_len + args.gen)
    if args.profile:
        prof = profile_generate(model, params, prompts, args.gen,
                                loop=args.loop)
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
