#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER/src [NAME,...]

Phases, in order; any failure exits non-zero before the final line:
  1. card and build: the card's name and power limit, then every CUDA
     kernel built from ``src/repro_torch/csrc`` (one nvcc per source, all
     started together);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (llama3-8b widths; deepseek-v3's for the MLA kernels), with
     times for the kernel, the plain
     version, a one-call PyTorch yardstick (``library_ms``, used nowhere in
     the port) and the least time the card could take (``bound_ms``);
     ``quant_matmul``'s three kernels each where a path runs it: the
     decode (m 4; its split-k sums meet in a cluster) and the tensor-core
     tile (bf16, m 256 and 512) at llama3-8b's and deepseek-v3's
     projections (the decode on deepseek-v3's wq_a and wkv_a too), the
     tile's fp32 form (x split into three bf16 terms) on MLA's
     head-batched expand of a prefill chunk; ``gram`` bitwise symmetric;
     ``attn_colsum`` at llama3-8b's and the MLA path's heads, two calls
     bitwise equal; the MoE slice's two (``check_moe_kernels``): ``gram``
     batched over deepseek-v2's expert buffers (E 160, n 96, d 5120 and
     1536; one launch a stack) and the expert-stack ``quant_matmul`` (E
     160, m 8 and 96, 5120 -> 1536 and 1536 -> 5120); ``quant_matmul_t``'s two
     (MLA's absorb: m 4 and a prefill chunk of ENGINE_CHUNK); the MLA
     latent decode at B 4, S 8192 and at the engine's 4 slots at
     positions 512-575, paged bitwise equal to flat; ``fwht``
     (through ``hadamard_transform``) at the models' widths, though no path
     of the system runs it; GPTQ's in-block solve (``solve_block``, which
     has no Pallas counterpart: the reference's XLA compiles that loop)
     bitwise against its plain loop at llama3-8b's wk, wd and wq + wo (N 2)
     and deepseek-v3's wkv_a (576 columns) and wkv_b (d_in 512), over every
     bit width, group and sym / asym, on errors that lie halfway between
     two fp32 subnormals (``subnormal_tie_inputs``), and a whole 4096 x
     1024 solve on the kernel bitwise against the same solve on the plain
     loop; beside its byte bound, the cost of a row measured (the slope
     from 64 rows to 128) and a chain bound estimated from the SASS of the
     instance each shape runs (``loop_chain_cycles``: one row's dependent
     path with assumed latencies x the block's rows), and each instance's
     registers and spills from ``ptxas``; and this slice's shapes
     (``check_variant_kernels``): ``quant_matmul`` at mamba2-780m's four
     projections (``wdt``'s 48 columns, less than one column tile),
     qwen1.5-4b's FFN input and command-r-35b's 22528-row FFN output,
     ``gram`` at d 3072 and 22528, the three GQA attention kernels at one
     (qwen1.5) and three (minitron) query heads a KV head, and
     ``attn_colsum`` at qwen1.5's and command-r's heads; the hybrid
     slice's (``check_hybrid_kernels``): ``quant_matmul`` at
     jamba-v0.1-52b's four Mamba projections (``wbc``'s 32 and ``wdt``'s
     128 columns), ``gram`` on its E 16 expert stacks (n 320, d 4096 and
     14336) and the stacks' ``quant_matmul`` at m 8 and 40;
  3. the main path: RSQ quantize of llama3-8b at full width and 1 layer
     (random weights from a seed; GPTQ's solves grouped by shape, each
     block of rows one ``solve_block`` launch a group; the layer's
     ``seconds`` and ``solve_s`` on the ``main_path`` line) -> packed
     artifact -> keep-packed greedy
     serve in bf16, with every kernel's launches counted over that run
     (``quant_matmul``'s by the kernel that ran, too).  Every decode runs
     in a captured loop (``--loop graph``: a generation's decode steps, an
     engine burst, each one CUDA graph replay); the fp-cache serve, kv8
     and kv2 ``generate`` and the whole-prompt kv8 engine run again with
     ``--loop python`` (counted apart), and fail unless the two loops give
     the same tokens bit for bit and launch every kernel the same number
     of times, unless each graph key was captured once, and unless
     sampled calls replayed from a graph agree with their plain versions;
     the keep-packed serve is compared with a serve of the same artifact
     with weights dequantized at load time, and two of layer 0's GPTQ
     solves (Hessians from the kernels, solver on the card) are compared
     with the same solves done on the host CPU with the plain versions;
     then the quantized-KV serving path on the same artifact, for kv8 and
     kv2: ``generate`` through the flat quantized cache, and the
     continuous-batching ``Engine`` over paged pools on a Poisson trace in
     three admission modes (whole prompt, chunked exact, chunked paged),
     its launches counted apart, then each mode again under overload (a
     pool of half the hot demand: preemption with replay, priorities),
     and the whole mode with an injected burst failure and with a bounded
     queue that sheds.  It fails unless every request ends ok,
     every drain returns every page, each request's first token is its
     solo ``generate`` first token (kv2's paged chunked prefill reads its
     earlier chunks back from 2-bit codes, so there each final chunk's
     logits are held to the same step with the plain extend instead), no
     helper that holds the cache in fp is ever called, and sampled calls
     of the three quantized-KV kernels on this path agree with their plain
     versions on the same inputs, and unless under overload some request
     is preempted, every request still finishes, and every request that
     was not shed gets the tokens of its mode's run at full pool, bit for
     bit (through a retried burst too);
  4. the MLA path: the same flow on deepseek-v3-671b at full width, its
     first (dense) layer: quantize -> artifact -> keep-packed serve
     (absorb and expand on the packed wkv_b through ``quant_matmul_t`` and
     the head-batched ``quant_matmul``) vs the dequantized serve, layer
     0's ``mixer/wkv_b`` solve redone on the host CPU, and the kv8 / kv2
     path (``mla_flash_decode``, ``paged_mla_flash_decode``,
     ``paged_mla_flash_extend``) with the same checks, its launches
     counted from zero;
  5. the MoE path (``moe_path``): deepseek-v2-236b at full width, 2 layers
     (layer 0 dense, layer 1 with 160 routed experts, top-6, 2 shared),
     bf16: quantize -> artifact (the MoE layer's seconds and the peak
     device memory logged) -> keep-packed serve in the graph and the
     Python loop vs the dequantized serve; kv8 ``generate`` and the
     engine in whole-prompt and chunked-paged admission; layer 1's
     ``experts/wd`` solves of 8 experts redone on the host CPU
     (``check_expert_solves``), its launches counted from zero;
  6. the variants path (``variants_path``): qwen1.5-4b (qkv bias, G 1)
     and command-r-35b (tied embeddings) at full width, 1 layer each:
     quantize (peak device memory logged) -> artifact -> keep-packed serve
     in both loops; qwen's kv8 ``generate`` and engine (whole-prompt and
     chunked-paged); command-r's dequantized serve, kv8 ``generate`` and
     a ``--no-rotate`` quantize served (no ``head``: the tied table is the
     LM head); layer 0's qwen ``mixer/wq`` and command-r ``mixer/wk``
     solves against the host CPU;
  7. the SSM path (``ssm_path``): mamba2-780m, 6 of its 48 layers (48
     until the hybrid path below needed the time, 24 until the cross
     path did, 12 until the script's time did): quantize
     (seconds and ``solve_s`` per layer, ``ppl_ratio`` over the 6
     layers) -> keep-packed bf16 serve at prompt 64 / 16 tokens and 1024 /
     32, each in both loops (the Mamba state in the graph's static cache)
     and against the dequantized serve; layer 0's ``wzx``, ``wdt`` and
     ``out_proj`` solves against the host CPU;
  8. the hybrid path (``hybrid_path``): jamba-v0.1-52b at full width, its
     first layer group (8 layers: Mamba-2 and GQA mixers, dense and
     16-expert FFNs), bf16: quantize (layer seconds by block kind, peak
     device memory under 70 GB, ``ppl_ratio``) -> artifact -> keep-packed
     serve at prompt 64 / 16 tokens (fp cache) and 1024 / 32 (kv8), each
     in both loops, a traced decode, keep-packed vs dequantized (in fp32
     when 8 bf16 layers part them beyond 2e-2), then layer 0's ``wbc`` and
     ``out_proj``, layer 4's ``wk`` and two of layer 1's ``experts/wi``
     solves against the host CPU (``check_hybrid_solves``);
  9. the cross path (``cross_path``), through the library entry points
     (the CLIs take no frames or media): whisper-medium whole (24
     non-causal encoder blocks, 24 decoder blocks with cross-attention on
     the encoder's output) in fp32, calibrated on 8 x 448 tokens with
     8 x 1500 frames, and llama-3.2-vision-11b's first layer group (5
     layers, cross-attention at 3 on 6404 media rows a sample) in bf16:
     quantize (layer seconds, ``capture_s`` and ``solve_s`` by block kind,
     peak device memory, ``ppl_ratio`` with frames or media) -> artifact
     -> keep-packed bf16 serve at two (prompt, new tokens, kv bits) each,
     in both loops (the cross K/V computed by the prefill, static in the
     graph's cache), a traced decode, keep-packed vs dequantized (in fp32
     where bf16 parts them), then whisper's ``enc0/mixer/wq`` (non-causal
     AttnCon) and ``layer0/cross/wk`` (an unweighted Hessian of the
     encoder's output) and the vision model's ``layer3/mixer/wk`` solves
     against the host CPU (``cross_solves``); phase 2's
     ``check_cross_kernels`` rows: ``attn_colsum``'s non-causal form at
     the encoder's B 4, T 1500, H = KV 16, Dh 64 (``noncausal`` beside the
     causal row in the ``kernels`` line) and its causal form at T 448,
     ``flash_decode`` at G 1, KV 16, Dh 64, ``quant_matmul`` at whisper's
     three projection shapes, ``gram`` at d 1024 and on 4 x 6404 bf16
     media rows of d 4096 (``media``);
  10. the LDLQ path (``ldlq_path``): the quantize CLI with ``--method
     ldlq`` on llama3-8b at full width, 1 layer, fp32, sequential: layer
     seconds, ``capture_s``, ``solve_s``, the peak device memory and
     ``ppl_ratio``, ``ldlq_block``'s launches (208 a layer); layer 0's
     ``mixer/wk`` solved on the card, bitwise the same solve with the
     plain loop there, and against the host CPU on the same H (the same
     scales, >= 99% of the octets, the proxy loss within 1%), and both
     solves against an fp64 solve of that H on the host (the card's share
     of equal lattice points at most 5 points below the host's, its proxy
     loss within 1%; logged: the factors' errors, and the card's solve on
     an fp32 factor); and the refusal of ``--pack-out`` with it; phase 2's ``check_ldlq_block``:
     LDLQ's in-block solve with the E8 rounder (no Pallas counterpart: the
     reference's XLA compiles that loop) bitwise against its plain loop at
     llama3-8b's four shape groups (timed, with its byte bound, the
     instance R each runs, its registers, spills and SASS chain estimate
     and the measured cost of a row), at each instance R (blocks of 1, 7,
     33 and 127 rows at d_out 8, 24, 1000 and 4104, and N 3 at 14336), on
     octets of a 1/2- and a 1/4-grid (the rounder's ties), on rows whose
     two divisions land halfway between fp32 subnormals, and at d_out 8
     and 32768; its division alone against IEEE division on 2^24 random
     bit patterns;
  11. the schedules-and-resume path (``schedule_resume_path``): llama3-8b
     at full width, 2 layers, bf16, GPTQ with ``pack_output``, from
     Python: the sequential and the overlapped schedule bitwise (params,
     artifact entries, reports), each one's wall time and host syncs a
     layer (``torch.cuda.set_sync_debug_mode``); a run killed at 1:solve
     and resumed by a fresh pipeline and ``QuantizeRunner``, and an
     in-process retry at 1:capture, each bitwise the sequential run; the
     checkpoint overhead in seconds and bytes;
  12. the strategy sweep: the quantize CLI on llama3-8b's layer 0 at full
     width, once with each of the paper's eight token-importance strategies
     and once with AttnCon on the calibration set expanded twofold: each
     run's seconds, proxy losses and ``ppl_ratio``; fails on a loss that is
     not finite.
The CLI runs of phases 3-10 and 12 and the cross path's pipelines take
the sequential schedule (``--scheduler sequential``), which times each
stage of a layer; the overlapped schedule, the default on CUDA, is held
to it in phase 11 and on the MoE path's quantize run, run again on the
default schedule (``default_schedule_check``: the artifact's files
bitwise, the seconds and the peak device memory).
Each path fails if a kernel it runs was never launched.  The last two
lines are the ``kernels`` JSON object (thirteen kernels, each with its
launches on every path in ``path_launches``, ``gram``'s with its expert
stack rows in ``experts`` and its media row in ``media``,
``attn_colsum``'s with its non-causal row in ``noncausal`` and each
form's launches on every path, ``solve_block``'s with its launches on each
path; ``quant_matmul``'s
entry is its decode row with ``prefill`` and ``prefill_fp32`` rows beside
it, each with its kernel's launches on every path, ``quant_matmul_t``'s its
decode row with a ``prefill`` row, each with its kernel's MLA launches;
``quant_matmul``'s expert-stack rows in ``experts`` (jamba's as
``hybrid_*``) and jamba's Mamba projections in ``hybrid``) and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
reference package.

``--only PHASE[,PHASE...]`` (for development) runs the named phase-2
checks and, of the paths, ``moe_path``, ``ldlq_path`` and
``schedule_resume_path``, and prints no result line.

``--compare OTHER/src [NAME,...]`` runs no phase: it times (all, or, to
spend fewer minutes of the card on a kernel under work, the named ones of
``TIMERS``) ``gram`` (d 4096 and
14336), ``attn_colsum`` (llama3-8b's and the MLA path's heads), the packed
matmul as phase 2 does at llama3-8b's down projection (bf16, 3 and 4 bits,
m 4, 256 and 512), the three GQA attention wrappers on phase 2's inputs
(kv8 and kv2), and MLA's absorb (``quant_matmul_t``) and expand
(``quant_matmul``, fp32), each at m 4 and 128, extend (kv8 and kv2) and
latent decode (flat and paged, kv8 and kv2, at B 4, S 8192 and at the
engine's 4 slots at positions 512-575), GPTQ's in-block solve
(``solve_block``) at phase 2's five shapes and LDLQ's (``ldlq_block``) at
its four, with ``repro_torch`` imported
from OTHER/src (another checkout, e.g. the parent commit from ``git
archive``) and from this one in turns (other, this, this, other; one
process each) and prints the four runs as one JSON line.
"""
from __future__ import annotations

import dataclasses
import gc
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

# main path: llama3-8b, depth cut to 1 layer so that the whole script, the
# MLA path included, stays near 8 minutes; 8 x 512 calibration tokens
ARCH, N_LAYERS = "llama3-8b", 1
N_CALIB, CALIB_SEQ, CALIB_BATCH = 8, 512, 4
SERVE_BATCH, PROMPT_LEN, N_GEN = 4, 64, 16
BITS, GROUP, SEED = 3, 128, 0
# layer 0's attention-input and FFN-input weights, solved again on the CPU
SOLVE_CHECK = ("mixer/wk", "ffn/wi")

# quantized-KV serving path: generate at batch 4, then the engine
KV_BITS = (8, 2)
KV_PROMPT, KV_GEN = 1024, 32
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_BUDGETS = 8, 512, (16, 64)
ENGINE_SLOTS, ENGINE_PAGES, ENGINE_BURST, ENGINE_CHUNK = 4, 48, 8, 128
ENGINE_RATE = 0.5  # Poisson arrivals per scheduling round
ENGINE_MODES = (("whole", None, "exact"), ("chunked-exact", ENGINE_CHUNK,
                                           "exact"),
                ("chunked-paged", ENGINE_CHUNK, "paged"))
# each admission mode's 8 requests again under overload: a pool of twice
# one request's pages, so 4 slots' hot demand is twice the pool; arrivals
# at OVER_RATE, the last two requests at priority 1.  Every request must
# still finish with the tokens of the same mode's run above, at least one
# after a preemption.  The whole mode then runs twice more at ENGINE_PAGES:
# with a burst failure injected at round FAULT_ROUND (retried from the same
# inputs: the same tokens), and with a queue of SHED_DEPTH at SHED_RATE
# (refused submissions shed, the rest the same tokens)
OVER_RATE, OVER_PRIORITY = 2.0, (6, 7)
FAULT_ROUND, SHED_DEPTH, SHED_RATE = 3, 2, 8.0
# the engine modes that kv8 runs again under the profiler on each path
# (``<mode>_profile``): chunked-paged prefill runs the extend kernel, and on
# the MLA path the absorb's fp32 tile, on every chunk
TRACED_MODES = ("whole", "chunked-paged")
# phase 2's packed-matmul rows: decode (the serve batch), prefill (batch x
# prompt) and the engine's whole prompt
QMM_M = (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN, ENGINE_PROMPT)
# quant_matmul's launches are also counted by the CUDA kernel that ran: the
# split-k decode (m <= 4) and the tensor-core tile in its bf16 form
# (qmm_tc) and its fp32 form (qmm_tc_f32: fp32 x as three bf16 terms).
# Both paths require each kernel they run; the main path serves in bf16
# only and never takes the fp32 form, which MLA's head-batched expand runs
# (fp32 x, m > 4) on the MLA path
# (quant_matmul_t, MLA's absorb, likewise: the decode kernel qmm_t_decode,
# m <= 4, and the fp32 tile qmm_t_tile, the chunked prefill's m =
# ENGINE_CHUNK; the MLA path runs both)
QMM_KERNELS = ("qmm_decode", "qmm_tc", "qmm_tc_f32")
MAIN_PATH_WITHOUT = ("qmm_tc_f32",)
# phase 2 widths of fwht: llama3-8b's d_model (a pure FWHT) and d_ff =
# 2^11·7, deepseek-v3's d_model 2^10·7 and d_ff 2^11·9, each over one
# calibration batch; and the reference benchmark's 512 x 512
HADAMARD_SHAPES = ((CALIB_BATCH * CALIB_SEQ, 4096),
                   (CALIB_BATCH * CALIB_SEQ, 14336),
                   (CALIB_BATCH * CALIB_SEQ, 7168),
                   (CALIB_BATCH * CALIB_SEQ, 18432), (512, 512))
# phase 2 shapes of the quantized-KV kernels (llama3-8b heads)
FD_B, FD_S, FD_KV, FD_G, FD_DH, FD_TAIL = 4, 8192, 8, 4, 128, 37
FE_L, FE_PAST = 256, 16
# phase 3 holds the quantized-KV kernels to their plain versions on the main
# path's own calls: of each kernel's calls in each run, the first
# AUDIT_FIRST and then every AUDIT_EVERY-th (odd, so with 2 layers both are
# drawn)
AUDIT_FIRST, AUDIT_EVERY = 8, 7

# MLA path: deepseek-v3-671b at full width, its first layer (dense: MLA +
# SwiGLU; cut from 2 for the script's time now that the MoE path below
# runs MLA at layer 1 too); the same calibration, serving and engine
# settings as above
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 1
MLA_SOLVE_CHECK = ("mixer/wkv_b",)  # d_in 512: ragged 3-bit words
# MoE path: deepseek-v2-236b at full width, 2 layers (layer 0 MLA + dense
# SwiGLU, layer 1 MLA + 160 routed experts, top-6, and 2 shared), in bf16
# (10.7 GB of weights; fp32 would not leave room for the experts' 18.3 GB
# of Hessians); the same calibration and serving settings as above, kv8
# serving in two admission modes
MOE_ARCH, MOE_LAYERS, MOE_DTYPE = "deepseek-v2-236b", 2, "bfloat16"
MOE_E, MOE_D, MOE_F = 160, 5120, 1536
# an expert's capacity in a calibration batch (4 x 512 tokens x top-6 /
# 160 x 1.25, rounded up to 8) and at a decode step of the serve batch
MOE_CAP_CALIB, MOE_CAP_DECODE = 96, 8
MOE_SOLVE_EXPERTS = 8  # layer 1's experts/wd solves redone on the CPU
MOE_ENGINE_MODES = tuple(m for m in ENGINE_MODES
                         if m[0] in ("whole", "chunked-paged"))
# the variants path: qwen1.5-4b (qkv bias; 20 query heads on 20 KV heads,
# G 1) and command-r-35b (tied embeddings, 64 / 8 heads, d_ff 22528,
# vocab 256000) at full width, VARIANT_LAYERS layer each, the main path's
# calibration and serving settings; qwen's kv8 engine in two admission
# modes, command-r's kv8 generate, its artifact dequantized at load, and
# command-r quantized again with --no-rotate (its tied table is the head)
QWEN_ARCH, CMDR_ARCH, VARIANT_LAYERS = "qwen1.5-4b", "command-r-35b", 1
# layer 0's solves redone on the host CPU: qwen's biased wq; command-r's wk
# (its wd, d_in 22528, is estimated at about two minutes of host time, not
# measured: two 22528 x 8192 GPTQ solves and the capture of its 22528-wide
# FFN, where the script has ~300 s left of its limit)
VARIANT_SOLVE_CHECK = {QWEN_ARCH: ("mixer/wq",), CMDR_ARCH: ("mixer/wk",)}
# the SSM path: mamba2-780m, 6 of its 48 layers (cut from the whole model
# to 24 to make room for the hybrid path, to 12 for the cross path, then
# to 6 to keep the script inside its time;
# d_model 1536, d_inner 3072, 48 SSD
# heads of 64, state 128, tied embeddings), quantized in fp32,
# served keep-packed in bf16 at (prompt, new tokens) SSM_SERVES, each in
# both decode loops and against the dequantized serve; layer 0's wzx, wdt
# (1536 x 48: quantized at full width) and out_proj re-solved on the CPU
SSM_ARCH, SSM_LAYERS = "mamba2-780m", 6
SSM_SERVES = ((PROMPT_LEN, N_GEN), (KV_PROMPT, KV_GEN))
SSM_SOLVE_CHECK = ("mixer/wzx", "mixer/wdt", "mixer/out_proj")
# kernels a path does not run, with the reason
SSM_PATH_WITHOUT = dict.fromkeys(
    ("attn_colsum", "colsum_causal"),
    "attention-free: AttnCon falls back to ActNorm")
# the hybrid path: jamba-v0.1-52b at full width, its first layer group (8
# layers: Mamba-2 blocks at positions 0-3 and 5-7, GQA 32 / 8 at 4; dense
# FFNs at the even positions, 16 routed experts top-2 of 14336 at the odd
# ones, no shared expert), in bf16 (26.5 GB of weights; the MoE layers'
# 14.2 GB of expert Hessians beside them); the quantize run's peak device
# memory must stay under HYB_MAX_BYTES.  Served keep-packed in bf16 at
# (prompt, new tokens, kv bits) HYB_SERVES, each in both loops and against
# the dequantized serve
HYB_ARCH, HYB_LAYERS, HYB_DTYPE = "jamba-v0.1-52b", 8, "bfloat16"
HYB_E, HYB_D, HYB_F = 16, 4096, 14336
HYB_MAX_BYTES = 70e9
# an expert's capacity (moe_capacity) in a calibration batch (4 x 512
# tokens x top-2 / 16 x 1.25), a decode step of the serve batch (rounded
# up to 8) and a prefill of 4 x 64 tokens
HYB_CAP_CALIB, HYB_CAP_DECODE, HYB_CAP_PREFILL = 320, 8, 40
HYB_SERVES = ((PROMPT_LEN, N_GEN, 0), (KV_PROMPT, KV_GEN, 8))
# solves redone on the host CPU, by layer: layer 0's Mamba wbc (n 32) and
# out_proj (d_in 8192), the GQA block's wk, and HYB_SOLVE_EXPERTS of layer
# 1's experts/wi (a 14336-row experts/wd solve costs too much host time)
HYB_SOLVE_CHECK = {0: ("mixer/wbc", "mixer/out_proj"), 4: ("mixer/wk",),
                   1: ("ffn/experts/wi",)}
HYB_SOLVE_EXPERTS = 2
# the rows whose fp32-noise floor is measured too (a second host solve; the
# others, d_in x d_out 33-59 M, would cost ~1 min of host time more)
HYB_NOISE_FLOOR = ("mixer/wbc", "mixer/wk")
# phase 2 shapes of jamba's Mamba projections (d_inner 8192, 128 heads,
# state 16: wbc's 32 columns are the narrowest output quantized so far)
HYB_QMM = (("wzx", 4096, 16384), ("wbc", 4096, 32), ("wdt", 4096, 128),
           ("out_proj", 8192, 4096))
# kernels the hybrid path does not run, with the reason
HYB_PATH_WITHOUT = {
    "paged_flash_decode": "the engine refuses Mamba blocks (state per slot, "
                          "not per page), as the reference's does",
    "paged_flash_extend": "the chunked prefill refuses Mamba blocks"}
# the cross path (``cross_path``): whisper-medium whole (24 non-causal
# encoder blocks and 24 decoder blocks, each with a cross-attention
# sub-layer on the encoder's output; d 1024, 16 heads of 64, d_ff 4096,
# qkv bias), fp32 weights, calibrated on N_CALIB x WSP_CTX decoder tokens
# (its text context) with N_CALIB x WSP_FRAMES frames (its 30 s audio
# context; the stub frontend's frames N(0, 1) from a torch.Generator) in
# batches of CALIB_BATCH, served keep-packed in bf16 at (prompt, new
# tokens, kv bits) WSP_SERVES; then llama-3.2-vision-11b's first layer
# group (VIS_LAYERS layers: GQA 32 / 8 at 0, 1, 2 and 4, cross-attention
# on VIS_MEDIA patch rows a sample at 3), bf16, calibrated on the main
# path's N_CALIB x CALIB_SEQ tokens, served at VIS_SERVES; each serve in
# both loops and against the dequantized serve (in fp32 when bf16 parts
# them beyond TOL_SERVE_LOGITS, as the SSM path)
WSP_ARCH, WSP_FRAMES, WSP_CTX = "whisper-medium", 1500, 448
WSP_SERVES = ((PROMPT_LEN, N_GEN, 0), (384, 32, 8))
VIS_ARCH, VIS_LAYERS, VIS_DTYPE = "llama-3.2-vision-11b", 5, "bfloat16"
VIS_SERVES = ((PROMPT_LEN, N_GEN, 0), (KV_PROMPT, KV_GEN, 8))
# solves redone on the host CPU: whisper's enc0 wq (non-causal AttnCon
# importances) and layer 0's cross wk (an unweighted Hessian of the
# encoder's output), the vision model's cross mixer wk (of the media rows)
WSP_SOLVE_CHECK = ("enc0/mixer/wq", "layer0/cross/wk")
VIS_SOLVE_CHECK = ("layer3/mixer/wk",)
# phase 2 shapes of the cross path: whisper's projections (3-bit, m 4 and
# 256), its attention heads (16 on 16 of 64) in attn_colsum (the encoder's
# non-causal form over 1500 frames, the decoder's causal form over 448
# positions) and flash_decode (G 1 over 448 positions), gram at d 1024 on
# an encoder batch and on a vision batch's media rows (bf16, no r)
WSP_QMM = (("wq/wk/wv/wo", 1024, 1024), ("wi/wu", 1024, 4096),
           ("wd", 4096, 1024))
WSP_HEADS, WSP_DH, VIS_MEDIA, VIS_D = 16, 64, 6404, 4096
# kernels the cross path does not run, with the reason
CROSS_PATH_WITHOUT = {
    "paged_flash_decode": "the engine refuses cross-attention (media and "
                          "encoder K/V are per request, not per page), as "
                          "the reference's does",
    "paged_flash_extend": "the chunked prefill refuses cross-attention"}
# phase 2 shapes of this slice's projections (3-bit, the main path's m):
# mamba2-780m's four (wdt's 48 columns are less than one column tile),
# qwen1.5-4b's FFN input and command-r-35b's FFN output; gram at the
# widest Hessians of mamba2 (out_proj) and command-r (wd: a 2.0 GB
# accumulator)
VARIANT_QMM = (("mamba2-780m", "wzx", 1536, 6144),
               ("mamba2-780m", "wbc", 1536, 256),
               ("mamba2-780m", "wdt", 1536, 48),
               ("mamba2-780m", "out_proj", 3072, 1536),
               ("qwen1.5-4b", "wi/wu", 2560, 6912),
               ("command-r-35b", "wd", 22528, 8192))
VARIANT_GRAM = (("mamba2-780m", 3072), ("command-r-35b", 22528))
# and the GQA attention kernels at qwen1.5's G 1 (20 / 20 heads) and
# minitron's G 3 (24 / 8), attn_colsum at qwen's and command-r's heads
VARIANT_KV = (("qwen1.5-4b", 20, 1), ("minitron-4b", 8, 3))
VARIANT_COLSUM = ((20, 20), (64, 8))
# the strategy sweep: llama3-8b's layer 0 at full width calibrated once with
# each of the paper's eight token-importance strategies, and once more with
# AttnCon on the calibration set expanded by SWEEP_EXPANSION circular shifts
SWEEP_STRATEGIES = ("uniform", "first_n", "first_last_n", "token_freq",
                    "act_norm", "act_diff", "token_sim", "attn_con")
SWEEP_EXPANSION = 2
# phase 2 shapes of GPTQ's in-block solve (N matrices of one shape, d_out):
# llama3-8b's wk (one of wk + wv), wd, wq + wo solved together;
# deepseek-v3's wkv_a (576 columns: ragged) and wkv_b (d_in 512)
SOLVE_SHAPES = {"wk": (1, 1024), "wd": (1, 4096), "wq+wo": (2, 4096),
                "wkv_a": (1, 576), "wkv_b": (1, 32768)}
# phase 2 shapes of LDLQ's in-block solve (N matrices of one shape, d_out):
# llama3-8b's four shape groups, as the pipeline stacks them (wq + wo, wk +
# wv, wi + wu solved together; wd alone, d_in 14336); a layer's launches
# (32 + 32 + 32 blocks of 128 rows at d_in 4096, 112 at 14336)
LDLQ_SHAPES = {"wq+wo": (2, 4096), "wk+wv": (2, 1024), "wi+wu": (2, 14336),
               "wd": (1, 4096)}
LDLQ_LAUNCHES = 208
# a lane of ``ldlq_block``'s kernel owns its rows LDLQ_CHUNK at a time
# (csrc/ldlq_block.cu); phase 2 reaches each instance (R 4, 2 and 1) at
# these blocks of rows (ragged against a round of 4 R rows) and these
# columns (a warp part-filled)
LDLQ_CHUNK = 4
LDLQ_INSTANCE_BLOCKS = (1, 7, 33, 127)
LDLQ_INSTANCE_D_OUT = (8, 24, 1000, 4104)
# the LDLQ path's wk solve, card against the host CPU on one H: the share
# of the first block's octets that must come out the same (U is factored
# on each device and the deferred products sum in another order; the
# scales are the same bits, from fp64).  Over the whole 4096 rows the
# solves part as rows go on, as two host solves do on H and on H with
# fp32 summation noise (``ldlq_path`` logs that floor beside the share):
# logged, not held
LDLQ_MIN_OCTETS = 0.99
LDLQ_BLOCK = 128
# the whole wk solve against an fp64 solve of the same H: the card's share
# of lattice points equal to the fp64 solve's may fall at most this far
# below the host CPU's (an E8 flip feeds 8 columns' errors to every later
# row, so a less accurate factor shows here first)
LDLQ_FP64_MARGIN = 0.05
# the schedules-and-resume path: llama3-8b at full width, this many layers
# (a resume needs a layer checkpoint before the failing layer), bf16
SR_LAYERS = 2
# phase 2 shapes of the MLA kernels (deepseek-v3: 128 heads, latent 512,
# rope 64, nope and value heads 128)
MLA_H, MLA_DN, MLA_DV, MLA_DL, MLA_DR = 128, 128, 128, 512, 64
MD_B, MD_S, MD_TAIL = 4, 8192, 37
# and at the engine's shape: 4 slots at positions 512-575 (prompts of
# ENGINE_PROMPT plus up to 64 tokens), 9 pages of 64 each
MD_ENGINE_POS = (575, 560, 543, 512)
MD_SHAPES = {"B4_S8192": (MD_S - MD_TAIL,) * MD_B,
             "engine": MD_ENGINE_POS}
ME_L, ME_PAST = 256, 16

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12,
              "bfloat16": 989e12}

# a lane of ``solve_block``'s kernel owns its rows CHUNK at a time (one
# round: CHUNK x lanes rows; csrc/gptq_block.cu)
SOLVE_CHUNK = 4
# dependent-issue latencies (cycles) assumed for Hopper's SASS ops in the
# chain estimate of ``loop_chain_cycles``: fp32 and integer ALU ops 4 (any op
# not listed, branches and reconvergence too), the special-function unit's
# 20, conversions and rounding 10, shared-memory loads 30, shuffles 24,
# fp64 products and FMAs 8.  An
# estimate, not a measurement: phase 2 logs the measured cost of a row
# beside it
SASS_LATENCY = {"MUFU": 20, "FRND": 10, "F2I": 10, "I2F": 10, "F2F": 10,
                "FCHK": 10, "LDS": 30, "SHFL": 24, "S2R": 20, "LDC": 10,
                "LDG": 500, "DMUL": 8, "DFMA": 8, "DADD": 8}
SASS_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "EXIT",
                "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC", "NOP", "DEPBAR",
                "MEMBAR", "FENCE", "ERRBAR", "YIELD", "JMP", "CCTL"}
SASS_COLD = {"CALL.REL.NOINC", "CALL.REL", "MUFU.RCP64H", "SHFL.BFLY"}
SASS_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(\.64)?(?!\w)")

# tolerances, relative to the largest reference magnitude
TOL_FP32 = 1e-5  # fp32 products summed in another order
TOL_COLSUM = 1e-4  # exp in two passes, scores from three-term bf16 products
TOL_BF16 = 8e-3  # one bf16 rounding (2^-8) of the fp32 result
# quantized-KV attention: the same dequantized fp32 terms, each row's scale
# applied after its dot product, sums in another order
TOL_KV = 1e-5
# kv2 paged chunked prefill: the final chunk's logits against the same step
# with the extend kernel replaced by its plain version (TOL_KV apart in fp32).
# The two differ only where a bf16 rounding downstream flips; the head
# rounds each logit to bf16, so one flip already shows as a whole ulp, up to
# 2^-7 of the largest logit.  Two ulps of it:
TOL_CHUNK_LOGITS = 2.0 ** -6
# keep-packed (fp32 dequant + sums in the kernel, bf16 out) vs weights
# dequantized to fp32 at load (cuBLAS fp32, bf16 out): every projection's
# bf16 rounding may land one ulp (2^-8) apart, compounding over 2 layers
TOL_SERVE_LOGITS = 2e-2
# over mamba2-780m's 48 layers that compounding is no bound at all (bf16
# keep-packed and dequantized first-step logits 0.4% apart at 2 layers,
# 1.6% at 8, 4.7% at 48, each bf16 serve 6% from the fp32 serve, on
# NVIDIA H100 80GB HBM3 at 700 W): the SSM path holds keep-packed to
# dequantized with fp32 activations instead, where the two were 1.3e-6
# apart at 2 layers and 7.9e-6 at 48 (same tokens), to TOL_FP32 times
# that growth, rounded up; and each bf16 keep-packed serve to the fp32
# serve no farther than SSM_BF16_FACTOR times the bf16 dequantized one
TOL_SSM_FP32_SERVE = 1e-4
SSM_BF16_FACTOR = 2.0
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

# kernels that no path of the system launches, with the reason; every other
# kernel must launch on the paths that count it
NO_PATH = {"fwht": "no path runs it: core/rotation applies dense Hadamard "
                   "matrices (in the reference too) and nothing outside "
                   "kernels/hadamard calls fwht; held to its plain version "
                   "in phase 2 only"}
# kernels only an encoder's attention runs: the paths without one (every
# path but the cross path's whisper) do not launch them
NO_ENCODER = {"colsum_noncausal": "attn_colsum's non-causal form: no "
                                  "encoder on this path"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def never_launched(launches: dict, *without) -> list:
    """The kernels of a path's ``launches`` that it never launched, but
    NO_PATH's and those named in ``without`` (each the path's
    {name: reason} or names)."""
    skip = set(NO_PATH).union(*without)
    return [name for name, c in launches.items()
            if c <= 0 and name not in skip]


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


class Checks:
    """Phase 2's record: one logged row per (kernel, shape) against its
    plain version, the representative row of each kernel in ``rows`` (under
    the kernel's name, or the key ``representative`` names), and the
    disagreements in ``bad``."""

    def __init__(self, timer):
        self.timer = timer
        self.rows: dict = {}
        self.bad: list = []

    def record(self, name, shape, got, want, tol, ms, plain_ms, library_ms,
               nbytes, flops, dtype, representative, **extra):
        """``got`` may be (max_abs_err, rel_err) computed by the caller
        (piecewise, where the whole difference does not fit), ``want``
        then None."""
        abs_err, rel_err = (got if isinstance(got, tuple)
                            else errors(got, want))
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = {"name": name, "shape": shape, "max_abs_err": abs_err,
               "rel_err": rel_err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               **extra}
        log({"check": row})
        if not (rel_err <= tol):
            self.bad.append(f"{name} {shape}: rel err {rel_err:.3g} > {tol}")
        if representative:
            key = representative if isinstance(representative, str) else name
            self.rows[key] = row

    def clones(self, tensors, nbytes):
        """Independent copies of ``tensors`` so timed calls run cold."""
        n = self.timer.copies(nbytes)
        return [tensors] + [tuple(t.clone() for t in tensors)
                            for _ in range(n - 1)]


def rtn_packed(torch, g, kk: int, nn: int, bits: int):
    """A random (kk, nn) weight drawn from ``g``, RTN-quantized at group
    GROUP and packed: (PackedWeight, the dequantized weight in bf16)."""
    from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
    from repro_torch.kernels.quant_matmul.ops import pack_weight

    spec = QuantSpec(bits=bits, group_size=GROUP)
    w = torch.randn((kk, nn), generator=g, device="cuda") * kk ** -0.5
    _, qc, sc, zr = quantize_weight_rtn(w, spec)
    pw = pack_weight(qc, sc, zr, spec)
    w_bf16 = ((qc.float().reshape(-1, GROUP, nn) - zr[:, None])
              * sc[:, None]).reshape(kk, nn).to(torch.bfloat16)
    return pw, w_bf16


def qmm_bytes(x, pw) -> int:
    """Bytes a 2-D ``quant_matmul`` call must move: x, the packed weight
    and y, each once."""
    return (x.numel() + x.shape[0] * pw.w_packed.shape[-1]) \
        * x.element_size() + pw.nbytes


def packed_sets(checks: Checks, x, pw) -> list:
    """Cold copies [(x, pw), ...] of a ``quant_matmul`` call's inputs for
    the timer (``Checks.clones``)."""
    sets = checks.clones((x, pw.w_packed, pw.scale, pw.zero),
                         qmm_bytes(x, pw))
    return [(a[0], dataclasses.replace(pw, w_packed=a[1], scale=a[2],
                                       zero=a[3])) for a in sets]


def check_kernels(torch, checks: Checks) -> None:
    """Phase 2, first slice: gram, attn_colsum (also at the MLA path's
    shape) and quant_matmul vs their plain versions at the main path's
    shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # gram: one calibration batch (B*T tokens) of the 4096- and 14336-wide
    # weight inputs, fp32, accumulated into the weight's Hessian
    for d in (4096, 14336):
        check_gram(torch, checks, g, d, d == 14336)

    # attn_colsum: the calibration batch's q and k, llama3-8b's (32 query
    # heads on 8 KV heads, Dh 128) and the MLA path's (H = KV = 128 heads
    # of dn + dr = 192)
    for b, t, h, kv, dh in ((CALIB_BATCH, CALIB_SEQ, 32, 8, 128),
                            (CALIB_BATCH, CALIB_SEQ, MLA_H, MLA_H,
                             MLA_DN + MLA_DR)):
        check_colsum(torch, checks, g, b, t, h, kv, dh, kv == 8)
        torch.cuda.empty_cache()

    # quant_matmul: every llama3-8b block projection, decode (m = serve
    # batch) and prefill (m = batch * prompt, and the engine's whole
    # prompt), 3- and 4-bit, group 128, bf16
    shapes = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
              "wi/wu": (4096, 14336), "wd": (14336, 4096)}
    for bits in (3, 4):
        for wname, (kk, nn) in shapes.items():
            main = bits == BITS and wname == "wd"
            check_packed(torch, checks, g, wname, kk, nn, bits, QMM_M,
                         main and {SERVE_BATCH: True,
                                   SERVE_BATCH * PROMPT_LEN:
                                   "quant_matmul_prefill"})
    check_fp32_long_rows(torch, checks, g)
    torch.cuda.empty_cache()


def check_gram(torch, checks: Checks, g, d: int, representative,
               arch: str = ARCH, n: int = CALIB_BATCH * CALIB_SEQ,
               media: bool = False) -> None:
    """``gram`` on one calibration batch (n rows, B*T tokens by default)
    of a d-wide weight input drawn from ``g`` against its plain version
    (TOL_FP32), bitwise symmetric from a zero accumulator; timed into an
    accumulator with the plain version and ``xrᵀ xr`` beside it.  The
    rows are fp32 with importances r, or with ``media`` bf16 media rows
    with none (r None), as cross-attention's wk / wv take them."""
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.gram.ref import weighted_gram_ref

    timer, dev = checks.timer, torch.device("cuda")
    x = torch.randn((n, d), generator=g, device=dev)
    r = None if media else torch.rand((n,), generator=g, device=dev)
    if media:
        x = x.to(torch.bfloat16)
    want = weighted_gram_ref(x, r)
    got = weighted_gram(x, r)
    # from a zero accumulator the kernel's result is bitwise symmetric
    if not torch.equal(got, got.T):
        checks.bad.append(f"gram (n {n}, d {d}) is not bitwise symmetric")
    # read x (and r) once, read and write the (d, d) accumulator
    nbytes = n * d * x.element_size() + (0 if media else n * 4) \
        + 2 * d * d * 4
    # (x, accumulator[, r]): r goes in positionally where there is one
    sets = checks.clones((x, torch.zeros_like(want))
                         + (() if media else (r,)), nbytes)
    ms = timer.ms(lambda a=a: weighted_gram(a[0], *a[2:], out=a[1],
                                            alpha=2.0) for a in sets)
    plain_ms = timer.ms(lambda a=a: weighted_gram_ref(a[0], *a[2:])
                        for a in sets)
    xrs = [(a[0].float() * (a[2][:, None] if a[2:] else 1.0),)
           for a in sets]
    library_ms = timer.ms(lambda a=a: torch.mm(a[0].T, a[0]) for a in xrs)
    # the least work: the product is symmetric, d(d+1)/2 distinct entries
    # of n multiply-adds each, at the cheapest fp32-accurate tensor-core
    # rate, as the other fp32 rows: both operands fp32, so three bf16 terms
    # each and the six term products i + j < 3 at 989 TFLOP/s (cheaper
    # than three TF32 products at 495, and than the fp32 pipes' 67); bf16
    # media rows without r need the one bf16 product
    flops = (1.0 if media else 6.0) * n * d * (d + 1)
    shape = {"arch": arch, "n": n, "d": d}
    if media:
        shape["x"] = "bfloat16 media rows, no r"
    checks.record("gram", shape, got, want, TOL_FP32, ms, plain_ms,
                  library_ms, nbytes, flops, "bfloat16", representative)
    del x, r, want, got, sets, xrs
    torch.cuda.empty_cache()


def colsum_flops(b: int, t: int, h: int, dh: int,
                 causal: bool = True) -> float:
    """The least work of ``attn_colsum`` on fp32 q and k, for its bound: the
    causal half of q kᵀ once (all of it when not ``causal``; the kernel's
    two passes compute it twice), at
    the cheapest fp32-accurate tensor-core rate, as the other fp32 rows: both
    operands fp32, so three bf16 terms each and the six term products
    i + j < 3 at 989 TFLOP/s (cheaper than three TF32 products at 495, and
    than the fp32 pipes' 67).  The exps (one a score) are not counted."""
    pairs = t * (t + 1) / 2 if causal else t * t
    return 6.0 * 2.0 * b * h * pairs * dh


def check_colsum(torch, checks: Checks, g, b: int, t: int, h: int, kv: int,
                 dh: int, representative, *, causal: bool = True,
                 arch: str | None = None) -> None:
    """``attn_colsum`` (``causal``, or the non-causal form an encoder
    runs) on fp32 q (B, T, H, Dh) and k (B, T, KV, Dh) drawn from ``g``
    against its plain version (TOL_COLSUM), two calls bitwise equal;
    timed with the plain version and the materialised softmax (one
    PyTorch expression) beside it."""
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.attn_colsum.ref import attn_colsum_ref

    timer, dev = checks.timer, torch.device("cuda")
    q = torch.randn((b, t, h, dh), generator=g, device=dev)
    k = torch.randn((b, t, kv, dh), generator=g, device=dev)
    want = attn_colsum_ref(q, k, causal=causal)
    got = attn_colsum(q, k, causal=causal)
    shape = {"B": b, "T": t, "H": h, "KV": kv, "Dh": dh}
    if not causal:
        shape["causal"] = False
    if arch:
        shape["arch"] = arch
    if not torch.equal(got, attn_colsum(q, k, causal=causal)):
        checks.bad.append(f"attn_colsum {shape}: two calls differ")
    nbytes = (q.numel() + k.numel()) * 4 + b * t * 4
    sets = checks.clones((q, k), nbytes)
    ms = timer.ms(lambda a=a: attn_colsum(*a, causal=causal) for a in sets)
    plain_ms = timer.ms(lambda a=a: attn_colsum_ref(*a, causal=causal)
                        for a in sets)
    mask = torch.ones((t, t), dtype=torch.bool, device=dev)
    if causal:
        mask = mask.tril()

    def materialized(qq, kk):
        kr = kk.repeat_interleave(h // kv, dim=2)
        s = torch.einsum("bthd,bshd->bhts", qq, kr) * dh ** -0.5
        return torch.softmax(s.masked_fill(~mask, -1e30), -1).sum((1, 2))

    library_ms = timer.ms(lambda a=a: materialized(*a) for a in sets)
    checks.record("attn_colsum", shape, got, want, TOL_COLSUM, ms, plain_ms,
                  library_ms, nbytes, colsum_flops(b, t, h, dh, causal),
                  "bfloat16", representative)
    del q, k, want, got, sets


def check_packed(torch, checks: Checks, g, wname: str, kk: int, nn: int,
                 bits: int, ms_: tuple, representative=None,
                 arch: str = ARCH) -> None:
    """``quant_matmul`` with bf16 x against its plain version at one
    projection (kk -> nn, an RTN weight drawn from ``g``, group GROUP) for
    each m in ``ms_``; ``representative`` maps an m to its row's key."""
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    timer = checks.timer
    pw, w_bf16 = rtn_packed(torch, g, kk, nn, bits)
    for m in ms_:
        x = torch.randn((m, kk), generator=g, device="cuda").to(
            torch.bfloat16)
        want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                                bits=bits, group_size=GROUP)
        got = quant_matmul(x, pw)
        pws = packed_sets(checks, x, pw)
        ms = timer.ms(lambda a=a: quant_matmul(*a) for a in pws)
        plain_ms = timer.ms(lambda a=a: quant_matmul_ref(
            a[0], a[1].w_packed, a[1].scale, a[1].zero, bits=bits,
            group_size=GROUP) for a in pws)
        libs = checks.clones((x, w_bf16), m * kk * 2 + kk * nn * 2
                             + m * nn * 2)
        library_ms = timer.ms(lambda a=a: a[0] @ a[1] for a in libs)
        checks.record("quant_matmul",
                      {"arch": arch, "weight": wname, "m": m, "k": kk,
                       "n": nn, "bits": bits}, got, want, TOL_BF16, ms,
                      plain_ms, library_ms, qmm_bytes(x, pw),
                      2.0 * m * nn * kk, "bfloat16",
                      (representative or {}).get(m, False))
        del pws, libs


def check_fp32_long_rows(torch, checks: Checks, g) -> None:
    """``quant_matmul``'s fp32 form (``qmm_tc_f32``) over wd's 14336-long
    rows (n 4096, m 256, 3 bits, x and W >= 0 so that every partial sum
    grows), in groups of GROUP and in one group for the whole row (gs -1,
    the per-tensor fallback), held to its plain version at 1e-5: no
    tensor-core sum spans more than one 128-row tile.  Untimed."""
    from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
    from repro_torch.kernels.quant_matmul.ops import (pack_weight,
                                                      quant_matmul)
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    kk, nn, m = 14336, 4096, SERVE_BATCH * PROMPT_LEN
    x = torch.randn((m, kk), generator=g, device="cuda").abs()
    w = (torch.randn((kk, nn), generator=g, device="cuda")
         * kk ** -0.5).abs()
    for gs in (GROUP, -1):
        spec = QuantSpec(bits=BITS, group_size=gs)
        _, qc, sc, zr = quantize_weight_rtn(w, spec)
        pw = pack_weight(qc, sc, zr, spec)
        want = quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero, bits=BITS,
                                group_size=pw.group_size)
        rel = errors(quant_matmul(x, pw), want)[1]
        shape = {"weight": "wd", "m": m, "k": kk, "n": nn, "bits": BITS,
                 "gs": gs, "x": "float32, >= 0"}
        log({"check": {"name": "quant_matmul", "shape": shape,
                       "rel_err": rel, "tol": TOL_FP32}})
        if not rel <= TOL_FP32:
            checks.bad.append(f"quant_matmul {shape}: rel err {rel:.3g} > "
                              f"{TOL_FP32}")
        del pw, qc, sc, zr, want


def check_moe_kernels(torch, checks: Checks) -> None:
    """Phase 2, the MoE slice, at deepseek-v2-236b's widths: the batched
    ``gram`` over a calibration batch's expert buffers (E 160 experts of
    MOE_CAP_CALIB slots, bf16 as the bf16 path captures them, d 5120 for
    the wi / wu stack and 1536 for wd), one launch for the stack, each
    matrix against its plain version (compared 16 experts at a time: the
    160 x 5120² fp32 stack is 16.8 GB); and the expert-stack
    ``quant_matmul`` (E 160, 3-bit, group 128, bf16 x; wi / wu 5120 ->
    1536 and wd 1536 -> 5120) at the decode capacity (m 8) and the
    calibration's (m 96), one launch for all experts."""
    check_expert_kernels(torch, checks, seed=5, arch=MOE_ARCH, e=MOE_E,
                         n=MOE_CAP_CALIB, d_model=MOE_D, d_ff=MOE_F,
                         capacities=(MOE_CAP_DECODE, MOE_CAP_CALIB), key="")


def check_expert_kernels(torch, checks: Checks, *, seed: int, arch: str,
                         e: int, n: int, d_model: int, d_ff: int,
                         capacities: tuple, key: str) -> None:
    """``check_moe_kernels`` at one model's widths: the batched ``gram``
    over E expert buffers of n slots at d_model and d_ff, and the
    expert-stack ``quant_matmul`` (d_model -> d_ff and d_ff -> d_model) at
    each capacity m of ``capacities``.  Representative rows are keyed
    ``gram_experts_{key}d{d}`` and ``quant_matmul_experts_{key}{w}_m{m}``.
    The plain ``gram`` is compared a few experts at a time (at most 4 GB
    of fp32 Hessians)."""
    from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.gram.ref import weighted_gram_ref
    from repro_torch.kernels.quant_matmul.ops import (pack_weight,
                                                      quant_matmul)
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    timer = checks.timer
    for d in (d_model, d_ff):
        x = torch.randn((e, n, d), generator=g, device=dev).to(torch.bfloat16)
        r = torch.rand((e, n), generator=g, device=dev)
        before = weighted_gram.launches
        got = weighted_gram(x, r)
        torch.cuda.synchronize()
        if weighted_gram.launches != before + 1:
            checks.bad.append(f"batched gram (E {e}, d {d}) took "
                              f"{weighted_gram.launches - before} launches")
        diff = peak = 0.0
        step = max(1, min(16, (4 << 30) // (4 * d * d)))
        for c in range(0, e, step):
            want = weighted_gram_ref(x[c:c + step], r[c:c + step])
            diff = max(diff, float((got[c:c + step] - want).abs().max()))
            peak = max(peak, float(want.abs().max()))
            if not torch.equal(got[c:c + step],
                               got[c:c + step].transpose(1, 2)):
                checks.bad.append(f"batched gram (E {e}, d {d}) is not "
                                  f"bitwise symmetric")
            del want
        # x and r read once, the (E, d, d) accumulators read and written
        nbytes = e * (n * d * 2 + n * 4 + 2 * d * d * 4)
        ms = timer.ms([lambda: weighted_gram(x, r, out=got, alpha=2.0)],
                      iters=10)
        plain_ms = timer.ms([lambda: weighted_gram_ref(x, r)], iters=4)
        xr = x.float() * r[..., None]
        library_ms = timer.ms([lambda: torch.bmm(xr.transpose(1, 2), xr)],
                              iters=4)
        del xr, got
        torch.cuda.empty_cache()
        # the six bf16 term products of each triangle, as the 2-D row
        checks.record("gram", {"arch": arch, "E": e, "n": n, "d": d,
                               "x": "bfloat16"},
                      (diff, diff / max(peak, 1e-30)), None, TOL_FP32, ms,
                      plain_ms, library_ms, nbytes,
                      6.0 * e * n * d * (d + 1), "bfloat16",
                      f"gram_experts_{key}d{d}")
        del x, r
    spec = QuantSpec(bits=BITS, group_size=GROUP)
    for wname, (kk, nn) in (("wi/wu", (d_model, d_ff)),
                            ("wd", (d_ff, d_model))):
        parts, deq = [], []
        for _ in range(e):  # an RTN stack, packed expert by expert
            w = torch.randn((kk, nn), generator=g, device=dev) * kk ** -0.5
            wq, qc, sc, zr = quantize_weight_rtn(w, spec)
            parts.append(pack_weight(qc, sc, zr, spec))
            deq.append(wq.to(torch.bfloat16))
        pw = dataclasses.replace(
            parts[0], w_packed=torch.stack([p.w_packed for p in parts]),
            scale=torch.stack([p.scale for p in parts]),
            zero=torch.stack([p.zero for p in parts]))
        w_bf16 = torch.stack(deq)
        del parts, deq
        for m in capacities:
            x = torch.randn((e, m, kk), generator=g, device=dev).to(
                torch.bfloat16)
            want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale,
                                    pw.zero, bits=BITS, group_size=GROUP,
                                    d_in=kk)
            before = quant_matmul.launches
            got = quant_matmul(x, pw)
            torch.cuda.synchronize()
            if quant_matmul.launches != before + 1:
                checks.bad.append(f"expert-stack quant_matmul ({wname}, m "
                                  f"{m}) took more than one launch")
            ms = timer.ms([lambda: quant_matmul(x, pw)])
            plain_ms = timer.ms([lambda: quant_matmul_ref(
                x, pw.w_packed, pw.scale, pw.zero, bits=BITS,
                group_size=GROUP, d_in=kk)], iters=4)
            library_ms = timer.ms([lambda: torch.bmm(x, w_bf16)])
            nbytes = (x.numel() + e * m * nn) * 2 + pw.nbytes
            checks.record("quant_matmul",
                          {"arch": arch, "weight": f"experts/{wname}",
                           "E": e, "m": m, "k": kk, "n": nn, "bits": BITS},
                          got, want, TOL_BF16, ms, plain_ms, library_ms,
                          nbytes, 2.0 * e * m * nn * kk, "bfloat16",
                          f"quant_matmul_experts_{key}{wname}_m{m}")
            del x, want, got
        del pw, w_bf16
        torch.cuda.empty_cache()


def check_variant_kernels(torch, checks: Checks) -> None:
    """Phase 2, this slice's shapes against the plain versions:
    ``quant_matmul`` at VARIANT_QMM (decode m 4 and prefill m 256), ``gram``
    at VARIANT_GRAM, the three GQA attention kernels at VARIANT_KV's heads
    (kv8 and kv2, the paged decode bitwise the flat one) and
    ``attn_colsum`` at VARIANT_COLSUM's."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(7)
    for arch, wname, kk, nn in VARIANT_QMM:
        check_packed(torch, checks, g, wname, kk, nn, BITS,
                     (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN), arch=arch)
    torch.cuda.empty_cache()
    for arch, d in VARIANT_GRAM:
        check_gram(torch, checks, g, d, False, arch=arch)
    for arch, kv, grp in VARIANT_KV:
        check_kv_kernels(torch, checks, kv, grp, arch)
    for h, kv in VARIANT_COLSUM:
        check_colsum(torch, checks, g, CALIB_BATCH, CALIB_SEQ, h, kv, 128,
                     False)
        torch.cuda.empty_cache()


def check_hybrid_kernels(torch, checks: Checks) -> None:
    """Phase 2, the hybrid slice's new shapes at jamba-v0.1-52b's widths:
    ``quant_matmul`` at its Mamba projections HYB_QMM (decode m 4 and
    prefill m 256; ``wbc``'s 32 and ``wdt``'s 128 columns are narrower
    than a column tile), and ``check_expert_kernels`` at E 16: ``gram``
    over HYB_CAP_CALIB slots at d 4096 and 14336 (a 13.2 GB stack of
    Hessians), the stacks' ``quant_matmul`` at the decode capacity (m 8)
    and a 4 x 64 prefill's (m 40).  Its GQA block's kernels run at
    llama3-8b's shapes (H 32 / 8, Dh 128), checked in the first slice."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(8)
    for wname, kk, nn in HYB_QMM:
        check_packed(torch, checks, g, wname, kk, nn, BITS,
                     (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN),
                     {SERVE_BATCH: f"quant_matmul_hybrid_{wname}",
                      SERVE_BATCH * PROMPT_LEN:
                      f"quant_matmul_prefill_hybrid_{wname}"},
                     arch=HYB_ARCH)
    torch.cuda.empty_cache()
    check_expert_kernels(torch, checks, seed=9, arch=HYB_ARCH, e=HYB_E,
                         n=HYB_CAP_CALIB, d_model=HYB_D, d_ff=HYB_F,
                         capacities=(HYB_CAP_DECODE, HYB_CAP_PREFILL),
                         key="hybrid_")


def check_hadamard(torch, checks: Checks) -> None:
    """Phase 2, ``fwht`` (no path of the system runs it: ``core/rotation``
    applies dense Hadamard matrices): ``hadamard_transform`` against its
    plain version (the torch butterfly) at HADAMARD_SHAPES, fp32 and bf16,
    with Q_m from the port's own generator.  The representative row is the
    pure FWHT at (2048, 4096) fp32; the yardstick for the power-of-two
    widths is the dense fp32 product ``x @ H_d`` (cuBLAS) that
    ``core/rotation`` applies today."""
    from repro_torch.core.rotation import random_orthogonal
    from repro_torch.device import generator
    from repro_torch.kernels.hadamard.ops import hadamard_transform
    from repro_torch.kernels.hadamard.ref import (hadamard_matrix,
                                                  hadamard_transform_ref,
                                                  pow2_factor)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    q_gen = generator(SEED, dev)
    timer, record, clones = checks.timer, checks.record, checks.clones
    for rows, d in HADAMARD_SHAPES:
        k2, m = pow2_factor(d)
        q_m = random_orthogonal(q_gen, m) if m > 1 else None
        for dtype, tol in ((torch.float32, TOL_FP32),
                           (torch.bfloat16, TOL_BF16)):
            x = torch.randn((rows, d), generator=g, device=dev).to(dtype)
            want = hadamard_transform_ref(x, q_m)
            got = hadamard_transform(x, q_m)
            nbytes = 2 * rows * d * x.element_size()  # read x, write y
            # one add per value per butterfly stage, and the Q_m product
            flops = rows * d * (math.log2(k2) + (2 * m if m > 1 else 0))
            sets = clones((x,), nbytes)
            ms = timer.ms(lambda a=a: hadamard_transform(a[0], q_m)
                          for a in sets)
            plain_ms = timer.ms(lambda a=a: hadamard_transform_ref(a[0], q_m)
                                for a in sets)
            library_ms = None
            if m == 1 and dtype == torch.float32:
                h = hadamard_matrix(d).to(dev)
                library_ms = timer.ms(lambda a=a: a[0] @ h for a in sets)
                del h
            record("fwht", {"op": "hadamard_transform", "n": rows, "d": d,
                            "m": m, "dtype": str(dtype).split(".")[-1]},
                   got, want, tol, ms, plain_ms, library_ms, nbytes, flops,
                   "float32", d == 4096 and dtype == torch.float32)
            del x, want, got, sets
    torch.cuda.empty_cache()


def solve_inputs(torch, g, n: int, block: int, d_out: int):
    """N blocks of rows drawn from ``g`` and the diagonal U tiles of
    Hessians 2·XᵀX of features of uneven scale, all on the card."""
    from repro_torch.core.gptq import hinv_cholesky, prepare_hessian

    dev = torch.device("cuda")
    wb = torch.randn((n, block, d_out), generator=g, device=dev)
    x = torch.randn((n, 4 * block, block), generator=g, device=dev)
    x = x * torch.rand((n, 1, block), generator=g, device=dev)
    ub = torch.stack([hinv_cholesky(prepare_hessian(2.0 * xi.T @ xi))
                      for xi in x])
    return wb, ub


def host_ms(torch, fn, reps: int = 2) -> float:
    """Wall ms per call of ``fn`` after a synchronize on each side (for the
    plain in-block loop: its ~1.5k launches a call are too many to replay
    from a CUDA graph in ``Timer``'s cycles of cold copies)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def solve_bytes(n: int, block: int, d_out: int) -> int:
    """``solve_block``'s least traffic: read the block's rows and U tile,
    write q, deq and err."""
    return n * ((block * d_out + block * block) + 3 * block * d_out) * 4


def solve_block_ms(checks: Checks, wb, ub, spec, rows: int = GROUP) -> float:
    """ms per ``solve_block`` call (one block, ``rows`` a group) from
    ``Timer`` over cold copies of (wb, ub), with the ``repro_torch`` that
    is on sys.path."""
    from repro_torch.kernels.gptq_block.ops import solve_block

    n, block, d_out = wb.shape
    sets = checks.clones((wb, ub), solve_bytes(n, block, d_out))
    return checks.timer.ms(lambda a=a: solve_block(a[0], a[1], spec, rows)
                           for a in sets)


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel: {registers, spill_store_bytes, stack_frame_bytes}}
    from an ``nvcc -Xptxas -v`` log."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        found = {key: re.search(pattern, chunk) for key, pattern in (
            ("registers", r"Used (\d+) registers"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("stack_frame_bytes", r"(\d+) bytes stack frame"))}
        out[name] = {key: int(m.group(1)) if m else None
                     for key, m in found.items()}
    return out


def sass_functions(lib: Path) -> dict:
    """{mangled kernel: [(address, instruction text), ...]} from
    ``cuobjdump -sass`` of a built library (cuobjdump from nvcc's
    toolkit)."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _sass_regs(token: str, width: int = 1) -> list:
    out = []
    for m in SASS_REG.finditer(token):
        name, wide = m.group(1), m.group(2)
        prefix = name.rstrip("0123456789")
        first = int(name[len(prefix):])
        n = 2 if wide else width
        out += [f"{prefix}{first + i}" for i in range(n)]
    return out


def _branch_target(text: str):
    m = re.search(r"\bBRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def loop_chain_cycles(instrs: list):
    """The longest dependent path through one pass of a kernel's largest
    loop after its first barrier (the rows' round loop, past staging), in
    cycles of SASS_LATENCY, every register a value of the chain, issue
    width and memory ignored.  A forward branch to inside the loop is
    taken when the code it skips is cold (it holds a CALL, an fp64
    reciprocal or a butterfly shuffle: a group's first row, a division's
    slow path); any other branch is not.  Returns (cycles, instructions in
    the loop), or (None, 0) if no loop is found."""
    start = next(k for k, (_, t) in enumerate(instrs)
                 if t.startswith("BAR.SYNC"))
    index = {addr: k for k, (addr, _) in enumerate(instrs)}
    loops = [(index[tgt], k) for k, (addr, t) in enumerate(instrs[start:],
                                                            start)
             if (tgt := _branch_target(t)) is not None and tgt <= addr
             and tgt in index and index[tgt] > start]
    if not loops:
        return None, 0
    first, last = max(loops, key=lambda lk: lk[1] - lk[0])
    ready: dict = {}
    longest, k = 0, first
    while k < last:
        text = instrs[k][1]
        guard = []
        if text.startswith("@"):
            g, text = text.split(None, 1)
            guard = _sass_regs(g)
        op, _, rest = text.partition(" ")
        base = op.split(".")[0]
        target = _branch_target(text) if base == "BRA" else None
        if target is not None and target in index and \
                k < index[target] <= last and any(
                    t.split()[int(t.startswith("@"))] in SASS_COLD
                    for _, t in instrs[k + 1:index[target]]):
            k = index[target]
            continue
        ops = [o.strip() for o in rest.split(",")] if rest else []
        ndest = 0 if base in SASS_NO_DEST or not ops else 1
        if ndest and len(ops) > 1 and (
                base.endswith("SETP") or base == "SHFL" or
                (base in ("IADD3", "LEA") and ".X" not in op and
                 re.fullmatch(r"U?P\d", ops[1]))):
            ndest = 2
        parts = op.split(".")
        width = 4 if "128" in parts else 2 if ("64" in parts or
                                               "WIDE" in parts) else 1
        dests = [r for o in ops[:ndest] for r in _sass_regs(o, width)]
        srcs = guard + [r for o in ops[ndest:] for r in _sass_regs(o)]
        done = max((ready.get(r, 0) for r in srcs), default=0) + \
            SASS_LATENCY.get(base, 4)
        for r in dests:
            ready[r] = done
        if dests:
            longest = max(longest, done)
        k += 1
    return longest, last - first + 1


def max_sm_mhz() -> float:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.strip().splitlines()[0])


def solve_instances() -> dict:
    """{(R, every_row): {kernel, registers, spills, chain}} of every built
    instance of ``gptq_block_kernel<R, EVERY_ROW>``: registers from this
    run's ptxas log; from the library's SASS, the chain of one round of
    SOLVE_CHUNK R rows (the loop of its widest phase) and from it one
    row's."""
    from repro_torch.kernels import build

    regs = ptxas_kernels(build.ptxas_report("gptq_block"))
    out = {}
    for name, instrs in sass_functions(build._target("gptq_block")).items():
        m = re.search(r"gptq_block_kernelILi(\d+)ELb([01])E", name)
        if m:
            lanes, every_row = int(m.group(1)), m.group(2) == "1"
            cycles, body = loop_chain_cycles(instrs)
            out[(lanes, every_row)] = {
                "kernel": f"gptq_block_kernel<{lanes}, "
                          f"{str(every_row).lower()}>",
                **regs.get(name, {}), "sass_instructions": len(instrs),
                "round_instructions": body, "round_chain_cycles": cycles,
                "row_chain_cycles": None if cycles is None
                else cycles / (SOLVE_CHUNK * lanes)}
    return out


def check_gptq_block(torch, checks: Checks) -> None:
    """Phase 2, GPTQ's in-block solve (``solve_block``, no Pallas
    counterpart: the reference's XLA compiles the loop): bitwise against
    its plain loop on the card at SOLVE_SHAPES (3-bit, group 128, sym,
    timed; ``wd`` the representative row), then over every bit width,
    group and sym / asym at ``wk``'s block, and one whole llama3-8b ``wk``
    solve (4096 x 1024) on the kernel against the same solve on the plain
    loop."""
    from repro_torch.core import gptq
    from repro_torch.core.quantizer import QuantSpec
    from repro_torch.kernels.gptq_block.kernel import plan
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gptq_block.ref import (solve_block_ref,
                                                    solver_params,
                                                    subnormal_tie_inputs)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    names = ("q", "deq", "err", "scale", "zero")
    instances = solve_instances()
    for inst in instances.values():
        log({"gptq_block_instance": inst})
    mhz = max_sm_mhz()

    def bitwise(tag, got, want) -> None:
        for name, a, b in zip(names, got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                checks.bad.append(f"solve_block {tag}: {name} differs from "
                                  f"the plain loop")

    main = QuantSpec(bits=BITS, group_size=GROUP)
    block = 128
    for wname, (n, d_out) in SOLVE_SHAPES.items():
        wb, ub = solve_inputs(torch, g, n, block, d_out)
        got = solve_block(wb, ub, main, GROUP)
        want = solve_block_ref(wb, ub, main, GROUP)
        bitwise(wname, got, want)
        # per column: the later rows' update (a product and a difference
        # each) and the row's ~8 quantize steps
        flops = n * d_out * (block * (block - 1) + 8 * block)
        ms = solve_block_ms(checks, wb, ub, main)
        plain_ms = host_ms(torch, lambda: solve_block_ref(wb, ub, main,
                                                          GROUP))
        # what a row costs, measured: the slope from the same columns' first
        # 64 rows (one group) to all 128, in cycles of the card's highest
        # SM clock
        ms_64 = solve_block_ms(checks, wb[:, :64].contiguous(),
                               ub[:, :64, :64].contiguous(), main, 64)
        # beside it the chain bound of the instance this shape runs, an
        # estimate: one row's dependent path reckoned from its SASS with
        # the latencies SASS_LATENCY assumes, x the block's rows
        how = plan(n, block, d_out, GROUP, False)
        inst = instances[(how["lanes"], how["every_row"])]
        row_chain = inst["row_chain_cycles"]
        checks.record("solve_block", {"weight": wname, "N": n,
                                      "block": block, "d_out": d_out},
                      got[1], want[1], 0.0, ms, plain_ms, None,
                      solve_bytes(n, block, d_out), flops, "float32",
                      wname == "wd", plan=how, instance=inst["kernel"],
                      registers=inst["registers"],
                      spill_store_bytes=inst["spill_store_bytes"],
                      ms_block_64=ms_64,
                      row_cycles_measured=(ms - ms_64) / (block - 64)
                      * mhz * 1e3,
                      chain_estimate_row_cycles=row_chain,
                      chain_estimate_ms=None if row_chain is None
                      else block * row_chain / (mhz * 1e3),
                      max_sm_mhz=mhz)
        del wb, ub, got, want

    wb, ub = solve_inputs(torch, g, 1, block, 1024)
    for bits in (2, 3, 4, 8):
        for group in (32, 64, 128, -1):
            for sym in (True, False):
                spec = QuantSpec(bits=bits, group_size=group, sym=sym)
                fixed = None if group > 0 else solver_params(
                    torch.randn((1, 4096, 1024), generator=g, device=dev),
                    spec)
                rows = group if group > 0 else block
                bitwise(f"wk bits {bits} group {group} sym {sym}",
                        solve_block(wb, ub, spec, rows, fixed),
                        solve_block_ref(wb, ub, spec, rows, fixed))

    # errors exactly halfway between two fp32 subnormals, which a division
    # through the fp64 reciprocal would round the other way: at R 8 and
    # R 1, a group's own scale and a fixed one
    for d_out in (4096, 32768):
        wb, ub = (t.to(dev) for t in subnormal_tie_inputs(block, d_out))
        for sym, rows, scale in ((True, 128, None), (False, 32, None),
                                 (True, 128, 1000.0)):
            spec = QuantSpec(bits=3 if sym else 4, group_size=rows, sym=sym)
            fixed = None if scale is None else (
                torch.full((1, d_out), scale, device=dev),
                torch.full((1, d_out), 4.0, device=dev))
            bitwise(f"subnormal ties d_out {d_out} sym {sym} rows {rows} "
                    f"fixed {scale}", solve_block(wb, ub, spec, rows, fixed),
                    solve_block_ref(wb, ub, spec, rows, fixed))

    # one whole solve: kernel against the plain loop (the rest is the same
    # torch code), llama3-8b's wk with a Hessian of uneven features
    w = torch.randn((4096, 1024), generator=g, device=dev) * 4096 ** -0.5
    x = torch.randn((2048, 4096), generator=g, device=dev)
    x = x * torch.rand((1, 4096), generator=g, device=dev)
    h = 2.0 * x.T @ x
    t0 = time.perf_counter()
    got = gptq.gptq_quantize(w, h, main)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    gptq.solve_block = solve_block_ref
    try:
        t0 = time.perf_counter()
        want = gptq.gptq_quantize(w, h, main)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        gptq.solve_block = solve_block
    same = {k: bool(torch.equal(got[k], want[k])) for k in got}
    log({"gptq_solve_check": {"weight": "wk", "d_in": 4096, "d_out": 1024,
                              "bitwise": same, "kernel_s": kernel_s,
                              "plain_loop_s": plain_s,
                              "proxy_loss": float(got["err"])}})
    if not all(same.values()):
        checks.bad.append(f"gptq_quantize on solve_block differs from the "
                          f"plain loop: {same}")
    del w, x, h, got, want

    # where one solve's time goes: llama3-8b's wd (14336 x 4096: 112
    # launches, the Cholesky factor and inverse at d 14336, the deferred
    # products), warm, under the profiler
    w = torch.randn((14336, 4096), generator=g, device=dev) * 14336 ** -0.5
    x = torch.randn((CALIB_BATCH * CALIB_SEQ, 14336), generator=g,
                    device=dev)
    h = 2.0 * x.T @ x
    del x
    gptq.gptq_quantize(w, h, main)
    before = solve_block.launches
    prof, _ = profile_engine(torch, lambda: gptq.gptq_quantize(w, h, main))
    log({"gptq_solve_profile": {"weight": "wd", "d_in": 14336,
                                "d_out": 4096, "launches":
                                solve_block.launches - before, **prof}})
    del w, h
    torch.cuda.empty_cache()


def gqa_decode_inputs(torch, g, bits: int, kv: int = FD_KV,
                      grp: int = FD_G, dh: int = FD_DH,
                      s: int = FD_S) -> dict:
    """Phase 2's decode inputs at llama3-8b's heads (or ``kv`` KV heads of
    ``grp`` query heads each, of ``dh``): a flat kv``bits`` cache (B 4,
    S 8192 or ``s``, KV 8, Dh 128) of random keys and values drawn from
    ``g``, a scaled query group (G 4) and pos = S - 37, plus the same codes
    in paged pools through a shuffled table with one trash column (page
    0)."""
    from repro_torch.models.attention import kv_codec

    dev = torch.device("cuda")
    b, page = FD_B, 64
    n_tiles = s // page
    codec = kv_codec(bits, page)
    kq, ks = codec.encode(torch.randn((b, s, kv, dh), generator=g,
                                      device=dev))
    vq, vs = codec.encode(torch.randn((b, s, kv, dh), generator=g,
                                      device=dev))
    q = torch.randn((b, kv, grp, dh), generator=g, device=dev) * dh ** -0.5
    pos = torch.full((b,), s - FD_TAIL, dtype=torch.int32, device=dev)
    perm = torch.randperm(b * n_tiles, generator=torch.Generator()
                          .manual_seed(2)) + 1
    tbl = perm.reshape(b, n_tiles).to(torch.int32)
    pools = []
    for codes, scales in ((kq, ks), (vq, vs)):
        cp = torch.zeros((b * n_tiles + 1, page) + codes.shape[2:],
                         dtype=codes.dtype, device=dev)
        sp = torch.zeros((b * n_tiles + 1, page // codec.chunk, kv),
                         dtype=scales.dtype, device=dev)
        cp[perm.to(dev)] = codes.reshape(cp[1:].shape)
        sp[perm.to(dev)] = scales.reshape(sp[1:].shape)
        pools += [cp, sp]
    tbl = torch.cat([tbl, torch.zeros((b, 1), dtype=torch.int32)],
                    1).to(dev)
    return {"codec": codec, "page": page, "q": q, "pos": pos,
            "flat": (kq, ks, vq, vs), "tbl": tbl, "pools": pools}


def gqa_extend_inputs(torch, g, bits: int, kv: int = FD_KV,
                      grp: int = FD_G) -> dict:
    """Phase 2's extend inputs: an L 256 chunk of bf16 q / k_new / v_new
    (H 32 / KV 8, or ``kv`` x ``grp`` / ``kv``; Dh 128, as the model passes
    them) over 16 full past pages in shuffled order."""
    from repro_torch.models.attention import kv_codec

    dev = torch.device("cuda")
    dh, page, h = FD_DH, 64, kv * grp
    L, n_past = FE_L, FE_PAST
    n_pages = n_past + 1
    codec = kv_codec(bits, page)
    kq, ks = codec.encode(torch.randn((1, n_pages * page, kv, dh),
                                      generator=g, device=dev))
    vq, vs = codec.encode(torch.randn((1, n_pages * page, kv, dh),
                                      generator=g, device=dev))
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape(n_pages, page // codec.chunk, kv),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape(n_pages, page // codec.chunk, kv)]
    tbl = (torch.randperm(n_past, generator=torch.Generator()
                          .manual_seed(3)) + 1).to(torch.int32).to(dev)
    q, k_new, v_new = (torch.randn(shp, generator=g, device=dev).to(
        torch.bfloat16) for shp in ((1, L, h, dh), (1, L, kv, dh),
                                    (1, L, kv, dh)))
    return {"codec": codec, "page": page, "tbl": tbl, "q": q,
            "k_new": k_new, "v_new": v_new, "pools": pools,
            "ekw": dict(kv_bits=bits, chunk=codec.chunk, dh=dh, dv=dh,
                        page=page)}


def check_kv_kernels(torch, checks: Checks, kv: int = FD_KV,
                     grp: int = FD_G, arch: str = ARCH, dh: int = FD_DH,
                     s: int = FD_S, extend: bool = True) -> None:
    """Phase 2, quantized-KV slice: flat and paged flash decode (kv8, kv2)
    at B 4, S 8192, KV 8, G 4, Dh 128 (or ``arch``'s ``kv`` x ``grp``
    heads of ``dh`` over ``s`` positions; only llama3-8b's rows represent
    the kernels), pos = S - 37, the
    paged call through a shuffled page table with a trash entry and held
    bitwise to the flat call; then (``extend``) the chunked-prefill extend
    at L 256 over 16 past pages.  The yardstick is
    ``scaled_dot_product_attention`` (GQA) on the cache already
    dequantized to bf16; the dequantization is not timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      paged_flash_decode,
                                                      paged_flash_extend)
    from repro_torch.kernels.flash_decode.ref import (dequant_kv,
                                                      flash_decode_ref,
                                                      paged_flash_decode_ref,
                                                      paged_flash_extend_ref)

    dev = torch.device("cuda")
    main = arch == ARCH
    g = torch.Generator(device=dev).manual_seed(1 if main else kv + grp)
    timer, record, clones = checks.timer, checks.record, checks.clones
    b = FD_B
    h = kv * grp
    pos_v = s - FD_TAIL

    def finalized(acc, l):
        return acc / l.clamp_min(1e-30)

    def dequantized(codes, scales, codec, rows):
        """(B, S, KV, w) codes -> the first ``rows`` as (B, KV, rows, D)
        bf16, for the yardstick."""
        x = dequant_kv(codes.transpose(1, 2), scales.transpose(1, 2),
                       kv_bits=codec.kv_bits, chunk=codec.chunk, d=dh)
        return x[:, :, :rows].to(torch.bfloat16).contiguous()

    for bits in KV_BITS:
        di = gqa_decode_inputs(torch, g, bits, kv, grp, dh, s)
        codec, page, q, pos = di["codec"], di["page"], di["q"], di["pos"]
        kq, ks, vq, vs = di["flat"]
        kw = dict(kv_bits=bits, chunk=codec.chunk, dv=dh)
        rows = pos_v + 1
        code_b = kq[0, 0, 0].numel() * kq.element_size()
        scale_rows = -(-rows // codec.chunk)
        nbytes = (2 * b * kv * (rows * code_b + scale_rows * 2)
                  + 2 * q.numel() * 4)
        flops = 4.0 * b * h * rows * dh
        cache_b = 2 * (kq.numel() * kq.element_size() + ks.numel() * 2)
        shape = {"arch": arch, "kv_bits": bits, "B": b, "S": s, "KV": kv,
                 "G": grp, "Dh": dh, "pos": pos_v}

        # flat
        rkw = dict(kv_bits=bits, chunk=codec.chunk, dh=dh, dv=dh)
        want = finalized(*flash_decode_ref(q, kq, ks, vq, vs, pos, tile=page,
                                           **rkw)[::2])
        flat = flash_decode(q, kq, ks, vq, vs, pos, tile=page, **kw)
        sets = clones((q, kq, ks, vq, vs, pos), cache_b)
        ms = timer.ms(lambda a=a: flash_decode(*a, tile=page, **kw)
                      for a in sets)
        plain_ms = timer.ms((lambda a=a: flash_decode_ref(
            *a, tile=page, **rkw) for a in sets), iters=len(sets))
        sdpa = [(a[0].reshape(b, h, 1, dh).to(torch.bfloat16) * dh ** 0.5,
                 dequantized(a[1], a[2], codec, rows),
                 dequantized(a[3], a[4], codec, rows)) for a in sets]
        library_ms = timer.ms(lambda a=a: F.scaled_dot_product_attention(
            *a, enable_gqa=True) for a in sdpa)
        del sdpa
        record("flash_decode", shape, flat, want, TOL_KV, ms, plain_ms,
               library_ms, nbytes, flops, "float32", main and bits == 8)

        # paged: the same codes through a shuffled table + a trash entry
        tbl, pools = di["tbl"], di["pools"]
        want = finalized(*paged_flash_decode_ref(tbl, pos, q, *pools,
                                                 page=page, **rkw)[::2])
        got = paged_flash_decode(tbl, pos, q, *pools, page=page, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, flat):
            checks.bad.append(f"paged_flash_decode kv{bits} ({arch}): not "
                              f"bitwise equal to flash_decode at tile = "
                              f"page")
        log({"paged_equals_flat": {"arch": arch, "kv_bits": bits,
                                   "bitwise": bool(torch.equal(got, flat))}})
        sets = clones((tbl, pos, q) + tuple(pools), cache_b)
        ms = timer.ms(lambda a=a: paged_flash_decode(*a, page=page, **kw)
                      for a in sets)
        plain_ms = timer.ms((lambda a=a: paged_flash_decode_ref(
            *a, page=page, **rkw) for a in sets), iters=len(sets))
        record("paged_flash_decode", dict(shape, table="shuffled + trash"),
               got, want, TOL_KV, ms, plain_ms, library_ms, nbytes, flops,
               "float32", main and bits == 8)
        del kq, ks, vq, vs, pools, sets, flat, got, want, di
        torch.cuda.empty_cache()
        if not extend:
            continue

        # extend: an L-token chunk over FE_PAST past pages, bf16 inputs
        xi = gqa_extend_inputs(torch, g, bits, kv, grp)
        L, n_past = FE_L, FE_PAST
        tbl, q, k_new, v_new = xi["tbl"], xi["q"], xi["k_new"], xi["v_new"]
        pools, ekw = xi["pools"], xi["ekw"]
        want = paged_flash_extend_ref(tbl, q, k_new, v_new, *pools, **ekw)
        got = paged_flash_extend(tbl, q, k_new, v_new, *pools, **ekw)
        past_rows = n_past * page
        nbytes = (2 * kv * (past_rows * code_b
                            + -(-past_rows // codec.chunk) * 2)
                  + (q.numel() + k_new.numel() + v_new.numel()) * 2
                  + L * h * dh * 4)
        # the function's least work, in bf16 tensor-core operations: Q.K^T
        # once (bf16 queries and keys, codes exact in bf16), P.V at the
        # cheapest fp32-accurate rate (three bf16 terms at 989 TFLOP/s
        # beat two TF32 terms at 495)
        flops = (1 + 3) * 2.0 * h * dh * L * (past_rows + (L + 1) / 2)
        sets = clones((tbl, q, k_new, v_new) + tuple(pools), nbytes)
        ms = timer.ms(lambda a=a: paged_flash_extend(*a, **ekw)
                      for a in sets)
        plain_ms = timer.ms((lambda a=a: paged_flash_extend_ref(
            *a, **ekw) for a in sets), iters=len(sets))
        mask = torch.ones((L, past_rows + L), dtype=torch.bool, device=dev)
        mask[:, past_rows:] = torch.ones((L, L), dtype=torch.bool,
                                         device=dev).tril()

        def past_kv(codes, scales, a):
            flat_c = codes[a[0].long()].reshape(1, past_rows, kv, -1)
            flat_s = scales[a[0].long()].reshape(1, -1, kv)
            return dequantized(flat_c, flat_s, codec, past_rows)

        sdpa = [(a[1].transpose(1, 2),
                 torch.cat([past_kv(a[4], a[5], a),
                            a[2].transpose(1, 2)], 2).contiguous(),
                 torch.cat([past_kv(a[6], a[7], a),
                            a[3].transpose(1, 2)], 2).contiguous())
                for a in sets]
        library_ms = timer.ms(lambda a=a: F.scaled_dot_product_attention(
            *a, attn_mask=mask, enable_gqa=True) for a in sdpa)
        record("paged_flash_extend",
               {"arch": arch, "kv_bits": bits, "L": L, "n_past": n_past,
                "H": h, "KV": kv, "Dh": dh}, got, want, TOL_KV, ms, plain_ms,
               library_ms, nbytes, flops, "bfloat16", main and bits == 8)
        del pools, sets, sdpa, got, want, xi
        torch.cuda.empty_cache()


def mla_extend_inputs(torch, g, bits: int) -> dict:
    """Phase 2's MLA extend inputs at deepseek-v3's widths: latent and rope
    pages (kv``bits``, page 64) drawn from ``g``, ME_PAST of them in
    shuffled order, an L = ME_L chunk's scaled fp32 queries (H 128) and its
    own fp32 latents."""
    from repro_torch.models.attention import kv_codec

    dev = torch.device("cuda")
    h, dl, dr, page = MLA_H, MLA_DL, MLA_DR, 64
    L, n_past = ME_L, ME_PAST
    n_pages = n_past + 1
    codec = kv_codec(bits, page)
    cq, cs = codec.encode(torch.randn((1, n_pages * page, dl), generator=g,
                                      device=dev))
    rq, rs = codec.encode(torch.randn((1, n_pages * page, dr), generator=g,
                                      device=dev))
    pools = [cq.reshape(n_pages, page, -1), cs.reshape(n_pages, -1),
             rq.reshape(n_pages, page, -1), rs.reshape(n_pages, -1)]
    tbl = (torch.randperm(n_past, generator=torch.Generator()
                          .manual_seed(3)) + 1).to(torch.int32).to(dev)
    ql = torch.randn((L, h, dl), generator=g, device=dev) * (dl + dr) ** -0.5
    qr = torch.randn((L, h, dr), generator=g, device=dev) * (dl + dr) ** -0.5
    c_new = torch.randn((L, dl), generator=g, device=dev)
    r_new = torch.randn((L, dr), generator=g, device=dev)
    return {"codec": codec, "page": page, "tbl": tbl, "ql": ql, "qr": qr,
            "c_new": c_new, "r_new": r_new, "pools": pools,
            "ekw": dict(kv_bits=bits, chunk=codec.chunk, dl=dl, dr=dr,
                        page=page)}


def latent_bf16(torch, codes, scales, codec, d: int, rows: int):
    """(B, S, w) latent codes -> their first ``rows`` rows dequantized,
    (B, rows, d) bf16: the SDPA yardstick's keys and values."""
    from repro_torch.kernels.flash_decode.ref import dequant_kv

    return dequant_kv(codes, scales, kv_bits=codec.kv_bits,
                      chunk=codec.chunk, d=d)[:, :rows].to(torch.bfloat16)


def mla_decode_inputs(torch, g, bits: int, positions) -> dict:
    """Phase 2's MLA latent decode inputs at deepseek-v3's widths: a flat
    cache of B = len(positions) requests and S rows (the last position
    rounded up to a page of 64), kv``bits`` codes of unit normals drawn
    from ``g``, scaled fp32 queries (H 128); the same codes in pools of
    pages under a shuffled table with a trash entry past every position;
    ``flat`` and ``paged`` the two wrappers' positional arguments; the
    bytes the call must move (the live codes and scales, queries, output)
    and its least operations at the cheapest fp32-accurate tensor-core
    rate: Q.K^T and P.V each have one fp32 operand and one exact one
    (codes), three bf16 terms at 989 TFLOP/s (row 10's count)."""
    from repro_torch.models.attention import kv_codec

    dev = torch.device("cuda")
    h, dl, dr, page = MLA_H, MLA_DL, MLA_DR, 64
    b = len(positions)
    s = -(-(max(positions) + 1) // page) * page
    n_tiles = s // page
    codec = kv_codec(bits, page)
    cq, cs = codec.encode(torch.randn((b, s, dl), generator=g, device=dev))
    rq, rs = codec.encode(torch.randn((b, s, dr), generator=g, device=dev))
    ql = torch.randn((b, h, dl), generator=g, device=dev) * (dl + dr) ** -0.5
    qr = torch.randn((b, h, dr), generator=g, device=dev) * (dl + dr) ** -0.5
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    perm = torch.randperm(b * n_tiles, generator=torch.Generator()
                          .manual_seed(5)) + 1
    pools = []
    for codes, scales in ((cq, cs), (rq, rs)):
        cp = torch.zeros((b * n_tiles + 1, page, codes.shape[-1]),
                         dtype=codes.dtype, device=dev)
        sp = torch.zeros((b * n_tiles + 1, page // codec.chunk),
                         dtype=scales.dtype, device=dev)
        cp[perm.to(dev)] = codes.reshape(b * n_tiles, page, -1)
        sp[perm.to(dev)] = scales.reshape(b * n_tiles, -1)
        pools += [cp, sp]
    tbl = torch.cat([perm.reshape(b, n_tiles).to(torch.int32),
                     torch.zeros((b, 1), dtype=torch.int32)], 1).to(dev)
    row_b = (cq[0, 0].numel() * cq.element_size()
             + rq[0, 0].numel() * rq.element_size())
    rows = [p + 1 for p in positions]
    nbytes = (sum(r * row_b + 2 * -(-r // codec.chunk) * 2 for r in rows)
              + (ql.numel() + qr.numel()) * 4 + b * h * dl * 4)
    return {"codec": codec, "page": page, "rows": rows,
            "flat": (ql, qr, cq, cs, rq, rs, pos),
            "paged": (tbl, pos, ql, qr, *pools),
            "kw": dict(kv_bits=bits, chunk=codec.chunk, dl=dl, dr=dr),
            "cache_b": sum(a.numel() * a.element_size()
                           for a in (cq, cs, rq, rs)),
            "nbytes": nbytes,
            "flops": 3 * 2.0 * h * sum(rows) * (dl + dr + dl),
            "shape": {"kv_bits": bits, "B": b, "S": s, "H": h, "dl": dl,
                      "dr": dr, "pos": list(positions)}}


def check_mla_decode(torch, checks: Checks, g, bits: int, positions,
                     representative: bool) -> None:
    """Phase 2's rows 8 and 9 at one shape (``mla_decode_inputs``): flat
    and paged against their plain versions, paged bitwise equal to flat.
    Yardstick: ``scaled_dot_product_attention`` (one KV head,
    ``enable_gqa``, key [c, r] and value c of the live rows dequantized to
    bf16 beforehand, untimed; past each request's position masked)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode.ops import (mla_flash_decode,
                                                      paged_mla_flash_decode)
    from repro_torch.kernels.flash_decode.ref import (
        mla_flash_decode_ref, paged_mla_flash_decode_ref)

    timer, record, clones = checks.timer, checks.record, checks.clones
    di = mla_decode_inputs(torch, g, bits, positions)
    page, kw, codec = di["page"], di["kw"], di["codec"]
    rows = max(di["rows"])
    shape = di["shape"]

    acc, _, l = mla_flash_decode_ref(*di["flat"], tile=page, **kw)
    want = acc / l.clamp_min(1e-30)
    flat = mla_flash_decode(*di["flat"], tile=page, **kw)
    sets = clones(di["flat"], di["cache_b"])
    ms = timer.ms(lambda a=a: mla_flash_decode(*a, tile=page, **kw)
                  for a in sets)
    plain_ms = timer.ms((lambda a=a: mla_flash_decode_ref(
        *a, tile=page, **kw) for a in sets), iters=len(sets))
    live = (torch.arange(rows, device=flat.device)[None]
            <= di["flat"][6][:, None])[:, None, None]   # (B, 1, 1, rows)
    sdpa = []
    for a in sets:
        c16 = latent_bf16(torch, a[2], a[3], codec, MLA_DL, rows)
        r16 = latent_bf16(torch, a[4], a[5], codec, MLA_DR, rows)
        sdpa.append((torch.cat([a[0], a[1]], -1)[:, :, None].to(
            torch.bfloat16), torch.cat([c16, r16], -1)[:, None],
            c16[:, None].contiguous()))
    library_ms = timer.ms(lambda a=a: F.scaled_dot_product_attention(
        *a, attn_mask=live, scale=1.0, enable_gqa=True) for a in sdpa)
    del sdpa
    record("mla_flash_decode", shape, flat, want, TOL_KV, ms, plain_ms,
           library_ms, di["nbytes"], di["flops"], "bfloat16",
           representative)

    acc, _, l = paged_mla_flash_decode_ref(*di["paged"], page=page, **kw)
    want = acc / l.clamp_min(1e-30)
    got = paged_mla_flash_decode(*di["paged"], page=page, **kw)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got, flat))
    if not bitwise:
        checks.bad.append(f"paged_mla_flash_decode kv{bits} {shape['pos']}: "
                          f"not bitwise equal to mla_flash_decode at tile = "
                          f"page")
    log({"paged_equals_flat": {"kernel": "paged_mla_flash_decode",
                               "kv_bits": bits, "pos": shape["pos"],
                               "bitwise": bitwise}})
    sets = clones(di["paged"], di["cache_b"])
    ms = timer.ms(lambda a=a: paged_mla_flash_decode(*a, page=page, **kw)
                  for a in sets)
    plain_ms = timer.ms((lambda a=a: paged_mla_flash_decode_ref(
        *a, page=page, **kw) for a in sets), iters=len(sets))
    record("paged_mla_flash_decode", dict(shape, table="shuffled + trash"),
           got, want, TOL_KV, ms, plain_ms, library_ms, di["nbytes"],
           di["flops"], "bfloat16", representative)
    del di, sets, flat, got, want
    torch.cuda.empty_cache()


def check_mla_kernels(torch, checks: Checks) -> None:
    """Phase 2, MLA slice, at deepseek-v3's shapes: the absorb
    (``quant_matmul_t``) and expand (head-batched ``quant_matmul``) steps on
    the per-head views of one packed wkv_b (H 128, m 4, 2/3/4/8 bits, group
    128), and both on a prefill chunk (fp32 x, m = ENGINE_CHUNK: the fp32
    tile ``qmm_t_tile`` and the tensor-core tile's fp32 form
    ``qmm_tc_f32``); the bf16 prefill projections (m 256 and 512, 3 bits:
    the tensor-core tile); the latent flash decode (kv8, kv2) at H 128,
    latent 512, rope 64, flat and through a shuffled page table with a
    trash entry (held bitwise to the flat call), at B 4, S 8192, pos = S -
    37 and at the engine's 4 slots at positions 512-575
    (``check_mla_decode``); the chunked-prefill extend at L 256 over 16
    past pages.  Yardsticks: ``torch.bmm`` on the dequantized bf16
    per-head weights; ``scaled_dot_product_attention`` (one KV head,
    ``enable_gqa``, key [c, r] and value c, dequantized to bf16
    beforehand, untimed); for the projections and the prefill chunks the
    product with the dequantized weight (bf16 and fp32)."""
    import torch.nn.functional as F

    from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
    from repro_torch.kernels.flash_decode.ops import paged_mla_flash_extend
    from repro_torch.kernels.flash_decode.ref import \
        paged_mla_flash_extend_ref
    from repro_torch.kernels.quant_matmul.ops import (mla_latent_weights,
                                                      pack_weight,
                                                      quant_matmul,
                                                      quant_matmul_t)
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_ref,
                                                      quant_matmul_t_ref)
    from repro_torch.models.attention import kv_codec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    timer, record, clones = checks.timer, checks.record, checks.clones
    h, dn, dv, dl, dr = MLA_H, MLA_DN, MLA_DV, MLA_DL, MLA_DR
    m = SERVE_BATCH

    # absorb and expand: one launch for all heads on strided views; the
    # decode step (m = serve batch) and both on one prefill chunk
    for bits in (2, 3, 4, 8):
        spec = QuantSpec(bits=bits, group_size=GROUP)
        w = torch.randn((dl, h * (dn + dv)), generator=g, device=dev) \
            * dl ** -0.5
        _, qc, sc, zr = quantize_weight_rtn(w, spec)
        pw = pack_weight(qc, sc, zr, spec)
        del w, qc, sc, zr
        pw_k, pw_v = mla_latent_weights(pw, h, dn, dv)
        rows = {"absorb": (pw_k, dn, dl, m), "expand": (pw_v, dl, dv, m),
                "expand prefill": (pw_v, dl, dv, ENGINE_CHUNK),
                "absorb prefill": (pw_k, dn, dl, ENGINE_CHUNK)}
        for step, (pv, d_in, d_out, rows_m) in rows.items():
            x = torch.randn((h, rows_m, d_in), generator=g, device=dev)
            absorb = step.startswith("absorb")
            if absorb:
                fn, name = quant_matmul_t, "quant_matmul_t"
                plain = quant_matmul_t_ref
            else:
                fn, name = quant_matmul, "quant_matmul"
                plain = quant_matmul_ref
            want = plain(x, pv.w_packed, pv.scale, pv.zero, bits=bits,
                         group_size=GROUP, d_in=dl)
            got = fn(x, pv)
            view_b = sum(a.numel() * a.element_size()
                         for a in (pv.w_packed, pv.scale, pv.zero))
            nbytes = view_b + x.numel() * 4 + h * rows_m * d_out * 4
            sets = clones((x, pw.w_packed, pw.scale, pw.zero), nbytes)

            def views(a, step=step):
                full = dataclasses.replace(pw, w_packed=a[1], scale=a[2],
                                           zero=a[3])
                return mla_latent_weights(full, h, dn, dv)[
                    0 if step.startswith("absorb") else 1]

            pws = [(a[0], views(a)) for a in sets]
            ms = timer.ms(lambda a=a: fn(*a) for a in pws)
            plain_ms = timer.ms(lambda a=a: plain(
                a[0], a[1].w_packed, a[1].scale, a[1].zero, bits=bits,
                group_size=GROUP, d_in=dl) for a in pws)
            wdeq = quant_matmul_ref(torch.eye(dl, device=dev).expand(h, dl,
                                                                     dl),
                                    pv.w_packed, pv.scale, pv.zero,
                                    bits=bits, group_size=GROUP, d_in=dl)
            # per-head weight as the product multiplies it: bf16 for the
            # decode steps, fp32 (the same function) for the prefill chunk
            lib_t = torch.float32 if rows_m > m else torch.bfloat16
            wb = (wdeq.transpose(1, 2) if absorb else
                  wdeq).to(lib_t).contiguous()
            libs = clones((x.to(lib_t), wb),
                          (x.numel() + wb.numel()) * wb.element_size())
            library_ms = timer.ms(lambda a=a: torch.bmm(*a) for a in libs)
            key = {"absorb": "quant_matmul_t",
                   "absorb prefill": "quant_matmul_t_prefill",
                   "expand prefill": "quant_matmul_prefill_fp32"}.get(step)
            # the function's least work at the cheapest fp32-accurate
            # tensor-core rate, as row 10's: each product has one fp32
            # operand (x, or x times each (group, column)'s scale) and one
            # exact one (code - zero, an integer: check_zero), so three
            # bf16 terms at 989 TFLOP/s beat two TF32 terms at 495 (and the
            # fp32 pipes' 67).  The decode steps stay bound by bytes.
            record(name, {"weight": f"wkv_b {step}", "H": h, "m": rows_m,
                          "k": d_in, "n": d_out, "bits": bits}, got, want,
                   TOL_FP32, ms, plain_ms, library_ms, nbytes,
                   3 * 2.0 * h * rows_m * d_in * d_out, "bfloat16",
                   bits == BITS and key)
            del sets, pws, libs, wdeq, wb, x
        del pw, pw_k, pw_v
    torch.cuda.empty_cache()

    # the bf16 prefill projections of a dense layer (tensor-core tile):
    # wkv_a's 576 columns are not a multiple of the 128-column tile
    proj = {"wq_a": (7168, 1536), "wq_b": (1536, h * (dn + dr)),
            "wkv_a": (7168, dl + dr), "wo": (h * dv, 7168),
            "wi/wu": (7168, 18432), "wd": (18432, 7168)}
    # the decode (m = serve batch) too on the narrow ones, wq_a and wkv_a
    for wname, (kk, nn) in proj.items():
        check_packed(torch, checks, g, wname, kk, nn, BITS,
                     QMM_M if wname in ("wq_a", "wkv_a") else QMM_M[1:],
                     arch=MLA_ARCH)
    torch.cuda.empty_cache()

    page = 64
    for bits in KV_BITS:
        codec = kv_codec(bits, page)
        kw = dict(kv_bits=bits, chunk=codec.chunk, dl=dl, dr=dr)
        # rows 8 and 9: B 4, S 8192 (the kernels line's rows), the engine's
        for name, positions in MD_SHAPES.items():
            check_mla_decode(torch, checks, g, bits, positions,
                             bits == 8 and name == "B4_S8192")

        # extend: an L-token chunk over ME_PAST past pages
        L, n_past = ME_L, ME_PAST
        xi = mla_extend_inputs(torch, g, bits)
        tbl, ql, qr, c_new, r_new = (xi[k] for k in ("tbl", "ql", "qr",
                                                     "c_new", "r_new"))
        pools = xi["pools"]
        ekw = dict(kw, page=page)
        row_b = sum(p[0, 0].numel() * p.element_size()
                    for p in (pools[0], pools[2]))
        want = paged_mla_flash_extend_ref(tbl, ql, qr, c_new, r_new, *pools,
                                          **ekw)
        got = paged_mla_flash_extend(tbl, ql, qr, c_new, r_new, *pools, **ekw)
        past_rows = n_past * page
        nbytes = (past_rows * row_b + 2 * (past_rows // codec.chunk) * 2
                  + (ql.numel() + qr.numel() + c_new.numel()
                     + r_new.numel()) * 4 + L * h * dl * 4)
        # the function's least work at the cheapest fp32-accurate tensor-
        # core rate: Q.K^T and P.V each have one fp32 operand and one exact
        # one (codes), so three bf16 terms at 989 TFLOP/s beat two TF32
        # terms at 495 (and the fp32 pipes' 67); the own latents' extra
        # term pairs are not counted.  A tensor-core kernel then never
        # reads faster than its bound.
        flops = 3 * 2.0 * L * h * (past_rows + (L + 1) / 2) * (dl + dr + dl)
        sets = clones((tbl, ql, qr, c_new, r_new) + tuple(pools), nbytes)
        ms = timer.ms(lambda a=a: paged_mla_flash_extend(*a, **ekw)
                      for a in sets)
        plain_ms = timer.ms((lambda a=a: paged_mla_flash_extend_ref(
            *a, **ekw) for a in sets), iters=len(sets))
        mask = torch.ones((L, past_rows + L), dtype=torch.bool, device=dev)
        mask[:, past_rows:] = torch.ones((L, L), dtype=torch.bool,
                                         device=dev).tril()
        sdpa = []
        for a in sets:
            pid = a[0].long()
            c16 = torch.cat([latent_bf16(
                torch, a[5][pid].reshape(1, past_rows, -1),
                a[6][pid].reshape(1, -1), codec, dl, past_rows),
                a[3][None].to(torch.bfloat16)], 1)
            r16 = torch.cat([latent_bf16(
                torch, a[7][pid].reshape(1, past_rows, -1),
                a[8][pid].reshape(1, -1), codec, dr, past_rows),
                a[4][None].to(torch.bfloat16)], 1)
            sdpa.append((torch.cat([a[1], a[2]], -1).transpose(0, 1)[None]
                         .to(torch.bfloat16).contiguous(),
                         torch.cat([c16, r16], -1)[:, None].contiguous(),
                         c16[:, None].contiguous()))
        library_ms = timer.ms(lambda a=a: F.scaled_dot_product_attention(
            *a, attn_mask=mask, scale=1.0, enable_gqa=True) for a in sdpa)
        record("paged_mla_flash_extend",
               {"kv_bits": bits, "L": L, "n_past": n_past, "H": h, "dl": dl,
                "dr": dr}, got, want, TOL_KV, ms, plain_ms, library_ms,
               nbytes, flops, "bfloat16", bits == 8)
        del xi, tbl, pools, sets, sdpa, got, want, ql, qr, c_new, r_new
        torch.cuda.empty_cache()


def check_solves(torch, entries: dict, proxy_card: dict, *, arch=ARCH,
                 n_layers=N_LAYERS, paths=SOLVE_CHECK) -> dict:
    """A path's layer-0 GPTQ solves against the same solves on the host
    CPU.  The card's came from Hessians built by the ``attn_colsum`` and
    ``gram`` kernels and from GPTQ with ``torch.linalg`` on the card; the
    CPU rebuilds layer 0's rotated weights and calibration inputs from the
    same seed and solves with the plain versions.  Each weight must keep
    MIN_CODE_MATCH of its codes, its proxy loss and its Hessian-weighted
    output error tr(ΔᵀHΔ) within TOL_PROXY of the CPU's, and that output
    error must be smaller than round-to-nearest's.  For MLA's wkv_b, and
    for GQA weights of the mixer alone, the CPU runs only the attention
    half of ``capture_block`` (the checked weights' inputs and the AttnCon
    scores of q and k): the FFN half feeds no checked weight.  A Mamba
    block's capture has no scores: AttnCon falls back to ActNorm, as in the
    pipeline."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig
    from repro_torch.core.rotation import rotate_model
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.launch.quantize import model_config
    from repro_torch.models import attention as att
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.lm import Model, capture_block

    def cpu_caps(blk, cfg, x_b):
        mixer_only = all(p.startswith("mixer/") for p in paths)
        if cfg.attn_kind == "gqa" and mixer_only:
            h = rms_norm(x_b, blk["mixer_norm"], cfg.norm_eps)
            q, k, _ = att.gqa_qkv(blk["mixer"], cfg, h,
                                  torch.arange(x_b.shape[1]))
            return {f"mixer/{w}": h for w in ("wq", "wk", "wv")}, \
                attn_colsum(q, k)
        if cfg.attn_kind != "mla":
            _, caps, _, colsum = capture_block(blk, cfg, x_b)
            return caps, colsum
        h = rms_norm(x_b, blk["mixer_norm"], cfg.norm_eps)
        q, k, _, c_kv, _, _ = att.mla_qkv_inputs(
            blk["mixer"], cfg, h, torch.arange(x_b.shape[1]))
        return {"mixer/wkv_b": c_kv}, attn_colsum(q, k)

    t0 = time.perf_counter()
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED)
    cfg = model_config(arch, n_layers, "float32")
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
        caps, colsum = cpu_caps(blk, cfg, x_b)
        r = attn_con(ImportanceInputs(z_in=x_b, attn_colsum=colsum),
                     r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
        for path in paths:
            x_c = caps[path]
            hs[path] = hess.accumulate(hs.get(path),
                                       x_c.reshape(-1, x_c.shape[-1]), r)
    rows, bad = {}, []
    for path in paths:
        sub, name = path.split("/")
        rows[path] = solve_row(torch, blk[sub][name], hs[path],
                               entries[f"layer0/{path}"], proxy_card[path],
                               rsq, path, bad)
    torch.cuda.empty_cache()
    log({"solve_check": {"arch": arch, "layer": 0, "weights": rows,
                         "seconds": time.perf_counter() - t0,
                         "min_code_match": MIN_CODE_MATCH,
                         "tol_proxy": TOL_PROXY}})
    if bad:
        fail("GPTQ on the card disagrees with the CPU: " + "; ".join(bad))
    return rows


def profile_engine(torch, run) -> tuple[dict, object]:
    """Device time by kernel over one traced engine run (``run()``), the
    summed device-busy time, the traced run's own wall clock and its idle
    share (1 - busy / that wall): the ten largest kernels (``top``) and
    every kernel of the port's own sources (``port``), with ``run()``'s
    result.  The profiler lists the kernels that a CUDA graph's replay
    launches (on the H100, a replayed decode and the same steps launched
    from Python list the same kernels and busy time).  The profiler slows
    the host, so the caller reports the untraced run's wall beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [{"name": ev.key[:60], "ms": ev.self_device_time_total / 1e3,
             "calls": ev.count} for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    return {"device_busy_ms": busy, "traced_wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms, "top": rows[:10],
            "port": [r for r in rows if "anonymous namespace" in r["name"]]
            }, result


class KvAudit:
    """Holds a path's attention kernels (and MLA's absorb step) to their
    plain versions on the main path's own calls, at the shapes, positions
    and page tables the runs give them (a flat cache whose last split holds
    one tile, a different position per slot, inactive slots whose table
    rows point at the trash page, extend with n_past = 0 and > 0).  Each
    wrapper is replaced in ``models.attention`` by one that calls it, so its
    launch count moves as before, and that keeps a copy of a sampled call's
    inputs (the caches and pools are written in place by later steps) with
    its result.  ``settle()`` runs the plain versions on the copies after
    each run, outside its timing; the copies are device-to-device, a few
    per sampled call.  No call is sampled while ``label`` is None.

    Under a captured decode loop (``runtime.graphs``) the wrapper runs once,
    at the capture, so its copies are nodes of the graph: every replay
    copies the sampled calls' inputs again and the kernel writes their
    outputs again, and ``settle()`` holds the last replay's inputs against
    that replay's output (``graph_checked``).  A copy from a graph that was
    captured but never replayed holds nothing and is dropped."""

    GQA = ("flash_decode", "paged_flash_decode", "paged_flash_extend")
    MLA = ("quant_matmul_t", "mla_flash_decode", "paged_mla_flash_decode",
           "paged_mla_flash_extend")

    def __init__(self, torch, att, names):
        from repro_torch.kernels.flash_decode import ref
        from repro_torch.kernels.quant_matmul.ref import quant_matmul_t_ref

        def flash_plain(q, kq, ks, vq, vs, pos, *, kv_bits, chunk, dv, tile):
            acc, _, l = ref.flash_decode_ref(
                q, kq, ks, vq, vs, pos, kv_bits=kv_bits, chunk=chunk,
                dh=q.shape[-1], dv=dv, tile=tile)
            return acc / l.clamp_min(1e-30)

        def paged_plain(tbl, pos, q, kq, ks, vq, vs, *, kv_bits, chunk, dv,
                        page):
            acc, _, l = ref.paged_flash_decode_ref(
                tbl, pos, q, kq, ks, vq, vs, kv_bits=kv_bits, chunk=chunk,
                dh=q.shape[-1], dv=dv, page=page)
            return acc / l.clamp_min(1e-30)

        def mla_plain(*args, **kw):
            acc, _, l = ref.mla_flash_decode_ref(*args, **kw)
            return acc / l.clamp_min(1e-30)

        def paged_mla_plain(*args, **kw):
            acc, _, l = ref.paged_mla_flash_decode_ref(*args, **kw)
            return acc / l.clamp_min(1e-30)

        def absorb_plain(x, pw):
            return quant_matmul_t_ref(x, pw.w_packed, pw.scale, pw.zero,
                                      bits=pw.bits,
                                      group_size=pw.group_size, d_in=pw.d_in)

        plain = {"flash_decode": flash_plain,
                 "paged_flash_decode": paged_plain,
                 "paged_flash_extend": ref.paged_flash_extend_ref,
                 "mla_flash_decode": mla_plain,
                 "paged_mla_flash_decode": paged_mla_plain,
                 "paged_mla_flash_extend": ref.paged_mla_flash_extend_ref,
                 "quant_matmul_t": absorb_plain}
        self.torch, self.att, self.names = torch, att, names
        self.plain = {name: plain[name] for name in names}
        # fp32 products (absorb) and attention on the same dequantized terms
        self.tol = {name: TOL_FP32 if name == "quant_matmul_t" else TOL_KV
                    for name in names}
        self.real = {name: getattr(att, name) for name in names}
        self.label = None
        self.calls: dict = {}
        self.pending: list = []
        self.rows = {name: {"checked": 0, "graph_checked": 0,
                            "max_abs_err": 0.0, "max_rel_err": 0.0,
                            "runs": []}
                     for name in names}
        self.n_past: set = set()
        self.bad: list = []
        self.capturing = None  # the Replay whose region is being captured

    def install(self) -> None:
        from repro_torch.runtime.graphs import Replay

        for name in self.names:
            setattr(self.att, name, self._wrap(name))
        self.real_ready = Replay.ready

        def ready(replay):
            self.capturing = replay
            try:
                return self.real_ready(replay)
            finally:
                self.capturing = None
        Replay.ready = ready

    def restore(self) -> None:
        from repro_torch.runtime.graphs import Replay

        for name, fn in self.real.items():
            setattr(self.att, name, fn)
        Replay.ready = self.real_ready

    def _wrap(self, name):
        real, torch = self.real[name], self.torch

        def audited(*args, **kw):
            out = real(*args, **kw)
            if self.label is not None:
                key = (name, self.label)
                i = self.calls[key] = self.calls.get(key, -1) + 1
                if i < AUDIT_FIRST or i % AUDIT_EVERY == 0:
                    kept = tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args)
                    owner = (self.capturing if
                             torch.cuda.is_current_stream_capturing()
                             else None)
                    self.pending.append((name, self.label, kept, kw, out,
                                         owner))
            return out
        return audited

    def settle(self) -> None:
        for name, label, args, kw, got, owner in self.pending:
            if owner is not None and owner.replays == 0:
                continue  # captured, never replayed: nothing was computed
            want = self.plain[name](*args, **kw)
            abs_err, rel_err = errors(got, want)
            row = self.rows[name]
            row["checked"] += 1
            row["graph_checked"] += owner is not None
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)
            row["max_rel_err"] = max(row["max_rel_err"], rel_err)
            if label not in row["runs"]:
                row["runs"].append(label)
            if name.endswith("_extend"):
                self.n_past.add(int(args[0].shape[0]))
            if not rel_err <= self.tol[name]:
                self.bad.append(f"{name} ({label}): rel err {rel_err:.3g} "
                                f"> {self.tol[name]} against its plain "
                                f"version")
        self.pending = []

    def report(self) -> dict:
        out = {name: dict(row) for name, row in self.rows.items()}
        extend = [n for n in self.names if n.endswith("_extend")][0]
        out[extend]["n_past"] = sorted(self.n_past)
        out["tol"] = self.tol
        return out


class FinalChunks:
    """A lossy paged chunked prefill: each request's final-chunk logits
    from the card against the same ``Model.paged_extend_step`` with the
    extend kernel replaced by its plain version, on copies of the pools
    taken before the call (the engine writes the chunk's pages right after
    it).  The copies are kept and the step re-run in ``settle()``, after
    the engine run, outside its timing; ``logits_of`` hands back a
    request's final-chunk logits by its prompt."""

    def __init__(self, model):
        self.model = model
        self.step = model.paged_extend_step
        self.kept: list = []
        model.paged_extend_step = self._keep  # this instance only

    def _keep(self, params, tokens, start, state, *, t_total, last,
              pools=None, page_tbl=None):
        copies = None
        if last and state is None:
            copies = ([{k: v.clone() for k, v in c.items()} for c in pools],
                      page_tbl.clone())
        logits, cc = self.step(params, tokens, start, state, t_total=t_total,
                               last=last, pools=pools, page_tbl=page_tbl)
        if copies is not None:
            self.kept.append((params, tokens, start, t_total, *copies,
                              logits))
        return logits, cc

    def logits_of(self, prompt) -> object:
        """The card's final-chunk logits of the request whose prompt ends
        with the kept chunk's tokens, or None."""
        for _, tokens, _, _, _, _, logits in self.kept:
            tail = tokens[0].tolist()
            if list(prompt[-len(tail):]) == tail:
                return logits
        return None

    def settle(self, att, name, plain_extend) -> dict:
        """Re-run the kept steps with ``att.<name>`` (the extend kernel's
        wrapper) replaced by ``plain_extend``."""
        del self.model.paged_extend_step
        kernel = getattr(att, name)
        setattr(att, name, plain_extend)
        worst, same = 0.0, 0
        try:
            for params, tokens, start, t_total, pools, tbl, got in self.kept:
                want, _ = self.step(params, tokens, start, None,
                                    t_total=t_total, last=True, pools=pools,
                                    page_tbl=tbl)
                worst = max(worst, errors(got, want)[1])
                same += int(got.argmax(-1).eq(want.argmax(-1)).all())
        finally:
            setattr(att, name, kernel)
        return {"requests": len(self.kept), "max_rel_err": worst,
                "argmax_equal": same, "tol": TOL_CHUNK_LOGITS}


def kv_path(torch, art: Path, *, arch: str, n_layers: int, audit_names,
            lossy_paged_bits=(2,), kv_bits=KV_BITS, modes=ENGINE_MODES,
            overload: bool = True, traced_modes=TRACED_MODES,
            params=None) -> None:
    """The quantized-KV serving path of one artifact (loaded once,
    keep-packed, unless the caller hands its loaded ``params`` over), for
    each of ``kv_bits`` (kv8 and kv2):
    ``launch.serve.generate`` through the flat quantized cache (batch 4,
    prompt 1024, 32 new tokens, after a 2-token warm-up), then the
    ``Engine`` on a Poisson trace of 8 requests (prompt 512, budgets 16-64,
    the last one sampled) in each admission mode of ``modes``.  The fp
    materializers of the cache count their calls throughout, and
    ``KvAudit`` holds sampled calls of ``audit_names``
    (``KvAudit.GQA`` or ``KvAudit.MLA``) of every run to their plain
    versions.  The paged chunked prefill reads earlier chunks back from
    their codes; at ``lossy_paged_bits`` its first tokens are not held to
    solo ``generate``'s: there each request's final-chunk logits are held
    to the plain extend's (``FinalChunks``), and a first token may differ
    from solo ``generate``'s only where solo's two best logits lie within
    twice the largest difference between the two runs' logits (closer
    than that, the lossy read may flip them; farther, it cannot).  Each
    mode's requests run again under overload (``<mode>_overload``), and the
    whole mode with a burst fault (``whole_fault``) and a shedding queue
    (``whole_shed``); see ``overload_runs`` (unless ``overload`` is
    False).  The first bit width's engine runs again under the profiler in
    ``traced_modes`` (``<mode>_profile``).  The caller counts the
    launches.

    Decode runs in the captured loops (``loop="graph"``): ``generate``'s
    graphs are held to one capture per key, each engine to its two
    (greedy, sampled), captured when it is built; the batch-4 ``generate``
    and kv8's whole-prompt engine run again with ``loop="python"``
    (``loop_pair``), which must give the same tokens and launches."""
    import numpy as np

    from repro_torch.checkpoint.packed import load_packed_forward_params
    from repro_torch.kernels.flash_decode import ref
    from repro_torch.launch import serve
    from repro_torch.launch.quantize import model_config
    from repro_torch.models import attention as att
    from repro_torch.models.lm import Model
    from repro_torch.serving import (Engine, SamplingParams, ServeRequest,
                                     poisson_trace, run_trace)

    extend = [n for n in audit_names if n.endswith("_extend")][0]
    plain_extend = getattr(ref, f"{extend}_ref")
    fp_calls: list = []
    real = {name: getattr(att, name)
            for name in ("kv_dequantize", "kv_log_decode")}

    def guard(name):
        def counting(*a, **k):
            fp_calls.append(name)
            return real[name](*a, **k)
        return counting

    dev = torch.device("cuda")
    bad, report = [], {}
    n = ENGINE_REQUESTS
    audit = KvAudit(torch, att, audit_names)
    try:
        for name in real:
            setattr(att, name, guard(name))
        audit.install()
        if params is None:
            params, _ = load_packed_forward_params(art, device=dev,
                                                   dtype=torch.bfloat16)
        for bits in kv_bits:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(model_config(arch, n_layers,
                                                   "bfloat16"), kv_bits=bits)
            model = Model(cfg, dev)
            prompts = torch.randint(
                2, cfg.vocab_size, (SERVE_BATCH, KV_PROMPT), device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            audit.label = f"kv{bits} generate"
            serve.generate(model, params, prompts, 2)  # warm-up
            stats = {"graph": {}, "python": {}}
            toks, toks_py, _ = loop_pair(
                torch, lambda loop: serve.generate(
                    model, params, prompts, KV_GEN, stats=stats[loop],
                    loop=loop), f"kv{bits} generate", bad)
            audit.settle()
            st = stats["graph"]
            if toks.shape != (SERVE_BATCH, KV_GEN) or not bool(
                    torch.isfinite(st["first_logits"]).all()):
                bad.append(f"kv{bits} generate: tokens {tuple(toks.shape)} "
                           f"or non-finite logits")
            if not torch.equal(toks, toks_py):
                bad.append(f"kv{bits} generate: the graph loop's tokens "
                           f"differ from the Python loop's")
            cache_b, fp_b = serve.kv_cache_bytes(model, SERVE_BATCH,
                                                 KV_PROMPT + KV_GEN)
            decode = SERVE_BATCH * (KV_GEN - 1)
            row = {"generate": {
                "prefill_tok_s": SERVE_BATCH * KV_PROMPT / st["prefill_s"],
                "decode_tok_s": decode / st["decode_s"],
                "python_decode_tok_s": decode / stats["python"]["decode_s"],
                "capture_s": st["capture_s"],
                "tokens_equal_python_loop": bool(torch.equal(toks, toks_py)),
                "kv_cache_bytes": cache_b, "kv_cache_fp_bytes": fp_b,
                "seconds": time.perf_counter() - t0}}
            t1 = time.perf_counter()
            rng = np.random.default_rng(SEED + bits)
            prompts = rng.integers(2, cfg.vocab_size, (n, ENGINE_PROMPT))
            budgets = [int(x) for x in rng.integers(
                ENGINE_BUDGETS[0], ENGINE_BUDGETS[1] + 1, n)]
            sps = [SamplingParams(temperature=0.8 if i == n - 1 else 0.0,
                                  seed=SEED + i) for i in range(n)]
            audit.label = f"kv{bits} solo generate"
            solo, solo_logits = [], []
            for i in range(n):
                st_i: dict = {}
                solo.append(serve.generate(
                    model, params, torch.tensor(prompts[i:i + 1], device=dev),
                    budgets[i], temperature=sps[i].temperature,
                    seed=sps[i].seed, stats=st_i)[0].tolist())
                solo_logits.append(st_i["first_logits"])
            audit.settle()
            row["solo_generate_s"] = time.perf_counter() - t1
            # one graph a key: the warm-up's, KV_GEN's, and each distinct
            # (budget, sampled) of the solo runs, every one captured once
            keys = {(SERVE_BATCH, KV_PROMPT, 2, False),
                    (SERVE_BATCH, KV_PROMPT, KV_GEN, False)} | {
                (1, ENGINE_PROMPT, budgets[i], sps[i].temperature > 0)
                for i in range(n)}
            captured = [r.captured for r, _ in model.graphs.values()]
            row["generate"]["captures"] = sum(captured)
            if sorted(k[1:] for k in model.graphs) != sorted(keys) or \
                    not all(captured):
                bad.append(f"kv{bits} generate: graphs {sorted(model.graphs)}"
                           f" (captured {captured}), not one for each of "
                           f"{sorted(keys)}")
            need = -(-(ENGINE_PROMPT + ENGINE_BUDGETS[1]) // cfg.kv_chunk)

            def engine_run(chunk, attn, *, n_pages=ENGINE_PAGES,
                           rate=ENGINE_RATE, sampling=sps, submitted=None,
                           loop="graph", traced=False, **overload):
                """run_trace's summary with the engine's ``captures`` and
                ``capture_s``; ``submitted`` (a dict) receives each
                accepted request's id by its index.  The engine captures
                its graphs when it is built, before the trace starts;
                ``traced`` profiles the trace alone (``profile``)."""
                reqs = [ServeRequest(tokens=prompts[i].tolist(),
                                     max_new_tokens=budgets[i],
                                     sampling=sampling[i]) for i in range(n)]
                engine = Engine(model, params, max_slots=ENGINE_SLOTS,
                                n_pages=n_pages,
                                max_pages_per_request=need,
                                burst_steps=ENGINE_BURST,
                                prefill_chunk=chunk, prefill_attn=attn,
                                loop=loop, **overload)
                if submitted is not None:
                    index = {id(r): i for i, r in enumerate(reqs)}
                    accept = engine.submit

                    def submit(req):
                        rid = accept(req)
                        submitted[index[id(req)]] = rid
                        return rid
                    engine.submit = submit
                # run_trace drains and checks that every page came back
                def trace():
                    return run_trace(engine, poisson_trace(reqs, rate=rate,
                                                           seed=SEED))
                prof = None
                if traced:
                    prof, st = profile_engine(torch, trace)
                else:
                    st = trace()
                st.update(events=engine.events.kinds(), profile=prof,
                          **serve.graph_stats(engine.graphs.values()))
                return st

            for mode, chunk, attn in modes:
                t1 = time.perf_counter()
                # the paged prefill reads earlier chunks back from their
                # codes: at lossy_paged_bits its first token need not be
                # solo generate's (see the docstring)
                lossy = bits in lossy_paged_bits and attn == "paged"
                finals = FinalChunks(model) if lossy else None
                audit.label = f"kv{bits} {mode}"
                python = None
                if mode == "whole" and bits == kv_bits[0]:
                    # and the debug loop on the same trace: the same streams
                    st, python, _ = loop_pair(
                        torch, lambda loop: engine_run(chunk, attn,
                                                       loop=loop),
                        f"kv{bits} {mode} engine", bad)
                else:
                    st = engine_run(chunk, attn)
                audit.settle()
                outs = [st["outputs"].get(i) for i in range(n)]
                ok = [o is not None and o.status == "ok"
                      and len(o.tokens) == budgets[i]
                      for i, o in enumerate(outs)]
                first = [bool(ok[i] and outs[i].tokens[0] == solo[i][0])
                         for i in range(n)]
                later = [a == b for i in range(n) if ok[i]
                         for a, b in zip(outs[i].tokens[1:], solo[i][1:])]
                if not all(ok):
                    bad.append(f"kv{bits} {mode}: requests not ok: "
                               f"{[i for i in range(n) if not ok[i]]}")
                if not lossy and not all(first):
                    bad.append(f"kv{bits} {mode}: first token differs from "
                               f"solo generate for requests "
                               f"{[i for i in range(n) if not first[i]]}")
                row[mode] = {
                    k: st[k] for k in (
                        "sustained_tok_s", "ttft_p50_s", "ttft_p99_s",
                        "p50_latency_s", "p99_latency_s", "wall_s",
                        "n_tokens", "rounds", "admission_stall_s",
                        "statuses", "captures", "capture_s")}
                if st["captures"] != 2:
                    bad.append(f"kv{bits} {mode}: {st['captures']} burst "
                               f"graphs captured, not 2 (greedy, sampled)")
                if python is not None:
                    same = sorted(python["outputs"]) == sorted(st["outputs"])\
                        and all(python["outputs"][rid].tokens == o.tokens
                                for rid, o in st["outputs"].items())
                    row[mode]["python_loop"] = {
                        k: python[k] for k in ("sustained_tok_s",
                                               "ttft_p50_s", "ttft_p99_s",
                                               "wall_s", "rounds")}
                    row[mode]["python_loop"]["tokens_equal"] = same
                    if not same:
                        bad.append(f"kv{bits} {mode}: the graph loop's "
                                   f"streams differ from the Python loop's")
                row[mode].update(
                    first_token_match_solo_generate=sum(first) / n,
                    first_token_enforced=not lossy,
                    later_token_agreement=(sum(later) / len(later)
                                           if later else None))
                if finals is not None:
                    flips = []
                    for i in range(n):
                        if first[i] or not ok[i]:
                            continue
                        got = finals.logits_of(prompts[i])
                        if got is None:
                            bad.append(f"kv{bits} {mode}: request {i}'s "
                                       f"final chunk was not kept")
                            continue
                        want = solo_logits[i].float()
                        top2 = want.topk(2, dim=-1).values[0]
                        gap = float(top2[0] - top2[1])
                        delta = float((got.float() - want).abs().max())
                        flips.append({"request": i, "solo_top2_gap": gap,
                                      "max_logit_diff": delta})
                        if not gap <= 2 * delta:
                            bad.append(f"kv{bits} {mode}: request {i}'s "
                                       f"first token differs from solo "
                                       f"generate although its top-2 gap "
                                       f"{gap:.3g} exceeds twice the logit "
                                       f"difference {delta:.3g}")
                    row[mode]["first_token_flips"] = flips
                    fc = finals.settle(att, extend, plain_extend)
                    row[mode]["final_chunk_logits"] = fc
                    if fc["requests"] != n or not (
                            fc["max_rel_err"] <= TOL_CHUNK_LOGITS):
                        bad.append(f"kv{bits} {mode}: final-chunk logits of "
                                   f"{fc['requests']} requests differ from "
                                   f"the plain extend's by "
                                   f"{fc['max_rel_err']:.3g} > "
                                   f"{TOL_CHUNK_LOGITS}")
                row[mode]["seconds"] = time.perf_counter() - t1
                audit.label = None  # the normal run's tokens are the check
                if overload:
                    row.update(overload_runs(
                        mode, engine_run, chunk, attn, sps,
                        [o.tokens if o is not None else None for o in outs],
                        need, bad, f"kv{bits}"))
            if bits == kv_bits[0]:  # traced runs: ~15 s of profiler each
                audit.label = None
                for mode, chunk, attn in modes:
                    if mode not in traced_modes:
                        continue
                    traced = engine_run(chunk, attn, traced=True)["profile"]
                    traced["untraced_wall_ms"] = row[mode]["wall_s"] * 1e3
                    traced["untraced_idle_share"] = 1.0 - (
                        traced["device_busy_ms"] / traced["untraced_wall_ms"])
                    row[f"{mode}_profile"] = traced
            row["seconds"] = time.perf_counter() - t0
            report[f"kv{bits}"] = row
            log({"kv_serve": {"arch": arch, "kv_bits": bits, **row}})
            del model
        del params
        # captured graphs go with their owners (an engine in a reference
        # cycle, as engine_run's submit hook makes, with a collection)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        audit.restore()
        for name, fn in real.items():
            setattr(att, name, fn)
    log({"kv_path": {"arch": arch, "kv_bits": list(kv_bits),
                     "modes": [m[0] for m in modes],
                     "fp_cache_calls": len(fp_calls),
                     "kernel_vs_plain": audit.report(),
                     "engine": {"requests": n, "prompt": ENGINE_PROMPT,
                                "budgets": list(ENGINE_BUDGETS),
                                "slots": ENGINE_SLOTS,
                                "pages": ENGINE_PAGES,
                                "burst": ENGINE_BURST,
                                "prefill_chunk": ENGINE_CHUNK,
                                "arrival_rate": ENGINE_RATE},
                     "overload": overload and {"pages": "2 x one request's",
                                  "arrival_rate": OVER_RATE,
                                  "priority_1": list(OVER_PRIORITY),
                                  "fault": [FAULT_ROUND, "burst"],
                                  "shed": {"queue_depth": SHED_DEPTH,
                                           "arrival_rate": SHED_RATE}}}})
    if fp_calls:
        bad.append(f"the cache was materialized in fp: {sorted(set(fp_calls))}")
    unchecked = [name for name, r in audit.rows.items() if not r["checked"]]
    if unchecked:
        bad.append(f"never held to the plain version on the main path: "
                   f"{unchecked}")
    # the decode kernels run inside the captured loops; the extend in the
    # eager chunked prefill
    unreplayed = [name for name, r in audit.rows.items()
                  if not r["graph_checked"] and not name.endswith("_extend")]
    if unreplayed:
        bad.append(f"never held to the plain version on a graph replay: "
                   f"{unreplayed}")
    if not {0} < audit.n_past:
        bad.append(f"extend checked only at n_past {sorted(audit.n_past)}")
    bad += audit.bad
    if bad:
        fail(f"quantized-KV serving of {arch}: " + "; ".join(bad))


def overload_runs(mode: str, engine_run, chunk, attn, sps, base,
                  need: int, bad: list, tag: str) -> dict:
    """The engine's overload policy on the card, in one admission mode:
    ``engine_run``'s requests again over a pool of ``2 * need`` pages (4
    slots' hot demand twice the pool) at ``OVER_RATE``, ``OVER_PRIORITY``'s
    requests at priority 1.  In the whole mode also with a burst failure
    at ``FAULT_ROUND`` (retried at once) and with a queue of
    ``SHED_DEPTH`` at ``SHED_RATE``.  ``base`` holds each request's tokens
    from the same mode's run at ``ENGINE_PAGES``; every run must give
    them again bit for bit, each request that was not shed having
    finished.  Failures go to ``bad``; returns the rows by run."""
    from repro_torch.runtime.fault import FaultPlan, RetryPolicy

    n = len(sps)
    over_sps = [dataclasses.replace(sp, priority=1) if i in OVER_PRIORITY
                else sp for i, sp in enumerate(sps)]
    runs = {f"{mode}_overload": dict(n_pages=2 * need, rate=OVER_RATE,
                                     sampling=over_sps)}
    if mode == "whole":
        runs["whole_fault"] = dict(
            fault_plan=FaultPlan({(FAULT_ROUND, "burst"): 1}),
            retry=RetryPolicy(backoff_s=0.0))
        runs["whole_shed"] = dict(queue_depth=SHED_DEPTH, rate=SHED_RATE)
    rows = {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        submitted: dict = {}
        st = engine_run(chunk, attn, submitted=submitted, **kw)
        outs = st["outputs"]
        same = [i for i, rid in submitted.items()
                if outs[rid].finished_ok and outs[rid].tokens == base[i]]
        rows[name] = {k: st[k] for k in (
            "statuses", "n_preemptions", "n_preempted_requests", "n_shed",
            "n_requests", "sustained_tok_s", "ttft_p50_s", "ttft_p99_s",
            "p99_latency_s", "wall_s", "rounds", "n_tokens")}
        rows[name].update(events=sorted(set(st["events"])),
                          tokens_equal_full_pool=len(same),
                          submitted=len(submitted),
                          seconds=time.perf_counter() - t0)
        why = []
        if st["n_requests"] != n:
            why.append(f"{st['n_requests']} of {n} requests accounted for")
        if len(same) != len(submitted):
            why.append(f"requests {sorted(set(submitted) - set(same))} did "
                       f"not finish with their full-pool tokens")
        if name.endswith("_overload") and not (
                st["n_preemptions"] >= 1 and st["n_preempted_requests"] >= 1
                and len(submitted) == n):
            why.append(f"no request was preempted ({st['statuses']})")
        if name == "whole_fault" and "burst_retry" not in st["events"]:
            why.append("the injected burst failure was not retried")
        if name == "whole_shed" and not (
                st["n_shed"] >= 1 and len(submitted) + st["n_shed"] == n):
            why.append(f"shed {st['n_shed']} with {len(submitted)} "
                       f"accepted of {n}")
        if why:
            bad.append(f"{tag} {name}: " + "; ".join(why))
    return rows


def solve_row(torch, w, h, e: dict, p_card: float, rsq, tag: str,
              bad: list, noise_floor: bool = True) -> dict:
    """One weight's card solve against the same GPTQ solve on the host CPU
    (``check_solves``' rule): ``w`` (d_in, d_out) and its Hessian ``h``
    on the CPU, ``e`` its artifact entry (the card's codes, scales and
    zeros), ``p_card`` the card's proxy loss.  Appends each failure to
    ``bad`` (prefixed ``tag``) and returns the logged row; with
    ``noise_floor`` the CPU also re-solves after perturbing H by fp32
    summation noise and reports how many codes that alone keeps (a
    diagnostic: it costs a second host solve)."""
    from repro_torch.core.gptq import gptq_quantize
    from repro_torch.core.pipeline import _solve_spec
    from repro_torch.core.quantizer import (dequantize_packed,
                                            quantize_weight_rtn,
                                            unpack_codes, words_from_numpy)

    dev = torch.device("cuda")
    w = w.float()
    d_in = w.shape[0]
    spec, block = _solve_spec(rsq, d_in)  # the pipeline's own
    host = gptq_quantize(w, h, spec, damp=rsq.damp, block=block)
    floor = None
    if noise_floor:
        noise = torch.randn(h.shape, generator=torch.Generator()
                            .manual_seed(SEED))
        rel = 2.0 ** -24 * math.sqrt(N_CALIB * CALIB_SEQ)
        noisy = gptq_quantize(w, h * (1 + rel * 0.5 * (noise + noise.T)),
                              spec, damp=rsq.damp, block=block)
        floor = float((noisy["q"] == host["q"]).float().mean())
        del noise, noisy
    words = words_from_numpy(e["codes"])
    match = float((unpack_codes(words, BITS, d_in) == host["q"]).float()
                  .mean())
    w_card = dequantize_packed(words, torch.from_numpy(e["scale"]),
                               torch.from_numpy(e["zero"]), bits=BITS,
                               d_in=d_in)
    h_dev, w_dev = h.to(dev), w.to(dev)

    def out_err(wq) -> float:  # tr(ΔᵀHΔ), on the card for speed
        delta = w_dev - wq.float().to(dev)
        return float((delta * (h_dev @ delta)).sum())

    p_host = float(host["err"])
    row = {"code_match": match, "code_match_fp32_noise": floor,
           "proxy_card": p_card, "proxy_cpu": p_host,
           "proxy_rel_diff": abs(p_card - p_host) / p_host,
           "out_err_card": out_err(w_card),
           "out_err_cpu": out_err(host["w_deq"]),
           "out_err_rtn": out_err(quantize_weight_rtn(w, spec)[0])}
    row["out_err_rel_diff"] = (abs(row["out_err_card"] - row["out_err_cpu"])
                               / row["out_err_cpu"])
    if not match >= MIN_CODE_MATCH:
        bad.append(f"{tag}: {match:.4f} of codes equal < {MIN_CODE_MATCH}")
    if not row["proxy_rel_diff"] <= TOL_PROXY:
        bad.append(f"{tag}: proxy loss {p_card} (card) vs {p_host} (cpu) > "
                   f"{TOL_PROXY} relative")
    if not row["out_err_rel_diff"] <= TOL_PROXY:
        bad.append(f"{tag}: output error {row['out_err_card']} (card codes) "
                   f"vs {row['out_err_cpu']} (cpu) > {TOL_PROXY} relative")
    if not row["out_err_card"] < row["out_err_rtn"]:
        bad.append(f"{tag}: GPTQ output error {row['out_err_card']} not "
                   f"below RTN's {row['out_err_rtn']}")
    del h_dev, w_dev
    return row


def launch_delta(after: dict, before: dict) -> dict:
    """{wrapper or kernel: launches} between two ``runtime.graphs``
    ``read_counts()`` snapshots, zeros left out."""
    out = {}
    for name, (n, by) in after.items():
        out[name] = n - before[name][0]
        out.update({k: v - before[name][1][k] for k, v in by.items()})
    return {k: v for k, v in out.items() if v}


def loop_pair(torch, run, tag: str, bad: list) -> tuple:
    """``run("graph")``, then ``run("python")`` (the debug loop) with its
    launches counted apart: every count is put back after it, so a path's
    launches are its graph runs'.  Fails (into ``bad``) unless the two
    runs launched the same kernels the same number of times.  Returns
    (graph result, python result, graph launches)."""
    from repro_torch.runtime.graphs import read_counts, write_counts

    c0 = read_counts()
    graph = run("graph")
    torch.cuda.synchronize()
    c1 = read_counts()
    python = run("python")
    torch.cuda.synchronize()
    n_graph, n_python = launch_delta(c1, c0), launch_delta(read_counts(), c1)
    write_counts(c1)
    if n_graph != n_python:
        bad.append(f"{tag}: launches differ between the graph loop "
                   f"{n_graph} and the Python loop {n_python}")
    return graph, python, n_graph


def serve_loops(torch, serve, serve_args, tag: str) -> tuple[dict, dict]:
    """The keep-packed fp-cache serve through the CLI with ``--loop graph``
    and again with ``--loop python`` (``loop_pair``): the same tokens bit
    for bit and the same launches, or the run fails.  Returns the graph
    run's result and the comparison row."""
    bad: list = []
    graph, python, n_graph = loop_pair(
        torch, lambda loop: serve.main(serve_args + ["--loop", loop]), tag,
        bad)
    if graph["tokens"] != python["tokens"]:
        bad.append(f"{tag}: the graph loop's tokens differ from the Python "
                   f"loop's")
    if bad:
        fail("; ".join(bad))
    return graph, {"tokens_equal": True, "launches_equal": True,
                   "launches": n_graph,
                   "graph_decode_tok_s": graph["decode_tok_s"],
                   "python_decode_tok_s": python["decode_tok_s"],
                   "captures": graph["captures"],
                   "capture_s": graph["capture_s"]}


def fp_cache_serves(torch, serve, serve_args: list, art: Path, cfg,
                    weight_dtype, tag: str) -> tuple:
    """A path's fp-cache serves of its artifact, which is read twice: the
    serve CLI in the graph loop (the user's entry point; its load checks
    the artifact's files), then one more load in this process,
    keep-packed in bf16 (unchecked: the files were just checked), for
    the rest: the same warm-up and serve in the Python loop (``loop_pair``:
    the same tokens and launches as the CLI's graph run, or the run
    fails), the dequantized serve (the codes dequantized in memory to
    ``weight_dtype``, the dtype they were quantized from, the residual
    left in bf16, as ``--no-keep-packed`` loads them) and the traced decode
    (``profile_generate``; its idle share against the CLI run's wall
    time).  Returns (the CLI run, the loop comparison row, the dequantized
    run, the traced profile, the loaded params, which ``kv_path``
    takes)."""
    from repro_torch.checkpoint.packed import load_packed_forward_params
    from repro_torch.data.calibration import SyntheticCorpus
    from repro_torch.device import generator
    from repro_torch.models.lm import Model

    dev = torch.device("cuda")
    holder: dict = {}

    def run(loop: str):
        if loop == "graph":
            return serve.main(serve_args + ["--loop", "graph"])
        holder["params"], _ = load_packed_forward_params(
            art, device=dev, dtype=torch.bfloat16, verify=False)
        model = Model(cfg, dev)
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED)
        prompts = corpus.sample(generator(SEED + 1), SERVE_BATCH,
                                PROMPT_LEN).to(dev)
        holder.update(model=model, prompts=prompts)
        serve.generate(model, holder["params"], prompts, 2, loop=loop)
        st: dict = {}
        toks = serve.generate(model, holder["params"], prompts, N_GEN,
                              stats=st, loop=loop)
        return {"tokens": toks.cpu().tolist(),
                "decode_tok_s": SERVE_BATCH * (N_GEN - 1) / st["decode_s"]}

    bad: list = []
    packed, python, n_graph = loop_pair(torch, run, tag, bad)
    if packed["tokens"] != python["tokens"]:
        bad.append(f"{tag}: the graph loop's tokens differ from the Python "
                   f"loop's")
    if bad:
        fail("; ".join(bad))
    loops = {"tokens_equal": True, "launches_equal": True,
             "launches": n_graph, "graph_decode_tok_s": packed["decode_tok_s"],
             "python_decode_tok_s": python["decode_tok_s"],
             "captures": packed["captures"], "capture_s": packed["capture_s"]}
    params, model, prompts = (holder[k] for k in ("params", "model",
                                                  "prompts"))
    deq_params = mapped(params, dequantized(torch, weight_dtype,
                                            residual=False))
    deq_model = Model(cfg, dev)
    serve.generate(deq_model, deq_params, prompts, 2)  # warm-up
    st: dict = {}
    toks = serve.generate(deq_model, deq_params, prompts, N_GEN, stats=st)
    dequant = {"tokens": toks.cpu().tolist(),
               "first_logits": st["first_logits"],
               "prefill_tok_s": SERVE_BATCH * PROMPT_LEN / st["prefill_s"],
               "decode_tok_s": SERVE_BATCH * (N_GEN - 1) / st["decode_s"]}
    del deq_params, deq_model
    traced = serve.profile_generate(model, params, prompts, N_GEN)
    traced["untraced_wall_ms"] = (packed["prefill_s"]
                                  + packed["decode_s"]) * 1e3
    traced["idle_share"] = (1.0 - traced["device_busy_ms"]
                            / traced["untraced_wall_ms"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return packed, loops, dequant, traced, params


def reset_counts(counted: dict) -> None:
    """Every launch count of ``counted``'s wrappers to 0 (by kernel too,
    where a wrapper counts them)."""
    for fn in counted.values():
        fn.launches = 0
        if hasattr(fn, "by_kernel"):
            fn.by_kernel = dict.fromkeys(fn.by_kernel, 0)


def read_counts(counted: dict) -> dict:
    """{name: launches} of ``counted``, with the launches of a wrapper that
    counts them by kernel also under the kernels' names (quant_matmul's
    ``QMM_KERNELS``, quant_matmul_t's qmm_t_decode and qmm_t_tile)."""
    out = {name: fn.launches for name, fn in counted.items()}
    for fn in counted.values():
        out.update(getattr(fn, "by_kernel", {}))
    return out


def main_path(torch) -> tuple[dict, dict]:
    """Phase 3: quantize -> artifact -> keep-packed serve, launches counted."""
    from repro_torch.checkpoint.packed import load_packed_artifact
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch import quantize, serve
    from repro_torch.launch.quantize import model_config

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block}
    art = ROOT / "build" / "chip_smoke_artifact"
    shutil.rmtree(art, ignore_errors=True)
    common = ["--arch", ARCH, "--n-layers", str(N_LAYERS), "--device", "cuda"]
    serve_args = common + ["--packed", str(art), "--dtype", "bfloat16",
                           "--batch", str(SERVE_BATCH), "--prompt-len",
                           str(PROMPT_LEN), "--gen", str(N_GEN)]
    try:
        reset_counts(counted)
        t0 = time.perf_counter()
        q = quantize.main(common + [
            "--bits", str(BITS), "--group-size", str(GROUP),
            "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
            "--batch", str(CALIB_BATCH), "--dtype", "float32",
            "--seed", str(SEED), "--scheduler", "sequential",
            "--pack-out", str(art)])
        quantize_s = time.perf_counter() - t0
        summary = q["summary"]
        proxy0 = q["report"]["layers"]["layer0"]["weights"]
        del q
        entries = {name: e for name, e in load_packed_artifact(art)[0].items()
                   if name.removeprefix("layer0/") in SOLVE_CHECK}
        torch.cuda.empty_cache()
        packed, loops, dequant, traced, params = fp_cache_serves(
            torch, serve, serve_args, art,
            model_config(ARCH, N_LAYERS, "bfloat16"), torch.float32,
            "fp cache")
        launches = read_counts(counted)
        t0 = time.perf_counter()
        kv_counted = {name: getattr(fd_ops, name) for name in KvAudit.GQA}
        for fn in kv_counted.values():
            fn.launches = 0
        kv_path(torch, art, arch=ARCH, n_layers=N_LAYERS,
                audit_names=KvAudit.GQA, params=params)
        del params
        launches.update({name: fn.launches
                         for name, fn in kv_counted.items()})
        log({"phase_seconds": {"kv_path": time.perf_counter() - t0}})
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
        "loops": loops, "launches": launches}})
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
    missing = never_launched(launches, MAIN_PATH_WITHOUT, NO_ENCODER)
    if missing:
        fail(f"main path never launched: {missing}")
    check_solves(torch, entries, proxy0)
    return launches, summary


def mla_path(torch) -> dict:
    """Phase 4, the MLA slice: RSQ quantize of deepseek-v3-671b at full
    width, its first (dense) layer -> packed artifact -> keep-packed bf16
    greedy serve (absorb and expand on the packed wkv_b: rows 3 and 4),
    compared with the same artifact dequantized at load; layer 0's
    mixer/wkv_b solve redone on the host CPU; then the kv8 and kv2 serving
    path (``kv_path``: rows 8, 9 and 10).  Every kernel's launches are
    counted from zero over the whole path."""
    from repro_torch.checkpoint.packed import load_packed_artifact
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import (quant_matmul,
                                                      quant_matmul_t)
    from repro_torch.launch import quantize, serve
    from repro_torch.launch.quantize import model_config

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul,
               "quant_matmul_t": quant_matmul_t, "fwht": fwht,
               "solve_block": solve_block}
    counted.update({name: getattr(fd_ops, name) for name in KvAudit.MLA
                    if name != "quant_matmul_t"})
    art = ROOT / "build" / "chip_smoke_mla_artifact"
    shutil.rmtree(art, ignore_errors=True)
    common = ["--arch", MLA_ARCH, "--n-layers", str(MLA_LAYERS), "--device",
              "cuda"]
    serve_args = common + ["--packed", str(art), "--dtype", "bfloat16",
                           "--batch", str(SERVE_BATCH), "--prompt-len",
                           str(PROMPT_LEN), "--gen", str(N_GEN)]
    try:
        reset_counts(counted)
        t0 = time.perf_counter()
        q = quantize.main(common + [
            "--bits", str(BITS), "--group-size", str(GROUP),
            "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
            "--batch", str(CALIB_BATCH), "--dtype", "float32",
            "--seed", str(SEED), "--scheduler", "sequential",
            "--pack-out", str(art)])
        quantize_s = time.perf_counter() - t0
        summary = q["summary"]
        proxy0 = q["report"]["layers"]["layer0"]["weights"]
        del q
        loaded, meta = load_packed_artifact(art)
        entries = {name: e for name, e in loaded.items()
                   if name.removeprefix("layer0/") in MLA_SOLVE_CHECK}
        wkv_b = meta["entries"]["layer0/mixer/wkv_b"]
        del loaded
        torch.cuda.empty_cache()
        packed, loops, dequant, traced, params = fp_cache_serves(
            torch, serve, serve_args, art,
            model_config(MLA_ARCH, MLA_LAYERS, "bfloat16"), torch.float32,
            "MLA fp cache")
        t1 = time.perf_counter()
        # the random-weight model's logits are nearly flat (perplexity
        # about the vocabulary size), and the latent cache's int8
        # read-back flips near-tied first tokens of the kv8 paged prefill
        # too: both bit widths take the lossy rule here
        kv_path(torch, art, arch=MLA_ARCH, n_layers=MLA_LAYERS,
                audit_names=KvAudit.MLA, lossy_paged_bits=KV_BITS,
                params=params)
        del params
        launches = read_counts(counted)
        log({"phase_seconds": {"mla_kv_path": time.perf_counter() - t1}})
    finally:
        shutil.rmtree(art, ignore_errors=True)

    cfg = get_config(MLA_ARCH)
    log({"mla_path": {
        "arch": MLA_ARCH,
        "widths": {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "q_lora_rank", "kv_lora_rank",
            "qk_nope_dim", "qk_rope_dim", "v_head_dim", "d_ff",
            "vocab_size")},
        "reduced": {"n_layers": f"{MLA_LAYERS} of {cfg.n_layers} (the first "
                    f"{cfg.first_dense_layers} are dense)"},
        "wkv_b_entry": {k: wkv_b[k] for k in ("loc", "d_in", "group_size")},
        "wkv_b_words": wkv_b["fields"]["codes"]["shape"],
        "n_calib": N_CALIB, "calib_seq": CALIB_SEQ,
        "quantize_s": quantize_s,
        "layer_seconds": summary["layer_seconds"],
        "ppl_fp": summary["ppl_fp"], "ppl_quant": summary["ppl_quant"],
        "ppl_ratio": summary["ppl_ratio"],
        "prefill_tok_s": packed["prefill_tok_s"],
        "decode_tok_s": packed["decode_tok_s"],
        "dequantized_prefill_tok_s": dequant["prefill_tok_s"],
        "dequantized_decode_tok_s": dequant["decode_tok_s"],
        "resident_packed_bytes": packed["resident_packed_bytes"],
        "resident_fp_bytes": packed["resident_fp_bytes"],
        "loops": loops, "launches": launches}})
    log({"mla_decode_profile": traced})

    tokens = torch.tensor(packed["tokens"])
    same = float((tokens == torch.tensor(dequant["tokens"])).float().mean())
    abs_err, rel_err = errors(packed["first_logits"], dequant["first_logits"])
    log({"mla_serve_agreement": {"token_match": same,
                                 "first_logits_max_abs_diff": abs_err,
                                 "first_logits_rel_diff": rel_err,
                                 "tol": TOL_SERVE_LOGITS}})
    if tokens.shape != (SERVE_BATCH, N_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"MLA: bad generated tokens {tuple(tokens.shape)}")
    if not bool(torch.isfinite(packed["first_logits"]).all()):
        fail("MLA: non-finite logits from the keep-packed serve")
    if not (rel_err <= TOL_SERVE_LOGITS):
        fail(f"MLA: keep-packed vs dequantized first-step logits differ by "
             f"{rel_err:.3g} > {TOL_SERVE_LOGITS}")
    ratio = summary["ppl_ratio"]
    if not (math.isfinite(ratio) and ratio < 1.5):
        fail(f"MLA: quantized/fp perplexity ratio {ratio} (expected finite, "
             f"< 1.5)")
    missing = never_launched(launches, NO_ENCODER)
    if missing:
        fail(f"MLA path never launched: {missing}")
    check_solves(torch, entries, proxy0, arch=MLA_ARCH, n_layers=MLA_LAYERS,
                 paths=MLA_SOLVE_CHECK)
    return launches


def check_expert_solves(torch, art: Path, proxy_mean: float) -> dict:
    """Layer 1's ``ffn/experts/wd`` solve of MOE_SOLVE_EXPERTS experts
    against the same solves on the host CPU, by ``check_solves``' rule.

    The card rebuilds the pipeline's inputs of layer 1: the quantize CLI's
    weights from the same seed, rotated, layer 0 replaced by the
    artifact's codes dequantized (what the pipeline propagated through),
    then layer 1's capture (``capture_block``: the attention half, the
    AttnCon scores, the FFN input and the routing) and r.  The host CPU
    takes the FFN input and r, routes with the plain versions, builds the
    chosen experts' buffers, their bf16 hidden (wd's input), the Hessians
    (the ``gram`` plain version) and solves.  The chosen experts are the
    first ones whose slot tables on the CPU equal the card's in both
    batches (a routing weight of the fp32 router product can fall on the
    other side of a top-k tie; how many did is logged).  The card's codes
    are the artifact's; its proxy losses come from the same solves redone
    on the card from the card's capture (gram kernel and GPTQ on the
    card), and their mean over the checked experts is logged beside the
    pipeline's mean over all 160."""
    from repro_torch.checkpoint.packed import load_packed_artifact
    from repro_torch.core import hessian as hess
    from repro_torch.core.gptq import gptq_quantize_batched
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig, _solve_spec
    from repro_torch.core.quantizer import (dequantize_packed,
                                            quantize_weight_rtn,
                                            unpack_codes, words_from_numpy)
    from repro_torch.core.rotation import rotate_model
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.launch.quantize import model_config
    from repro_torch.models import moe
    from repro_torch.models.lm import Model, apply_block, capture_block

    t0 = time.perf_counter()
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED)
    cfg = model_config(MOE_ARCH, MOE_LAYERS, MOE_DTYPE)
    dev = torch.device("cuda")
    model = Model(cfg, dev)  # the quantize CLI's draws, in its order
    params = model.init(generator(SEED, dev))
    params, _ = rotate_model(params, cfg, gen=generator(rsq.seed, dev))
    entries, meta = load_packed_artifact(art)
    blk0 = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in params["layers"][0].items()}
    for name, em in meta["entries"].items():
        if em["loc"] != ["prefix", 0]:
            continue
        e = entries[name]
        sub, leaf = em["path"].split("/")
        blk0[sub][leaf] = dequantize_packed(
            words_from_numpy(e["codes"]).to(dev),
            torch.from_numpy(e["scale"]).to(dev),
            torch.from_numpy(e["zero"]).to(dev), bits=BITS,
            d_in=em["d_in"]).to(blk0[sub][leaf].dtype)
    wd_entry = entries["layer1/ffn/experts/wd"]
    del entries
    blk1 = params["layers"][1]
    calib = calibration_set(cfg.vocab_size, N_CALIB, CALIB_SEQ, seed=SEED)
    batches = []  # per batch: (FFN input, r, slot table, wd's input) on card
    for i in range(0, N_CALIB, CALIB_BATCH):
        x1 = apply_block(blk0, cfg, model.embed(
            params, calib[i:i + CALIB_BATCH].to(dev)))[0]
        _, caps, _, colsum = capture_block(blk1, cfg, x1)
        r = attn_con(ImportanceInputs(z_in=x1, attn_colsum=colsum),
                     r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
        batches.append((caps["ffn/shared/wi"], r,
                        caps["ffn/__moe_slot_token"], caps["ffn/experts/wd"]))
        del caps, x1
    e_all, cap = cfg.n_routed_experts, MOE_CAP_CALIB
    router = blk1["ffn"]["router"].cpu()
    cpu_tables = []
    for hf, r, st_card, _ in batches:
        idx, w, _ = moe.route(router, hf.cpu(), cfg.moe_top_k)
        buf, st, _, _ = moe._expert_buffers(hf.cpu(), idx, w, e_all, cap)
        cpu_tables.append((buf, st, r.cpu()))
    same = [all(torch.equal(tb[1].reshape(e_all, cap)[ex],
                            b[2].cpu().reshape(e_all, cap)[ex])
                for tb, b in zip(cpu_tables, batches))
            for ex in range(e_all)]
    chosen = [ex for ex in range(e_all) if same[ex]][:MOE_SOLVE_EXPERTS]
    if len(chosen) < MOE_SOLVE_EXPERTS:
        fail(f"MoE: only {len(chosen)} experts route alike on the card and "
             f"the CPU")
    sel = torch.tensor(chosen)
    ex = blk1["ffn"]["experts"]
    wi, wu = ex["wi"][sel.to(dev)].cpu(), ex["wu"][sel.to(dev)].cpu()
    wd = ex["wd"][sel.to(dev)]
    h_cpu = h_card = None
    for (buf, st, r), (_, r_card, st_card, hid_card) in zip(cpu_tables,
                                                            batches):
        b = buf[sel]  # bf16, as the card's
        hid = torch.nn.functional.silu(b @ wi) * (b @ wu)
        r_slots = torch.cat([r, r.new_zeros((1,))])[st]
        h_cpu = hess.accumulate(h_cpu, hid,
                                r_slots.reshape(e_all, cap)[sel])
        rc = torch.cat([r_card, r_card.new_zeros((1,))])[st_card]
        h_card = hess.accumulate(h_card, hid_card[sel.to(dev)],
                                 rc.reshape(e_all, cap)[sel.to(dev)])
    del batches, cpu_tables
    f = cfg.moe_d_ff
    spec, block = _solve_spec(rsq, f)  # the pipeline's own
    card = gptq_quantize_batched(wd, h_card, spec, damp=rsq.damp,
                                 block=block)
    wd_cpu = wd.cpu()
    host = gptq_quantize_batched(wd_cpu, h_cpu, spec, damp=rsq.damp,
                                 block=block)
    noise = torch.randn(h_cpu.shape, generator=torch.Generator()
                        .manual_seed(SEED))
    rel = 2.0 ** -24 * math.sqrt(N_CALIB * CALIB_SEQ)
    noisy = gptq_quantize_batched(
        wd_cpu, h_cpu * (1 + rel * 0.5 * (noise + noise.transpose(1, 2))),
        spec, damp=rsq.damp, block=block)
    del noise
    words = words_from_numpy(wd_entry["codes"])[sel]
    art_q = unpack_codes(words, BITS, f)
    w_art = dequantize_packed(words, torch.from_numpy(wd_entry["scale"])[sel],
                              torch.from_numpy(wd_entry["zero"])[sel],
                              bits=BITS, d_in=f)
    rows, bad = {}, []
    for j, e in enumerate(chosen):
        w = wd_cpu[j].float()
        h_dev, w_dev = h_cpu[j].to(dev), w.to(dev)

        def out_err(wq) -> float:  # tr(ΔᵀHΔ), on the card for speed
            delta = w_dev - wq.float().to(dev)
            return float((delta * (h_dev @ delta)).sum())

        p_card, p_host = float(card["err"][j]), float(host["err"][j])
        row = {"code_match": float((art_q[j] == host["q"][j]).float()
                                   .mean()),
               "code_match_fp32_noise": float(
                   (noisy["q"][j] == host["q"][j]).float().mean()),
               "code_match_card_resolve": float(
                   (card["q"][j].cpu() == art_q[j]).float().mean()),
               "proxy_card": p_card, "proxy_cpu": p_host,
               "proxy_rel_diff": abs(p_card - p_host) / p_host,
               "out_err_card": out_err(w_art[j]),
               "out_err_cpu": out_err(host["w_deq"][j]),
               "out_err_rtn": out_err(quantize_weight_rtn(w, spec)[0])}
        row["out_err_rel_diff"] = (abs(row["out_err_card"]
                                       - row["out_err_cpu"])
                                   / row["out_err_cpu"])
        rows[e] = row
        tag = f"experts/wd[{e}]"
        if not row["code_match"] >= MIN_CODE_MATCH:
            bad.append(f"{tag}: {row['code_match']:.4f} of codes equal "
                       f"< {MIN_CODE_MATCH}")
        if not row["proxy_rel_diff"] <= TOL_PROXY:
            bad.append(f"{tag}: proxy loss {p_card} (card) vs {p_host} (cpu)"
                       f" > {TOL_PROXY} relative")
        if not row["out_err_rel_diff"] <= TOL_PROXY:
            bad.append(f"{tag}: output error {row['out_err_card']} (card "
                       f"codes) vs {row['out_err_cpu']} (cpu) > {TOL_PROXY} "
                       f"relative")
        if not row["out_err_card"] < row["out_err_rtn"]:
            bad.append(f"{tag}: GPTQ output error {row['out_err_card']} not "
                       f"below RTN's {row['out_err_rtn']}")
        del h_dev, w_dev
    del params, blk0, blk1, card, wd
    gc.collect()
    torch.cuda.empty_cache()
    log({"expert_solve_check": {
        "arch": MOE_ARCH, "layer": 1, "weight": "ffn/experts/wd",
        "experts": rows, "experts_routed_otherwise": e_all - sum(same),
        "proxy_card_mean_checked": sum(
            r["proxy_card"] for r in rows.values()) / len(rows),
        "proxy_pipeline_mean_all": proxy_mean,
        "seconds": time.perf_counter() - t0,
        "min_code_match": MIN_CODE_MATCH, "tol_proxy": TOL_PROXY}})
    if bad:
        fail("MoE: GPTQ on the card disagrees with the CPU: "
             + "; ".join(bad))
    return rows


def default_schedule_check(torch, quantize, q_args: list, seq_art: Path,
                           arch: str) -> dict:
    """The quantize CLI of a path again on its default schedule (no
    ``--scheduler``: overlapped on CUDA), after the path's own launches
    were read: its seconds and peak device memory beside the sequential
    run's, and its packed artifact's files bitwise (SHA-256) those of the
    sequential run's ``seq_art``; ``meta.json`` alike but for the
    configuration's ``scheduler``, which names the schedule."""
    import hashlib

    def unscheduled(tree):
        if isinstance(tree, dict):
            return {k: unscheduled(v) for k, v in tree.items()
                    if k != "scheduler"}
        if isinstance(tree, list):
            return [unscheduled(v) for v in tree]
        return tree

    def shas(d: Path) -> dict:
        out = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
               for p in sorted(d.iterdir()) if p.name != "meta.json"}
        out["meta.json"] = unscheduled(json.loads(
            (d / "meta.json").read_text()))
        return out

    art = seq_art.with_name(seq_art.name + "_default_schedule")
    shutil.rmtree(art, ignore_errors=True)
    try:
        q, seconds, peak = quantize_run(torch, quantize,
                                        q_args + ["--pack-out", str(art)])
        row = {"arch": arch, "scheduler": q["summary"]["scheduler"],
               "quantize_s": seconds, "quantize_max_memory_allocated": peak,
               "layer_seconds": q["summary"]["layer_seconds"],
               "ppl_ratio": q["summary"]["ppl_ratio"],
               "artifact_bitwise_sequential": shas(art) == shas(seq_art)}
        del q
    finally:
        shutil.rmtree(art, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log({"default_schedule": row})
    if row["scheduler"] != "overlapped" or \
            not row["artifact_bitwise_sequential"]:
        fail(f"{arch}: the default schedule's quantize run against the "
             f"sequential one: {row}")
    return row


def moe_path(torch) -> dict:
    """Phase 5, the MoE slice: RSQ quantize of deepseek-v2-236b at full
    width, 2 layers (layer 0 dense, layer 1 with 160 routed experts, top-6,
    and 2 shared), bf16 weights -> packed artifact -> keep-packed bf16
    greedy serve (every expert stack one ``quant_matmul`` launch for all
    160) in the graph and the Python loop, compared with the same artifact
    dequantized at load; layer 1's experts/wd solves of MOE_SOLVE_EXPERTS
    experts redone on the host CPU; then kv8 serving (``kv_path``:
    ``generate`` at batch 4, prompt 1024, and the engine in whole-prompt and
    chunked-paged admission on the MLA path's trace).  The MoE layer's
    calibration seconds and the quantize run's peak device memory are
    logged.  Every kernel's launches are counted from zero over the whole
    path.  Then the quantize run again on the default schedule
    (``default_schedule_check``: overlapped, its artifact bitwise the
    sequential one's, with its seconds and peak memory)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import (quant_matmul,
                                                      quant_matmul_t)
    from repro_torch.launch import quantize, serve
    from repro_torch.launch.quantize import model_config

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul,
               "quant_matmul_t": quant_matmul_t, "fwht": fwht,
               "solve_block": solve_block}
    counted.update({name: getattr(fd_ops, name) for name in KvAudit.MLA
                    if name != "quant_matmul_t"})
    art = ROOT / "build" / "chip_smoke_moe_artifact"
    shutil.rmtree(art, ignore_errors=True)
    common = ["--arch", MOE_ARCH, "--n-layers", str(MOE_LAYERS), "--device",
              "cuda"]
    serve_args = common + ["--packed", str(art), "--dtype", "bfloat16",
                           "--batch", str(SERVE_BATCH), "--prompt-len",
                           str(PROMPT_LEN), "--gen", str(N_GEN)]
    try:
        reset_counts(counted)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q_args = common + [
            "--bits", str(BITS), "--group-size", str(GROUP),
            "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
            "--batch", str(CALIB_BATCH), "--dtype", MOE_DTYPE,
            "--seed", str(SEED)]
        q = quantize.main(q_args + ["--scheduler", "sequential",
                                    "--pack-out", str(art)])
        quantize_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        summary = q["summary"]
        layer1 = q["report"]["layers"]["layer1"]
        log({"moe_layer_calibration": {
            "arch": MOE_ARCH, "layer": 1,
            "seconds": layer1["seconds"], "capture_s": layer1["capture_s"],
            "solve_s": layer1["solve_s"], "apply_s": layer1["apply_s"],
            "quantize_max_memory_allocated": peak,
            "weights": layer1["weights"]}})
        del q
        gc.collect()
        torch.cuda.empty_cache()
        packed, loops, dequant, traced, params = fp_cache_serves(
            torch, serve, serve_args, art,
            model_config(MOE_ARCH, MOE_LAYERS, "bfloat16"), torch.bfloat16,
            "MoE fp cache")
        t1 = time.perf_counter()
        kv_path(torch, art, arch=MOE_ARCH, n_layers=MOE_LAYERS,
                audit_names=KvAudit.MLA, lossy_paged_bits=KV_BITS,
                kv_bits=(8,), modes=MOE_ENGINE_MODES, overload=False,
                traced_modes=(), params=params)
        del params
        launches = read_counts(counted)
        log({"phase_seconds": {"moe_kv_path": time.perf_counter() - t1}})
        check_expert_solves(torch, art,
                            layer1["weights"]["ffn/experts/wd"])
        default_schedule_check(torch, quantize, q_args, art, MOE_ARCH)
    finally:
        shutil.rmtree(art, ignore_errors=True)

    cfg = get_config(MOE_ARCH)
    log({"moe_path": {
        "arch": MOE_ARCH,
        "widths": {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "q_lora_rank", "kv_lora_rank",
            "qk_nope_dim", "qk_rope_dim", "v_head_dim", "d_ff",
            "n_routed_experts", "n_shared_experts", "moe_top_k",
            "moe_d_ff", "vocab_size")},
        "reduced": {"n_layers": f"{MOE_LAYERS} of {cfg.n_layers} (layer 0 "
                    f"dense, layer 1 routed experts)"},
        "dtype": MOE_DTYPE, "n_calib": N_CALIB, "calib_seq": CALIB_SEQ,
        "quantize_s": quantize_s, "quantize_max_memory_allocated": peak,
        "layer_seconds": summary["layer_seconds"],
        "ppl_fp": summary["ppl_fp"], "ppl_quant": summary["ppl_quant"],
        "ppl_ratio": summary["ppl_ratio"],
        "prefill_tok_s": packed["prefill_tok_s"],
        "decode_tok_s": packed["decode_tok_s"],
        "dequantized_prefill_tok_s": dequant["prefill_tok_s"],
        "dequantized_decode_tok_s": dequant["decode_tok_s"],
        "resident_packed_bytes": packed["resident_packed_bytes"],
        "resident_fp_bytes": packed["resident_fp_bytes"],
        "loops": loops, "launches": launches}})
    log({"moe_decode_profile": traced})

    tokens = torch.tensor(packed["tokens"])
    same = float((tokens == torch.tensor(dequant["tokens"])).float().mean())
    abs_err, rel_err = errors(packed["first_logits"], dequant["first_logits"])
    log({"moe_serve_agreement": {"token_match": same,
                                 "first_logits_max_abs_diff": abs_err,
                                 "first_logits_rel_diff": rel_err,
                                 "tol": TOL_SERVE_LOGITS}})
    if tokens.shape != (SERVE_BATCH, N_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"MoE: bad generated tokens {tuple(tokens.shape)}")
    if not bool(torch.isfinite(packed["first_logits"]).all()):
        fail("MoE: non-finite logits from the keep-packed serve")
    if not (rel_err <= TOL_SERVE_LOGITS):
        fail(f"MoE: keep-packed vs dequantized first-step logits differ by "
             f"{rel_err:.3g} > {TOL_SERVE_LOGITS}")
    ratio = summary["ppl_ratio"]
    if not (math.isfinite(ratio) and ratio < 1.5):
        fail(f"MoE: quantized/fp perplexity ratio {ratio} (expected finite, "
             f"< 1.5)")
    missing = never_launched(launches, NO_ENCODER)
    if missing:
        fail(f"MoE path never launched: {missing}")
    return launches


def quantize_run(torch, quantize, args: list) -> tuple[dict, float, int]:
    """``quantize.main(args)`` from a clean allocator: (its result, wall
    seconds, the run's peak device memory)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = quantize.main(args)
    seconds = time.perf_counter() - t0
    return q, seconds, torch.cuda.max_memory_allocated()


def layer0_entries(art: Path, paths) -> dict:
    """Layer 0's artifact entries of ``paths`` (for ``check_solves``)."""
    from repro_torch.checkpoint.packed import load_packed_artifact

    return {name: e for name, e in load_packed_artifact(art)[0].items()
            if name.removeprefix("layer0/") in paths}


def agreement(torch, a: dict, b: dict) -> dict:
    """Two serves of one prompt batch: the share of equal greedy tokens,
    whether all are, and the first step's logits' largest difference
    (absolute, and relative to b's largest logit)."""
    ta, tb = torch.tensor(a["tokens"]), torch.tensor(b["tokens"])
    abs_err, rel_err = errors(a["first_logits"], b["first_logits"])
    return {"token_match": float((ta == tb).float().mean()),
            "tokens_equal": bool(torch.equal(ta, tb)),
            "first_logits_max_abs_diff": abs_err,
            "first_logits_rel_diff": rel_err}


def serve_agreement(torch, packed: dict, dequant: dict, vocab: int,
                    tag: str, tol: float = TOL_SERVE_LOGITS) -> dict:
    """Keep-packed against dequantized serving of one artifact: the first
    step's logits within ``tol`` and the greedy tokens, which must be in
    range; returns the logged row (``tokens_equal`` says whether every
    token agreed)."""
    tokens = torch.tensor(packed["tokens"])
    row = dict(agreement(torch, packed, dequant), tol=tol)
    if not bool(((tokens >= 0) & (tokens < vocab)).all()):
        fail(f"{tag}: generated tokens out of range")
    if not bool(torch.isfinite(packed["first_logits"]).all()):
        fail(f"{tag}: non-finite logits from the keep-packed serve")
    if not row["first_logits_rel_diff"] <= tol:
        fail(f"{tag}: keep-packed vs dequantized first-step logits differ "
             f"by {row['first_logits_rel_diff']:.3g} > {tol}")
    return row


def check_ratio(summary: dict, tag: str) -> None:
    ratio = summary["ppl_ratio"]
    if not (math.isfinite(ratio) and ratio < 1.5):
        fail(f"{tag}: quantized/fp perplexity ratio {ratio} (expected "
             f"finite, < 1.5)")


def generate_loops(torch, model, params, prompts, n_gen: int,
                   tag: str, **inputs) -> tuple[dict, dict]:
    """``launch.serve.generate`` on loaded params (``inputs``: its
    ``media`` or ``frames``): a 2-token warm-up, then
    the graph loop and the Python loop (``loop_pair``): the same tokens
    bit for bit and the same launches, one capture a key, or the run
    fails.  Returns the graph run (tokens, first-step logits, tok/s) and
    the comparison row."""
    from repro_torch.launch import serve

    b, t = prompts.shape
    serve.generate(model, params, prompts, 2, **inputs)  # warm-up
    stats = {"graph": {}, "python": {}}
    bad: list = []
    graph, python, n_graph = loop_pair(
        torch, lambda loop: serve.generate(model, params, prompts, n_gen,
                                          stats=stats[loop], loop=loop,
                                          **inputs),
        tag, bad)
    if not torch.equal(graph, python):
        bad.append(f"{tag}: the graph loop's tokens differ from the Python "
                   f"loop's")
    captured = [r.captured for r, _ in model.graphs.values()]
    if len(captured) != 2 or not all(captured):
        bad.append(f"{tag}: graphs {sorted(k[1:] for k in model.graphs)} "
                   f"(captured {captured}), not one for each of 2 keys")
    if bad:
        fail("; ".join(bad))
    st, py = stats["graph"], stats["python"]
    decode = b * (n_gen - 1)
    run = {"tokens": graph.cpu().tolist(),
           "first_logits": st["first_logits"],
           "prefill_tok_s": b * t / st["prefill_s"],
           "decode_tok_s": decode / st["decode_s"]}
    return run, {"tokens_equal": True, "launches_equal": True,
                 "launches": n_graph, "graph_decode_tok_s":
                 run["decode_tok_s"],
                 "python_decode_tok_s": decode / py["decode_s"],
                 "captures": sum(captured), "capture_s": st["capture_s"]}


def variant_run(torch, arch: str) -> tuple[dict, dict, dict]:
    """One config of the variants path at full width, VARIANT_LAYERS
    layer, random weights from SEED: quantize (fp32; the peak device
    memory logged) -> artifact, loaded once keep-packed in bf16 ->
    ``generate`` (batch 4, prompt 64, 16 tokens, fp cache) in the graph
    and the Python loop.  qwen1.5-4b: kv8 serving (``kv_path``:
    ``generate`` at prompt 1024 and the engine in whole-prompt and
    chunked-paged admission, no overload runs).  command-r-35b: kv8
    ``generate`` (prompt 1024, 32 tokens) on the same params, the same
    params with every packed weight dequantized as ``--no-keep-packed``
    loads them (the same greedy tokens, first-step logits within
    TOL_SERVE_LOGITS), and the model quantized again with ``--no-rotate``
    and served from the quantize run's own params, so that the tied table
    (no ``head`` leaf) is the LM head on the card.  The artifact is
    written and read once: command-r's fp32 residual (table and untied
    head) is 16.8 GB, about a minute of host time each way.  Returns (the
    logged row, layer 0's entries of VARIANT_SOLVE_CHECK, their proxy
    losses)."""
    from repro_torch.checkpoint.packed import (FP32_LEAVES,
                                               load_packed_forward_params,
                                               resident_weight_bytes)
    from repro_torch.core.quantizer import dequantize_packed
    from repro_torch.data.calibration import SyntheticCorpus
    from repro_torch.device import generator
    from repro_torch.launch import quantize, serve
    from repro_torch.kernels.quant_matmul.ops import is_packed
    from repro_torch.launch.quantize import model_config
    from repro_torch.models.lm import Model

    def mapped(tree, fn, name=""):
        if isinstance(tree, dict):
            return {k: mapped(v, fn, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mapped(v, fn, name) for v in tree]
        return fn(tree, name)

    def dequantized(w, name):  # as ``load_packed_params`` (fp32 entries)
        if not is_packed(w):
            return w
        return dequantize_packed(w.w_packed, w.scale, w.zero, bits=w.bits,
                                 d_in=w.d_in).float()

    def bf16(w, name):  # as the loaders' ``dtype``
        return w if name in FP32_LEAVES else w.to(torch.bfloat16)

    dev = torch.device("cuda")
    cfg = model_config(arch, VARIANT_LAYERS, "bfloat16")
    art = ROOT / "build" / f"chip_smoke_{arch}_artifact"
    common = ["--arch", arch, "--n-layers", str(VARIANT_LAYERS), "--device",
              "cuda", "--bits", str(BITS), "--group-size", str(GROUP),
              "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
              "--batch", str(CALIB_BATCH), "--dtype", "float32",
              "--seed", str(SEED), "--scheduler", "sequential"]
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED)
    prompts = corpus.sample(generator(SEED + 1), SERVE_BATCH,
                            PROMPT_LEN).to(dev)
    row: dict = {"arch": arch}
    try:
        shutil.rmtree(art, ignore_errors=True)
        q, row["quantize_s"], row["quantize_max_memory_allocated"] = \
            quantize_run(torch, quantize, common + ["--pack-out", str(art)])
        summary = q["summary"]
        proxy0 = q["report"]["layers"]["layer0"]["weights"]
        del q
        check_ratio(summary, arch)
        row.update({k: summary[k] for k in ("layer_seconds", "ppl_fp",
                                            "ppl_quant", "ppl_ratio")})
        entries = layer0_entries(art, VARIANT_SOLVE_CHECK[arch])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params, _ = load_packed_forward_params(art, device=dev,
                                               dtype=torch.bfloat16)
        row["load_s"] = time.perf_counter() - t0
        row["resident_packed_bytes"], row["resident_fp_bytes"] = \
            resident_weight_bytes(params)
        packed, row["loops"] = generate_loops(
            torch, Model(cfg, dev), params, prompts, N_GEN,
            f"{arch} fp cache")
        row.update({k: packed[k] for k in ("prefill_tok_s",
                                           "decode_tok_s")})
        if arch == QWEN_ARCH:
            t0 = time.perf_counter()
            # random weights give nearly flat logits: the kv8 paged
            # prefill's read-back may flip a near-tied first token, so
            # both bit widths take the lossy rule, as on the MLA path
            kv_path(torch, art, arch=arch, n_layers=VARIANT_LAYERS,
                    audit_names=KvAudit.GQA, lossy_paged_bits=KV_BITS,
                    kv_bits=(8,), modes=MOE_ENGINE_MODES, overload=False,
                    traced_modes=(), params=params)
            del params
            row["kv_path_s"] = time.perf_counter() - t0
        else:
            kv_model = Model(dataclasses.replace(cfg, kv_bits=8), dev)
            long = corpus.sample(generator(SEED + 2), SERVE_BATCH,
                                 KV_PROMPT).to(dev)
            st: dict = {}
            toks = serve.generate(kv_model, params, long, KV_GEN, stats=st)
            if toks.shape != (SERVE_BATCH, KV_GEN) or not bool(
                    torch.isfinite(st["first_logits"]).all()):
                fail(f"{arch} kv8 generate: tokens {tuple(toks.shape)} or "
                     f"non-finite logits")
            cache_b, fp_b = serve.kv_cache_bytes(kv_model, SERVE_BATCH,
                                                 KV_PROMPT + KV_GEN)
            row["kv8_generate"] = {
                "prefill_tok_s": SERVE_BATCH * KV_PROMPT / st["prefill_s"],
                "decode_tok_s": SERVE_BATCH * (KV_GEN - 1) / st["decode_s"],
                "capture_s": st["capture_s"], "kv_cache_bytes": cache_b,
                "kv_cache_fp_bytes": fp_b}
            del kv_model
            deq_params = mapped(params, dequantized)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            st = {}
            deq = serve.generate(Model(cfg, dev), deq_params, prompts, N_GEN,
                                 stats=st)
            del deq_params
            dequant = {"tokens": deq.cpu().tolist(),
                       "first_logits": st["first_logits"]}
            row["dequantized_decode_tok_s"] = (SERVE_BATCH * (N_GEN - 1)
                                               / st["decode_s"])
            row["serve_agreement"] = serve_agreement(
                torch, packed, dequant, cfg.vocab_size, arch)
            if not row["serve_agreement"]["tokens_equal"]:
                fail(f"{arch}: keep-packed and dequantized greedy tokens "
                     f"differ: {row['serve_agreement']}")
            del packed, dequant
            gc.collect()
            torch.cuda.empty_cache()
            q, nr_s, nr_peak = quantize_run(torch, quantize,
                                            common + ["--no-rotate"])
            nr_ratio = q["summary"]["ppl_ratio"]
            params = mapped(q["params"], bf16)
            del q
            check_ratio({"ppl_ratio": nr_ratio}, f"{arch} --no-rotate")
            st = {}
            nr = serve.generate(Model(cfg, dev), params, prompts, N_GEN,
                                stats=st)
            if "head" in params or \
                    not bool(torch.isfinite(st["first_logits"]).all()):
                fail(f"{arch} --no-rotate: a head leaf (a tied model keeps "
                     f"none) or non-finite logits")
            row["no_rotate"] = {
                "quantize_s": nr_s, "quantize_max_memory_allocated": nr_peak,
                "ppl_ratio": nr_ratio, "head": False,
                "tokens_in_range": bool(((nr >= 0) & (nr < cfg.vocab_size))
                                        .all()),
                "decode_tok_s": SERVE_BATCH * (N_GEN - 1) / st["decode_s"]}
            del params, nr
    finally:
        shutil.rmtree(art, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    row["widths"] = {k: getattr(cfg, k) for k in (
        "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
        "qkv_bias", "tie_embeddings")}
    row["reduced"] = {"n_layers": f"{VARIANT_LAYERS} of "
                      f"{model_config(arch, 0, 'bfloat16').n_layers}"}
    log({"variant_run": row})
    return row, entries, proxy0


def variants_path(torch) -> dict:
    """Phase 6, the dense variants: ``variant_run`` on qwen1.5-4b (qkv
    bias, G 1) and command-r-35b (tied embeddings), then layer 0's
    VARIANT_SOLVE_CHECK solves of each against the host CPU.  Every
    kernel's launches are counted from zero over both runs; the path
    fails if one it runs never launched."""
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import quant_matmul

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block}
    counted.update({name: getattr(fd_ops, name) for name in KvAudit.GQA})
    reset_counts(counted)
    runs = {arch: variant_run(torch, arch) for arch in (QWEN_ARCH, CMDR_ARCH)}
    launches = read_counts(counted)
    log({"variants_path": {"archs": list(runs), "launches": launches}})
    missing = never_launched(launches, MAIN_PATH_WITHOUT, NO_ENCODER)
    if missing:
        fail(f"variants path never launched: {missing}")
    for arch, (_, entries, proxy0) in runs.items():
        check_solves(torch, entries, proxy0, arch=arch,
                     n_layers=VARIANT_LAYERS, paths=VARIANT_SOLVE_CHECK[arch])
    return launches


def ssm_path(torch) -> dict:
    """Phase 7, the Mamba-2 slice: RSQ quantize of mamba2-780m (SSM_LAYERS
    of 48 layers, full width, fp32; AttnCon falls back to ActNorm on these
    attention-free layers) -> artifact -> keep-packed bf16 serve at each of
    SSM_SERVES in the graph and the Python loop (the conv and SSM state in
    the graph's static cache: bitwise equal tokens and launches, one
    capture a key); the same artifact served keep-packed in fp32 and
    dequantized at load in bf16 and fp32: fp32 keep-packed must give the
    fp32 dequantized serve's tokens and first-step logits within
    TOL_SSM_FP32_SERVE, and bf16 keep-packed lie no farther from the fp32
    serve than SSM_BF16_FACTOR times the bf16 dequantized serve (48 bf16
    layers compound their roundings past any fixed bound, see
    TOL_SSM_FP32_SERVE); one traced bf16 decode; layer 0's SSM_SOLVE_CHECK
    solves against the host CPU.  Logs
    the quantize seconds, each layer's seconds and ``solve_s``, the peak
    device memory and ``ppl_ratio`` over the whole model; launches counted
    from zero over the path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch import quantize, serve

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block}
    cfg = get_config(SSM_ARCH)
    art = ROOT / "build" / "chip_smoke_ssm_artifact"
    common = ["--arch", SSM_ARCH, "--n-layers", str(SSM_LAYERS), "--device",
              "cuda"]
    serve_args = common + ["--packed", str(art), "--batch", str(SERVE_BATCH)]
    serves = {}
    try:
        shutil.rmtree(art, ignore_errors=True)
        reset_counts(counted)
        q, quantize_s, peak = quantize_run(torch, quantize, common + [
            "--bits", str(BITS), "--group-size", str(GROUP),
            "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
            "--batch", str(CALIB_BATCH), "--dtype", "float32",
            "--seed", str(SEED), "--scheduler", "sequential",
            "--pack-out", str(art)])
        summary = q["summary"]
        proxy0 = q["report"]["layers"]["layer0"]["weights"]
        n_weights = summary["n_weights"]
        del q
        check_ratio(summary, SSM_ARCH)
        entries = layer0_entries(art, SSM_SOLVE_CHECK)
        gc.collect()
        torch.cuda.empty_cache()
        for prompt, n_gen in SSM_SERVES:
            args = serve_args + ["--prompt-len", str(prompt), "--gen",
                                 str(n_gen)]
            tag = f"{SSM_ARCH} prompt {prompt}"
            packed, loops = serve_loops(torch, serve, args + ["--dtype",
                                                              "bfloat16"],
                                        tag)
            if packed["captures"] != 2:  # the warm-up's key and the run's
                fail(f"{tag}: {packed['captures']} decode graphs captured, "
                     f"not one for each of 2 keys")
            # the artifact was verified by the first load
            runs = {(dt, mode): serve.main(args + [
                "--dtype", dt, f"--{mode}", "--no-verify"])
                for dt in ("bfloat16", "float32")
                for mode in ("no-keep-packed", "keep-packed")
                if (dt, mode) != ("bfloat16", "keep-packed")}
            fp32 = runs["float32", "no-keep-packed"]
            row = {"prefill_tok_s": packed["prefill_tok_s"],
                   "decode_tok_s": packed["decode_tok_s"],
                   "dequantized_decode_tok_s":
                       runs["bfloat16", "no-keep-packed"]["decode_tok_s"],
                   "fp32_decode_tok_s":
                       runs["float32", "keep-packed"]["decode_tok_s"],
                   "state_bytes": packed["kv_cache_bytes"], "loops": loops,
                   "bf16_vs_dequantized_bf16": agreement(
                       torch, packed, runs["bfloat16", "no-keep-packed"]),
                   "bf16_vs_fp32": agreement(torch, packed, fp32),
                   "dequantized_bf16_vs_fp32": agreement(
                       torch, runs["bfloat16", "no-keep-packed"], fp32),
                   "fp32_vs_dequantized_fp32": serve_agreement(
                       torch, runs["float32", "keep-packed"], fp32,
                       cfg.vocab_size, f"{tag} fp32", TOL_SSM_FP32_SERVE)}
            serves[f"prompt{prompt}_gen{n_gen}"] = row
            far = row["bf16_vs_fp32"]["first_logits_rel_diff"]
            deq_far = row["dequantized_bf16_vs_fp32"]["first_logits_rel_diff"]
            if not row["fp32_vs_dequantized_fp32"]["tokens_equal"]:
                fail(f"{tag}: fp32 keep-packed and dequantized greedy tokens "
                     f"differ")
            if not bool(torch.isfinite(packed["first_logits"]).all()) or \
                    not far <= SSM_BF16_FACTOR * deq_far:
                fail(f"{tag}: bf16 keep-packed logits {far:.3g} from the "
                     f"fp32 serve's, more than {SSM_BF16_FACTOR} x the bf16 "
                     f"dequantized serve's {deq_far:.3g}")
            resident = {k: packed[k] for k in ("resident_packed_bytes",
                                               "resident_fp_bytes")}
            del packed, runs, fp32
        traced = serve.main(serve_args + ["--dtype", "bfloat16",
                                          "--prompt-len", str(PROMPT_LEN),
                                          "--gen", str(N_GEN), "--no-verify",
                                          "--profile"])["profile"]
        launches = read_counts(counted)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    layers = summary["layer_seconds"]
    log({"ssm_path": {
        "arch": SSM_ARCH,
        "widths": {k: getattr(cfg, k) for k in (
            "d_model", "d_inner", "ssm_n_heads", "ssm_head_dim",
            "ssm_d_state", "ssm_conv_width", "ssm_chunk", "vocab_size",
            "tie_embeddings")},
        "reduced": {"n_layers": f"{SSM_LAYERS} of {cfg.n_layers}"},
        "n_calib": N_CALIB, "calib_seq": CALIB_SEQ,
        "quantize_s": quantize_s, "quantize_max_memory_allocated": peak,
        "n_weights": n_weights,
        "layer_seconds_sum": sum(r["seconds"] for r in layers.values()),
        "solve_s_sum": sum(r["solve_s"] for r in layers.values()),
        "layer_seconds": layers,
        "ppl_fp": summary["ppl_fp"], "ppl_quant": summary["ppl_quant"],
        "ppl_ratio": summary["ppl_ratio"], **resident,
        "serves": serves, "launches": launches}})
    log({"ssm_decode_profile": traced})
    missing = never_launched(launches, SSM_PATH_WITHOUT, NO_ENCODER)
    if missing:
        fail(f"SSM path never launched: {missing}")
    check_solves(torch, entries, proxy0, arch=SSM_ARCH, n_layers=SSM_LAYERS,
                 paths=SSM_SOLVE_CHECK)
    return launches


def hybrid_kinds(cfg) -> list:
    """Each layer's block kind, ``<mixer>+<ffn>`` (``mamba+moe``)."""
    return [f"{m}+{f}" for m, f in zip(cfg.layer_kinds(), cfg.ffn_kinds())]


def hybrid_path(torch) -> dict:
    """Phase 8, the hybrid slice: RSQ quantize of jamba-v0.1-52b at full
    width, its first layer group (HYB_LAYERS layers: Mamba-2 and GQA
    mixers, dense and 16-expert FFNs), bf16 weights -> artifact (each
    layer's seconds, ``capture_s`` and ``solve_s`` by block kind, the peak
    device memory, which must stay under HYB_MAX_BYTES, and ``ppl_ratio``)
    -> loaded once keep-packed in bf16 -> ``generate`` at each of
    HYB_SERVES (prompt 64 / 16 tokens with an fp cache, 1024 / 32 with
    kv8: the Mamba states and the GQA block's K/V in one cache) in the
    graph and the Python loop (``generate_loops``), one traced decode (its
    idle share), then the fp-cache serve against the same weights
    dequantized (as ``--no-keep-packed`` loads them): the same tokens and
    first-step logits within TOL_SERVE_LOGITS, or else both serves again
    in fp32, which must then agree to TOL_SSM_FP32_SERVE with the same
    tokens, the bf16 keep-packed serve no farther from the fp32 one than
    SSM_BF16_FACTOR times the bf16 dequantized one; then
    ``check_hybrid_solves``.  Launches are counted from zero over the
    quantize and the serves."""
    from repro_torch.checkpoint.packed import (load_packed_entry,
                                               load_packed_forward_params,
                                               resident_weight_bytes)
    from repro_torch.data.calibration import SyntheticCorpus
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch import quantize, serve
    from repro_torch.launch.quantize import model_config
    from repro_torch.models.lm import Model

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block}
    counted.update({name: getattr(fd_ops, name) for name in KvAudit.GQA})

    dev = torch.device("cuda")
    cfg = model_config(HYB_ARCH, HYB_LAYERS, HYB_DTYPE)
    kinds = hybrid_kinds(cfg)
    art = ROOT / "build" / "chip_smoke_hybrid_artifact"
    common = ["--arch", HYB_ARCH, "--n-layers", str(HYB_LAYERS), "--device",
              "cuda", "--bits", str(BITS), "--group-size", str(GROUP),
              "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
              "--batch", str(CALIB_BATCH), "--dtype", HYB_DTYPE,
              "--seed", str(SEED), "--scheduler", "sequential"]
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED)
    row: dict = {"arch": HYB_ARCH}
    try:
        shutil.rmtree(art, ignore_errors=True)
        reset_counts(counted)
        q, row["quantize_s"], peak = quantize_run(
            torch, quantize, common + ["--pack-out", str(art)])
        summary, layer_reps = q["summary"], q["report"]["layers"]
        del q
        gc.collect()
        torch.cuda.empty_cache()
        row["quantize_max_memory_allocated"] = peak
        by_kind: dict = {}
        for li, kind in enumerate(kinds):
            rep = layer_reps[f"layer{li}"]
            by_kind.setdefault(kind, []).append(
                {k: rep[k] for k in ("seconds", "capture_s", "solve_s",
                                     "apply_s")})
        log({"hybrid_layer_calibration": {
            "arch": HYB_ARCH, "kinds": kinds, "by_kind": by_kind,
            "quantize_max_memory_allocated": peak,
            "quantize_s": row["quantize_s"]}})
        row.update({k: summary[k] for k in ("ppl_fp", "ppl_quant",
                                            "ppl_ratio", "n_weights")})
        check_ratio(summary, HYB_ARCH)
        if not peak <= HYB_MAX_BYTES:
            fail(f"{HYB_ARCH}: the quantize run's peak device memory {peak} "
                 f"B > {HYB_MAX_BYTES:.3g}")
        proxies = {li: layer_reps[f"layer{li}"]["weights"]
                   for li in HYB_SOLVE_CHECK}
        t0 = time.perf_counter()
        params, meta = load_packed_forward_params(art, device=dev,
                                                  dtype=torch.bfloat16)
        row["load_s"] = time.perf_counter() - t0
        # the entries of the layers the solve check runs through (the
        # loader above verified the file)
        last = max(HYB_SOLVE_CHECK)
        entries = {name: load_packed_entry(art, name)
                   for name, em in meta["entries"].items()
                   if int(em["tag"][5:]) <= last}
        row["resident_packed_bytes"], row["resident_fp_bytes"] = \
            resident_weight_bytes(params)
        serves, first = {}, None
        for prompt, n_gen, kv in HYB_SERVES:
            model = Model(dataclasses.replace(cfg, kv_bits=kv), dev)
            prompts = corpus.sample(generator(SEED + 1), SERVE_BATCH,
                                    prompt).to(dev)
            tag = f"{HYB_ARCH} prompt {prompt} kv{kv}"
            run, loops = generate_loops(torch, model, params, prompts, n_gen,
                                        tag)
            cache_b, fp_b = serve.kv_cache_bytes(model, SERVE_BATCH,
                                                 prompt + n_gen)
            serves[f"prompt{prompt}_gen{n_gen}_kv{kv}"] = {
                "prefill_tok_s": run["prefill_tok_s"],
                "decode_tok_s": run["decode_tok_s"], "loops": loops,
                "cache_bytes": cache_b, "cache_fp_bytes": fp_b}
            if not bool(torch.isfinite(run["first_logits"]).all()):
                fail(f"{tag}: non-finite logits from the keep-packed serve")
            if first is None:
                first = (model, prompts, run)
        model, prompts, packed = first
        bf16_run = {k: packed[k] for k in ("tokens", "first_logits")}
        prof = serve.profile_generate(model, params, prompts, N_GEN)
        wall_ms = 1e3 * SERVE_BATCH * (PROMPT_LEN / packed["prefill_tok_s"]
                                       + (N_GEN - 1) / packed["decode_tok_s"])
        prof["untraced_wall_ms"] = wall_ms
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / wall_ms
        launches = read_counts(counted)

        def serve_with(p, dtype: str):
            """``generate`` on ``p`` with a model of its own, whose
            captured graphs (and the params they hold) go with it."""
            m = Model(dataclasses.replace(cfg, dtype=dtype), dev)
            st: dict = {}
            toks = serve.generate(m, p, prompts, N_GEN, stats=st)
            return {"tokens": toks.cpu().tolist(),
                    "first_logits": st["first_logits"],
                    "decode_tok_s": SERVE_BATCH * (N_GEN - 1)
                    / st["decode_s"]}

        deq = mapped(params, dequantized(torch, torch.bfloat16))
        dequant = serve_with(deq, HYB_DTYPE)
        del deq
        gc.collect()
        torch.cuda.empty_cache()
        row["dequantized_decode_tok_s"] = dequant["decode_tok_s"]
        agree = dict(agreement(torch, packed, dequant), tol=TOL_SERVE_LOGITS)
        row["bf16_vs_dequantized_bf16"] = agree
        log({"hybrid_serves": {"serves": serves, "bf16_vs_dequantized_bf16":
                               agree, "dequantized_decode_tok_s":
                               dequant["decode_tok_s"]}})
        if not (agree["tokens_equal"]
                and agree["first_logits_rel_diff"] <= TOL_SERVE_LOGITS):
            # bf16 activations over 8 layers: hold both serves in fp32
            kp32 = serve_with(mapped(params, fp32_residual), "float32")
            # 53 GB of fp32 weights: each packed leaf is replaced in
            # place, so the codes go as the fp32 weights come; the bf16
            # serves' graphs (and what they hold) go first
            del model, first, packed
            gc.collect()
            torch.cuda.empty_cache()
            deq32 = serve_with(mapped(params, dequantized(
                torch, torch.float32), in_place=True), "float32")
            row["fp32_vs_dequantized_fp32"] = serve_agreement(
                torch, kp32, deq32, cfg.vocab_size, f"{HYB_ARCH} fp32",
                TOL_SSM_FP32_SERVE)
            row["bf16_vs_fp32"] = agreement(torch, bf16_run, deq32)
            row["dequantized_bf16_vs_fp32"] = agreement(torch, dequant, deq32)
            far = row["bf16_vs_fp32"]["first_logits_rel_diff"]
            deq_far = row["dequantized_bf16_vs_fp32"]["first_logits_rel_diff"]
            if not row["fp32_vs_dequantized_fp32"]["tokens_equal"]:
                fail(f"{HYB_ARCH}: fp32 keep-packed and dequantized greedy "
                     f"tokens differ")
            if not far <= SSM_BF16_FACTOR * deq_far:
                fail(f"{HYB_ARCH}: bf16 keep-packed logits {far:.3g} from "
                     f"the fp32 serve's, more than {SSM_BF16_FACTOR} x the "
                     f"bf16 dequantized serve's {deq_far:.3g}")
        del params, dequant
    finally:
        shutil.rmtree(art, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    row.update(serves=serves, launches=launches, widths={k: getattr(cfg, k)
               for k in ("d_model", "n_heads", "n_kv_heads", "d_ff",
                         "vocab_size", "n_routed_experts", "moe_top_k",
                         "moe_d_ff", "d_inner", "ssm_n_heads", "ssm_d_state",
                         "ssm_chunk", "scan_period")},
               reduced={"n_layers": f"{HYB_LAYERS} of "
                        f"{model_config(HYB_ARCH, 0, HYB_DTYPE).n_layers} "
                        f"(one layer group)"},
               layer_seconds={f"layer{li}": layer_reps[f"layer{li}"]["seconds"]
                              for li in range(HYB_LAYERS)})
    log({"hybrid_path": row})
    log({"hybrid_decode_profile": prof})
    missing = never_launched(launches, MAIN_PATH_WITHOUT, HYB_PATH_WITHOUT,
                             NO_ENCODER)
    if missing:
        fail(f"hybrid path never launched: {missing}")
    check_hybrid_solves(torch, entries, meta, proxies)
    return launches


def check_hybrid_solves(torch, entries: dict, meta: dict,
                        proxies: dict) -> dict:
    """The hybrid path's HYB_SOLVE_CHECK solves against the same solves on
    the host CPU, by ``check_solves``' rule (``solve_row``).

    The card rebuilds the pipeline's inputs: the quantize CLI's weights
    from the same seed, each block rotated when reached, and the stream
    carried through the earlier blocks with the artifact's codes
    dequantized (what the pipeline propagated through).  At a checked
    layer the host CPU takes the block's input, computes the token
    importances with the plain versions (q, k and the ``attn_colsum``
    plain version at the GQA block; ActNorm at a Mamba block, as AttnCon
    falls back to it) and builds the checked weights' Hessians from their
    inputs: the GQA block's ``wk`` input from its own rms norm; a Mamba
    mixer's from the card's capture, as ``check_expert_solves`` takes the
    FFN input (plain PyTorch on both sides, no kernel of the port: a bf16
    SSD scan on the host rounds otherwise than the card's, which alone
    left 83% of ``out_proj``'s 8192-row codes equal, with proxy losses
    3.5e-5 apart).  For layer 1's routed experts the card gives the FFN
    input and r; the CPU routes and builds the capacity buffers, and
    HYB_SOLVE_EXPERTS experts whose slot tables agree on card and CPU are
    solved, their card proxy losses from the same solves redone on the
    card."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig
    from repro_torch.core.quantizer import (dequantize_packed,
                                            words_from_numpy)
    from repro_torch.core.rotation import (rotate_ends, rotate_layer,
                                           rotation_matrix)
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.launch.quantize import model_config
    from repro_torch.models import attention as att
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.lm import Model, apply_block, capture_block

    t0 = time.perf_counter()
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED)
    cfg = model_config(HYB_ARCH, HYB_LAYERS, HYB_DTYPE)
    dev = torch.device("cuda")
    model = Model(cfg, dev)  # the quantize CLI's draws, in its order
    params = model.init(generator(SEED, dev))
    last = max(HYB_SOLVE_CHECK)
    layers = params.pop("layers")[:last + 1]
    q = rotation_matrix(params, cfg, None, generator(rsq.seed, dev))
    ends = rotate_ends(params, q)
    del params
    calib = calibration_set(cfg.vocab_size, N_CALIB, CALIB_SEQ, seed=SEED)
    xs = [model.embed(ends, calib[i:i + CALIB_BATCH].to(dev))
          for i in range(0, N_CALIB, CALIB_BATCH)]
    del ends

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    rows, bad = {}, []
    for li in range(last + 1):
        blk = rotate_layer(layers[li], cfg, q)
        layers[li] = None
        paths = HYB_SOLVE_CHECK.get(li, ())
        name = {p: f"layer{li}/{p}" for p in paths}
        if any(p.startswith("ffn/experts/") for p in paths):
            rows.update(hybrid_expert_solves(torch, blk, cfg, xs, entries,
                                             name, proxies[li], rsq, bad))
        elif paths:
            mixer = cpu(blk["mixer"])
            hs: dict = {}
            for x in xs:
                x_c = x.cpu()
                h = rms_norm(x_c, blk["mixer_norm"].cpu(), cfg.norm_eps)
                if "wzx" in mixer:  # the card's capture, see above
                    caps = capture_block(blk, cfg, x)[1]
                    m_caps = {p.split("/")[1]: caps[p].cpu() for p in paths}
                    del caps
                    colsum = None
                else:
                    qq, kk, _ = att.gqa_qkv(mixer, cfg, h,
                                            torch.arange(h.shape[1]))
                    m_caps = {"wq": h, "wk": h, "wv": h}
                    colsum = attn_colsum(qq, kk)
                r = attn_con(ImportanceInputs(z_in=x_c, attn_colsum=colsum),
                             r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
                for p in paths:
                    x_p = m_caps[p.split("/")[1]]
                    hs[p] = hess.accumulate(hs.get(p), x_p.reshape(
                        -1, x_p.shape[-1]), r)
            for p in paths:
                rows[name[p]] = solve_row(
                    torch, mixer[p.split("/")[1]], hs[p], entries[name[p]],
                    proxies[li][p], rsq, name[p], bad,
                    noise_floor=p in HYB_NOISE_FLOOR)
            del mixer, hs
        if li < last:  # the stream through the quantized block
            for ename, e in entries.items():
                em = meta["entries"][ename]
                if em["tag"] != f"layer{li}":
                    continue
                node = blk
                parts = em["path"].split("/")
                for key in parts[:-1]:
                    node = node[key]
                node[parts[-1]] = dequantize_packed(
                    words_from_numpy(e["codes"]).to(dev),
                    torch.from_numpy(e["scale"]).to(dev),
                    torch.from_numpy(e["zero"]).to(dev), bits=BITS,
                    d_in=em["d_in"]).to(node[parts[-1]].dtype)
            xs = [apply_block(blk, cfg, x)[0] for x in xs]
        del blk
        gc.collect()
        torch.cuda.empty_cache()
    del xs, layers
    gc.collect()
    torch.cuda.empty_cache()
    log({"hybrid_solve_check": {
        "arch": HYB_ARCH, "weights": rows,
        "seconds": time.perf_counter() - t0,
        "min_code_match": MIN_CODE_MATCH, "tol_proxy": TOL_PROXY}})
    if bad:
        fail(f"{HYB_ARCH}: GPTQ on the card disagrees with the CPU: "
             + "; ".join(bad))
    return rows


def hybrid_expert_solves(torch, blk: dict, cfg, xs: list, entries: dict,
                         name: dict, proxy: dict, rsq, bad: list) -> dict:
    """``check_hybrid_solves``' routed-expert part: ``experts/wi`` of
    HYB_SOLVE_EXPERTS experts of one Mamba + MoE block."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.gptq import gptq_quantize_batched
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import _solve_spec
    from repro_torch.models import moe, ssm
    from repro_torch.models.layers import rms_norm

    e_all, cap = cfg.n_routed_experts, HYB_CAP_CALIB
    router = blk["ffn"]["router"]
    # per batch: the card's slot table, buffers and r; the CPU's
    batches = []
    for x in xs:
        h = rms_norm(x, blk["mixer_norm"], cfg.norm_eps)
        x2 = x + ssm.apply_mamba(blk["mixer"], cfg, h)
        hf = rms_norm(x2, blk["ffn_norm"], cfg.norm_eps).reshape(
            -1, cfg.d_model)
        r = attn_con(ImportanceInputs(z_in=x), r_min=rsq.r_min,
                     r_max=rsq.r_max).reshape(-1)
        idx, w, _ = moe.route(router, hf, cfg.moe_top_k)
        buf, st, _, _ = moe._expert_buffers(hf, idx, w, e_all, cap)
        idx_c, w_c, _ = moe.route(router.cpu(), hf.cpu(), cfg.moe_top_k)
        buf_c, st_c, _, _ = moe._expert_buffers(hf.cpu(), idx_c, w_c, e_all,
                                                cap)
        batches.append((st, buf, r, buf_c, st_c, r.cpu()))
        del h, x2, hf
    same = [all(torch.equal(b[4].reshape(e_all, cap)[ex],
                            b[0].cpu().reshape(e_all, cap)[ex])
                for b in batches) for ex in range(e_all)]
    chosen = [ex for ex in range(e_all) if same[ex]][:HYB_SOLVE_EXPERTS]
    if len(chosen) < HYB_SOLVE_EXPERTS:
        fail(f"{HYB_ARCH}: only {len(chosen)} experts route alike on the "
             f"card and the CPU")
    sel = torch.tensor(chosen)
    dev = torch.device("cuda")
    h_cpu = h_card = None
    for st, buf, r, buf_c, st_c, r_c in batches:
        rs = torch.cat([r_c, r_c.new_zeros((1,))])[st_c]
        h_cpu = hess.accumulate(h_cpu, buf_c[sel],
                                rs.reshape(e_all, cap)[sel])
        rd = torch.cat([r, r.new_zeros((1,))])[st]
        h_card = hess.accumulate(h_card, buf[sel.to(dev)],
                                 rd.reshape(e_all, cap)[sel.to(dev)])
    del batches
    wi = blk["ffn"]["experts"]["wi"][sel.to(dev)]
    spec, block = _solve_spec(rsq, cfg.d_model)  # the pipeline's own
    card = gptq_quantize_batched(wi, h_card, spec, damp=rsq.damp,
                                 block=block)
    wi_cpu = wi.cpu()
    path = "ffn/experts/wi"
    e = entries[name[path]]
    rows = {}
    for j, ex in enumerate(chosen):
        tag = f"{name[path]}[{ex}]"
        rows[tag] = solve_row(torch, wi_cpu[j], h_cpu[j],
                              {k: e[k][ex] for k in ("codes", "scale",
                                                     "zero")},
                              float(card["err"][j]), rsq, tag, bad,
                              noise_floor=path in HYB_NOISE_FLOOR)
    rows[f"{name[path]}:mean_all"] = {
        "proxy_pipeline_mean_all": proxy[path],
        "experts_routed_otherwise": e_all - sum(same)}
    del card, wi, h_card
    return rows


def check_cross_kernels(torch, checks: Checks) -> None:
    """Phase 2, the cross path's shapes: ``attn_colsum``'s non-causal form
    at whisper-medium's encoder (B 4, T 1500, H = KV 16, Dh 64; its row
    ``attn_colsum_noncausal``) and its causal form at the decoder's 448
    positions, ``flash_decode`` (kv8, kv2) at G 1, KV 16, Dh 64 over 448
    positions (the engine refuses cross-attention, so no extend),
    ``quant_matmul`` at WSP_QMM (m 4 and 256), ``gram`` on a whisper
    encoder batch (4 x 1500 rows of d 1024) and on a vision batch's media
    rows (4 x 6404 bf16 rows of d 4096, no r: ``gram_media``)."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(10)
    check_colsum(torch, checks, g, CALIB_BATCH, WSP_FRAMES, WSP_HEADS,
                 WSP_HEADS, WSP_DH, "attn_colsum_noncausal", causal=False,
                 arch=WSP_ARCH)
    check_colsum(torch, checks, g, CALIB_BATCH, WSP_CTX, WSP_HEADS,
                 WSP_HEADS, WSP_DH, False, arch=WSP_ARCH)
    torch.cuda.empty_cache()
    check_kv_kernels(torch, checks, WSP_HEADS, 1, WSP_ARCH, dh=WSP_DH,
                     s=WSP_CTX, extend=False)
    for wname, kk, nn in WSP_QMM:
        check_packed(torch, checks, g, wname, kk, nn, BITS,
                     (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN), arch=WSP_ARCH)
    torch.cuda.empty_cache()
    check_gram(torch, checks, g, 1024, False, arch=WSP_ARCH,
               n=CALIB_BATCH * WSP_FRAMES)
    check_gram(torch, checks, g, VIS_D, "gram_media", arch=VIS_ARCH,
               n=CALIB_BATCH * VIS_MEDIA, media=True)


def mapped(tree, fn, name="", in_place=False):
    """``fn(leaf, key)`` on every leaf of a tree of dicts and lists: a new
    tree, or ``tree`` itself with each leaf replaced as it goes (the old
    one freed before the next)."""
    if isinstance(tree, (dict, list)):
        out = tree if in_place else type(tree)()
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            new = mapped(v, fn, k if isinstance(tree, dict) else name,
                         in_place)
            if isinstance(out, dict) or in_place:
                out[k] = new
            else:
                out.append(new)
        return out
    return fn(tree, name)


def dequantized(torch, dtype, residual: bool = True):
    """For ``mapped``: each packed leaf dequantized to ``dtype`` as
    ``load_packed_params`` loads them (an expert stack one expert at a
    time); with ``residual`` every other leaf but the fp32 ones cast to
    ``dtype`` too, else left as it is."""
    from repro_torch.core.quantizer import dequantize_packed
    from repro_torch.kernels.quant_matmul.ops import is_packed

    def fn(w, name):
        if not is_packed(w):
            return (w if w.dtype == torch.float32 or not residual
                    else w.to(dtype))
        if w.w_packed.ndim == 2:
            return dequantize_packed(w.w_packed, w.scale, w.zero,
                                     bits=w.bits, d_in=w.d_in).to(dtype)
        out = torch.empty((w.w_packed.shape[0], w.d_in,
                           w.w_packed.shape[-1]), dtype=dtype,
                          device=w.w_packed.device)
        for e in range(out.shape[0]):  # an expert at a time
            out[e] = dequantize_packed(w.w_packed[e], w.scale[e], w.zero[e],
                                       bits=w.bits, d_in=w.d_in)
        return out
    return fn


def fp32_residual(w, name):
    """For ``mapped``: keep-packed with an fp32 residual."""
    from repro_torch.kernels.quant_matmul.ops import is_packed

    return w if is_packed(w) else w.float()


def media_ppl(torch, model, params, tokens, extra: dict,
              batch: int = CALIB_BATCH) -> float:
    """exp of the mean next-token loss of ``tokens`` (labels rolled by
    one) with their frames or media ``extra`` ({name: (N, ·, D)})."""
    total, n = 0.0, 0
    dev = model.device
    for i in range(0, tokens.shape[0], batch):
        b = tokens[i:i + batch].to(dev)
        kw = {k: v[i:i + batch].to(dev) for k, v in extra.items()}
        total += float(model.loss(params, b, torch.roll(b, -1, dims=1),
                                  **kw)) * b.shape[0]
        n += b.shape[0]
    return math.exp(total / n)


def sync_mem(torch, dev, reset: bool = False) -> int:
    """The device's peak allocation since the last reset (0 on the CPU);
    with ``reset`` a clean allocator and a new peak."""
    if dev.type != "cuda":
        return 0
    if reset:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def cross_model_run(torch, dev, cfg, *, calib, calib_seq: int, extra: dict,
                    serve_extra: dict, serves: tuple, kinds: list,
                    art: Path, solve_paths: tuple) -> dict:
    """One model of the cross path: random weights from SEED, fp ppl on
    held-out tokens, ``RSQPipeline.run`` with its frames or media (3-bit,
    group 128, AttnCon; the model rotated when each block is reached),
    ``save_packed_artifact``, quantized ppl, the artifact loaded
    keep-packed in bf16 and served by ``generate`` at each of ``serves``
    in both loops, the first serve against the dequantized weights (bf16,
    then fp32 as the hybrid path where 2e-2 or the tokens part them), a
    traced decode.  Returns the logged row, with what ``cross_solves``
    takes (the fp and the quantized params, the report and the
    ``solve_paths`` entries) under ``_solve``."""
    from repro_torch.checkpoint.packed import (load_packed_entry,
                                               load_packed_forward_params,
                                               resident_weight_bytes,
                                               save_packed_artifact)
    from repro_torch.core.pipeline import RSQConfig, RSQPipeline
    from repro_torch.data.calibration import SyntheticCorpus, heldout_set
    from repro_torch.device import generator
    from repro_torch.launch import serve
    from repro_torch.models.lm import Model

    model = Model(cfg, dev)
    params = model.init(generator(SEED, dev))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    held = heldout_set(cfg.vocab_size, N_CALIB, calib_seq, seed=SEED)
    held_extra = {k: torch.randn(v.shape, generator=g, device=dev).to(
        v.dtype) for k, v in extra.items()}
    row: dict = {"arch": cfg.name, "dtype": cfg.dtype,
                 "ppl_fp": media_ppl(torch, model, params, held, held_extra)}
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED,
                    pack_output=True, scheduler="sequential")
    pipe = RSQPipeline(model, rsq)
    sync_mem(torch, dev, reset=True)
    t0 = time.perf_counter()
    qparams, report = pipe.run(params, calib, batch_size=CALIB_BATCH,
                               **extra)
    save_packed_artifact(art, pipe.artifact, params=qparams,
                         extra={"arch": cfg.name, "n_layers": cfg.n_layers})
    row["quantize_s"] = time.perf_counter() - t0
    row["quantize_max_memory_allocated"] = sync_mem(torch, dev)
    row["n_weights"] = len(pipe.artifact["entries"])
    row["ppl_quant"] = media_ppl(torch, model, qparams, held, held_extra)
    row["ppl_ratio"] = row["ppl_quant"] / row["ppl_fp"]
    by_kind: dict = {}
    for tag, kind in kinds:
        rep = report["layers"][tag]
        by_kind.setdefault(kind, []).append(
            {k: rep[k] for k in ("seconds", "capture_s", "solve_s",
                                 "apply_s")})
    row["by_kind"] = by_kind
    row["by_kind_sums"] = {kind: {k: sum(r[k] for r in reps)
                                  for k in ("seconds", "capture_s",
                                            "solve_s")}
                           for kind, reps in by_kind.items()}
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check_ratio(row, cfg.name)
    entries = {name: load_packed_entry(art, name) for name in solve_paths}
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    t0 = time.perf_counter()
    packed, _ = load_packed_forward_params(art, device=dev,
                                           dtype=torch.bfloat16)
    row["load_s"] = time.perf_counter() - t0
    row["resident_packed_bytes"], row["resident_fp_bytes"] = \
        resident_weight_bytes(packed)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED)
    served, first = {}, None
    for prompt, n_gen, kv in serves:
        model_s = Model(dataclasses.replace(bf16, kv_bits=kv), dev)
        prompts = corpus.sample(generator(SEED + 1), SERVE_BATCH,
                                prompt).to(dev)
        tag = f"{cfg.name} prompt {prompt} kv{kv}"
        run, loops = generate_loops(torch, model_s, packed, prompts, n_gen,
                                    tag, **serve_extra)
        media_len = next(iter(serve_extra.values())).shape[1]
        cache_b, fp_b = serve.kv_cache_bytes(model_s, SERVE_BATCH,
                                             prompt + n_gen, media_len)
        served[f"prompt{prompt}_gen{n_gen}_kv{kv}"] = {
            "prefill_tok_s": run["prefill_tok_s"],
            "decode_tok_s": run["decode_tok_s"], "loops": loops,
            "cache_bytes": cache_b, "cache_fp_bytes": fp_b}
        if not bool(torch.isfinite(run["first_logits"]).all()):
            fail(f"{tag}: non-finite logits from the keep-packed serve")
        if first is None:
            first = (model_s, prompts, run)
    row["serves"] = served
    model_s, prompts, run = first
    prof = serve.profile_generate(model_s, packed, prompts, N_GEN,
                                  **serve_extra)
    wall_ms = 1e3 * SERVE_BATCH * (PROMPT_LEN / run["prefill_tok_s"]
                                   + (N_GEN - 1) / run["decode_tok_s"])
    prof["untraced_wall_ms"] = wall_ms
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / wall_ms
    row["decode_profile"] = prof

    def serve_with(p, dtype: str) -> dict:
        """``generate`` on ``p`` with a model of its own, whose captured
        graphs (and the params they hold) go with it."""
        m = Model(dataclasses.replace(cfg, dtype=dtype), dev)
        st: dict = {}
        kw = {k: v.to(m.dtype) for k, v in serve_extra.items()}
        toks = serve.generate(m, p, prompts, N_GEN, stats=st, **kw)
        return {"tokens": toks.cpu().tolist(),
                "first_logits": st["first_logits"],
                "decode_tok_s": SERVE_BATCH * (N_GEN - 1) / st["decode_s"]}

    dequant = serve_with(mapped(packed, dequantized(torch, torch.bfloat16)),
                         "bfloat16")
    row["dequantized_decode_tok_s"] = dequant["decode_tok_s"]
    agree = dict(agreement(torch, run, dequant), tol=TOL_SERVE_LOGITS)
    row["bf16_vs_dequantized_bf16"] = agree
    if not (agree["tokens_equal"]
            and agree["first_logits_rel_diff"] <= TOL_SERVE_LOGITS):
        # bf16 activations over many layers: hold both serves in fp32
        kp32 = serve_with(mapped(packed, fp32_residual), "float32")
        deq32 = serve_with(mapped(packed, dequantized(torch, torch.float32)),
                           "float32")
        row["fp32_vs_dequantized_fp32"] = serve_agreement(
            torch, kp32, deq32, cfg.vocab_size, f"{cfg.name} fp32",
            TOL_SSM_FP32_SERVE)
        row["bf16_vs_fp32"] = agreement(torch, run, deq32)
        row["dequantized_bf16_vs_fp32"] = agreement(torch, dequant, deq32)
        far = row["bf16_vs_fp32"]["first_logits_rel_diff"]
        deq_far = row["dequantized_bf16_vs_fp32"]["first_logits_rel_diff"]
        if not row["fp32_vs_dequantized_fp32"]["tokens_equal"]:
            fail(f"{cfg.name}: fp32 keep-packed and dequantized greedy "
                 f"tokens differ")
        if not far <= SSM_BF16_FACTOR * deq_far:
            fail(f"{cfg.name}: bf16 keep-packed logits {far:.3g} from the "
                 f"fp32 serve's, more than {SSM_BF16_FACTOR} x the bf16 "
                 f"dequantized serve's {deq_far:.3g}")
    del packed, dequant
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    row["_solve"] = {"params": params, "qparams": qparams, "report": report,
                     "entries": entries}
    return row


def cross_solves(torch, dev, cfg, solve: dict, extra: dict,
                 paths: tuple) -> dict:
    """``paths`` of one cross-path model against the same solves on the
    host CPU, by ``check_solves``' rule (``solve_row``).  The card gives
    what the pipeline gave its layer: an encoder block's input (the
    frames through ``frame_proj``, Q_enc) or the media (a vision batch's
    rows, or the encoder's output through the quantized encoder blocks,
    as the pipeline propagated it).  The CPU builds the Hessians with the
    plain versions: an encoder block's ``mixer/wq`` from its rms norm,
    weighted by AttnCon of the plain non-causal ``attn_colsum``;
    cross-attention's ``wk`` from the media rows, unweighted.  Q and Q_enc
    are the pipeline's draws (``generator(SEED)``, Q first)."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig
    from repro_torch.core.rotation import rotate_layer, rotation_matrix
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.models import attention as att
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.lm import Model

    t0 = time.perf_counter()
    model = Model(cfg, dev)
    params, qparams = solve["params"], solve["qparams"]
    rsq = RSQConfig(bits=BITS, group_size=GROUP, seed=SEED)
    gen = generator(rsq.seed, dev)
    q = rotation_matrix(params, cfg, None, gen)
    q_enc = rotation_matrix(params, cfg, None, gen) if model.encdec else None
    name = "frames" if model.encdec else "media"
    batches = [extra[name][i:i + CALIB_BATCH].to(dev, model.dtype)
               for i in range(0, N_CALIB, CALIB_BATCH)]

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    rows, bad = {}, []
    for tag in paths:
        layer, path = tag.split("/", 1)
        sub, wname = path.split("/")
        hs = None
        if layer.startswith("enc"):
            blk = cpu(rotate_layer(params["encoder"]["layers"][int(layer[3:])],
                                   cfg, q_enc))
            for x in batches:
                x_c = (x @ q_enc.to(x.dtype)).cpu()  # frame_proj
                h = rms_norm(x_c, blk["mixer_norm"], cfg.norm_eps)
                qq, kk, _ = att.gqa_qkv(blk["mixer"], cfg, h,
                                        torch.arange(h.shape[1]))
                r = attn_con(ImportanceInputs(
                    z_in=x_c, attn_colsum=attn_colsum(qq, kk, causal=False)),
                    r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
                hs = hess.accumulate(hs, h.reshape(-1, h.shape[-1]), r)
        else:
            li = int(layer[5:])
            blk = cpu(rotate_layer(
                params["layers"][li], cfg, q, cross=model.metas[li].cross,
                q_media=q_enc, media_norm=params["encoder"]["final_norm"]
                if model.encdec else None))
            for x in batches:
                med = model.encode(qparams, x) if model.encdec else x
                hs = hess.accumulate(hs, med.reshape(-1, med.shape[-1]).cpu())
        rows[tag] = solve_row(torch, blk[sub][wname], hs,
                              solve["entries"][tag],
                              solve["report"]["layers"][layer]["weights"][
                                  path], rsq, tag, bad)
        del blk, hs
    log({"cross_solve_check": {
        "arch": cfg.name, "weights": rows,
        "seconds": time.perf_counter() - t0,
        "min_code_match": MIN_CODE_MATCH, "tol_proxy": TOL_PROXY}})
    if bad:
        fail(f"{cfg.name}: GPTQ on the card disagrees with the CPU: "
             + "; ".join(bad))
    return rows


def cross_path(torch, dev=None) -> dict:
    """Phase 9, the cross-attention slice, through the library entry points
    (the CLIs take no frames or media, as the reference's do not):
    whisper-medium whole in fp32 (encoder blocks first, ``enc{i}``, their
    AttnCon from the non-causal ``attn_colsum``; the decoder's cross
    wk / wv on the encoder's output, unweighted), then
    llama-3.2-vision-11b's first layer group in bf16 (its cross mixer's wk
    / wv on the media rows), each by ``cross_model_run``; launches counted
    from zero over both quantize runs and serves (``attn_colsum`` by form:
    ``colsum_causal`` / ``colsum_noncausal``); then ``cross_solves`` on
    WSP_SOLVE_CHECK and VIS_SOLVE_CHECK."""
    from repro_torch.data.calibration import calibration_set
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch.quantize import model_config

    dev = dev or torch.device("cuda")
    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block}
    counted.update({name: getattr(fd_ops, name) for name in KvAudit.GQA})
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    wsp = model_config(WSP_ARCH, 0, "float32")
    vis = model_config(VIS_ARCH, VIS_LAYERS, VIS_DTYPE)
    wsp_extra = {"frames": torch.randn((N_CALIB, WSP_FRAMES, wsp.d_model),
                                       generator=g, device=dev)}
    vis_extra = {"media": torch.randn((N_CALIB, vis.n_media_tokens,
                                       vis.d_model), generator=g,
                                      device=dev).to(torch.bfloat16)}
    runs = {}
    reset_counts(counted)
    for cfg, calib_seq, extra, serves, paths in (
            (wsp, WSP_CTX, wsp_extra, WSP_SERVES, WSP_SOLVE_CHECK),
            (vis, CALIB_SEQ, vis_extra, VIS_SERVES, VIS_SOLVE_CHECK)):
        name = next(iter(extra))
        serve_extra = {name: torch.randn(
            (SERVE_BATCH,) + tuple(extra[name].shape[1:]), generator=g,
            device=dev).to(torch.bfloat16)}
        if cfg.family == "encdec":
            kinds = ([(f"enc{i}", "encoder")
                      for i in range(cfg.n_encoder_layers)]
                     + [(f"layer{i}", "decoder")
                        for i in range(cfg.n_layers)])
        else:
            kinds = [(f"layer{i}", kind)
                     for i, kind in enumerate(cfg.layer_kinds())]
        art = ROOT / "build" / f"chip_smoke_{cfg.name}_artifact"
        before = read_counts(counted)
        try:
            shutil.rmtree(art, ignore_errors=True)
            row = cross_model_run(
                torch, dev, cfg, calib=calibration_set(
                    cfg.vocab_size, N_CALIB, calib_seq, seed=SEED),
                calib_seq=calib_seq, extra=extra, serve_extra=serve_extra,
                serves=serves, kinds=kinds, art=art, solve_paths=paths)
        finally:
            shutil.rmtree(art, ignore_errors=True)
        after = read_counts(counted)
        row["launches"] = {k: after[k] - before[k] for k in after}
        row["widths"] = {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
            "vocab_size", "n_encoder_layers", "n_media_tokens",
            "cross_attn_period", "scan_period", "qkv_bias")}
        row["calibration"] = {"n_calib": N_CALIB, "calib_seq": calib_seq,
                              name: tuple(extra[name].shape)}
        row["reduced"] = ({} if cfg.family == "encdec" else
                          {"n_layers": f"{VIS_LAYERS} of "
                           f"{model_config(VIS_ARCH, 0, VIS_DTYPE).n_layers}"
                           f" (one layer group)"})
        runs[cfg.name] = (cfg, row, extra, paths)
        solve = row.pop("_solve")
        log({"cross_path_model": row})
        row["_solve"] = solve
    launches = read_counts(counted)
    for cfg, row, extra, paths in runs.values():
        cross_solves(torch, dev, cfg, row.pop("_solve"), extra, paths)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log({"cross_path": {"launches": launches, "models": {
        name: {k: row[k] for k in ("quantize_s", "ppl_ratio",
                                   "quantize_max_memory_allocated",
                                   "by_kind_sums")}
        | {"decode_tok_s": {s: v["decode_tok_s"]
                            for s, v in row["serves"].items()}}
        for name, (_, row, _, _) in runs.items()}}})
    missing = never_launched(launches, MAIN_PATH_WITHOUT, CROSS_PATH_WITHOUT)
    if missing:
        fail(f"cross path never launched: {missing}")
    return launches


def strategy_sweep(torch) -> list:
    """The paper's strategy comparison at full width: the quantize CLI on
    llama3-8b, 1 layer, N_CALIB x CALIB_SEQ tokens, once per strategy of
    SWEEP_STRATEGIES and once with AttnCon and ``--expansion
    SWEEP_EXPANSION``.  Logs each run's seconds (the CLI call, model
    init and both perplexities included), its layer's calibration and solve
    seconds, the proxy loss of every weight and ``ppl_ratio``; fails if a
    loss or a ratio is not finite."""
    from repro_torch.launch import quantize

    common = ["--arch", ARCH, "--n-layers", "1", "--device", "cuda",
              "--bits", str(BITS), "--group-size", str(GROUP),
              "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
              "--batch", str(CALIB_BATCH), "--dtype", "float32",
              "--seed", str(SEED), "--scheduler", "sequential"]
    runs, bad = [], []
    for importance, expansion in ([(name, 1) for name in SWEEP_STRATEGIES]
                                  + [("attn_con", SWEEP_EXPANSION)]):
        t0 = time.perf_counter()
        q = quantize.main(common + ["--importance", importance,
                                    "--expansion", str(expansion)])
        seconds = time.perf_counter() - t0
        layer = q["report"]["layers"]["layer0"]
        row = {"importance": importance, "expansion": expansion,
               "seconds": seconds, "layer_seconds": layer["seconds"],
               "solve_s": layer["solve_s"],
               "ppl_ratio": q["summary"]["ppl_ratio"],
               "proxy_losses": layer["weights"]}
        del q
        torch.cuda.empty_cache()
        log({"strategy_run": row})
        runs.append(row)
        values = list(row["proxy_losses"].values()) + [row["ppl_ratio"]]
        if len(row["proxy_losses"]) != 7 or not all(
                math.isfinite(v) for v in values):
            bad.append(f"{importance} x{expansion}: {values}")
    if bad:
        fail("strategy sweep: a loss or a perplexity ratio is not finite: "
             + "; ".join(bad))
    return runs


# ---------------------------------------------------------------- LDLQ / E8


def ldlq_instances() -> dict:
    """{R: {kernel, registers, spills, chain}} of every built instance of
    ``ldlq_block_kernel<R>``: registers from this run's ptxas log (None
    where the library was reused from an earlier build); from the
    library's SASS, the chain of one pass of the widest phase's round loop
    (one owner's chunk: LDLQ_CHUNK rows) and from it one row's."""
    from repro_torch.kernels import build

    regs = ptxas_kernels(build.ptxas_report("ldlq_block"))
    out = {}
    for name, instrs in sass_functions(build._target("ldlq_block")).items():
        m = re.search(r"ldlq_block_kernelILi(\d+)E", name)
        if m:
            lanes = int(m.group(1))
            cycles, body = loop_chain_cycles(instrs)
            out[lanes] = {
                "kernel": f"ldlq_block_kernel<{lanes}>",
                **regs.get(name, {"registers": None,
                                  "spill_store_bytes": None}),
                "sass_instructions": len(instrs), "loop_instructions": body,
                "loop_chain_cycles": cycles,
                "row_chain_cycles": None if cycles is None
                else cycles / LDLQ_CHUNK}
    return out


def ldlq_inputs(torch, g, n: int, block: int, d_out: int):
    """``solve_inputs``' rows and U tiles, and each row's E8 scale (its
    RMS / 2, as ``core.ldlq.row_scales``)."""
    from repro_torch.core.ldlq import row_scales

    wb, ub = solve_inputs(torch, g, n, block, d_out)
    return wb, ub, row_scales(wb)[..., 0]


def ldlq_bytes(n: int, block: int, d_out: int) -> int:
    """``ldlq_block``'s least traffic: read the block's rows, U tile and
    scales, write deq and err."""
    return n * (block * d_out + block * block + block
                + 2 * block * d_out) * 4


def ldlq_flops(n: int, block: int, d_out: int) -> float:
    """The least fp32 work: the later rows' updates (a product and a
    difference each) and, per coordinate, the rounder's ~60 operations
    (two roundings, two distances, the divisions)."""
    return n * d_out * (block * (block - 1) + 60.0 * block)


def ldlq_block_ms(checks: Checks, wb, ub, scales) -> float:
    from repro_torch.kernels.ldlq_block.ops import ldlq_block

    n, block, d_out = wb.shape
    sets = checks.clones((wb, ub, scales), ldlq_bytes(n, block, d_out))
    return checks.timer.ms(lambda a=a: ldlq_block(*a) for a in sets)


def ldlq_instance_shapes(sms: int) -> list:
    """(N, d_out) pairs that reach each instance R of ``ldlq_block`` on a
    card of ``sms`` SMs, at LDLQ_INSTANCE_D_OUT (the plan: R 4 up to 32
    columns an SM, R 2 up to 64, R 1 above), and N 3 at 14336 (the widest
    grid)."""
    out = []
    for d_out in LDLQ_INSTANCE_D_OUT:
        fit = 64 * sms // d_out
        out += [(1, d_out), (fit, d_out), (fit + 1, d_out)]
    return out + [(3, 14336)]


def check_ldlq_block(torch, checks: Checks) -> None:
    """Phase 2, LDLQ's in-block solve with the E8 rounder (``ldlq_block``,
    no Pallas counterpart: the reference's XLA compiles the loop): bitwise
    against its plain loop on the card at LDLQ_SHAPES (llama3-8b's four
    shape groups, block 128; timed, with the byte bound, the instance each
    shape runs (R lanes a column) with its registers, spills and SASS
    chain estimate, and the measured cost of a row, the slope from 64 rows
    to 128; ``wd`` the representative row); at every instance R with
    blocks of LDLQ_INSTANCE_BLOCKS rows (``ldlq_instance_shapes``); on rows
    of a 1/2- and a 1/4-grid at scale 1 and a diagonal U (every octet on
    the rounder's ties); on rows whose both divisions land halfway between
    two fp32 subnormals (``subnormal_tie_inputs``) at each R; at d_out 8
    and 32768; then one whole wd solve (14336 x 4096) under the profiler
    (``ldlq_solve_profile``)."""
    from repro_torch.kernels.ldlq_block.kernel import plan
    from repro_torch.kernels.ldlq_block.ops import ldlq_block
    from repro_torch.kernels.ldlq_block.ref import (ldlq_block_ref,
                                                    subnormal_tie_inputs,
                                                    tie_octets)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    instances = ldlq_instances()
    for inst in instances.values():
        log({"ldlq_block_instance": inst})
    mhz = max_sm_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bitwise(tag, got, want) -> None:
        for name, a, b in zip(("deq", "err"), got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                checks.bad.append(f"ldlq_block {tag}: {name} differs from "
                                  f"the plain loop")

    block = 128
    for wname, (n, d_out) in LDLQ_SHAPES.items():
        wb, ub, scales = ldlq_inputs(torch, g, n, block, d_out)
        got = ldlq_block(wb, ub, scales)
        want = ldlq_block_ref(wb, ub, scales)
        bitwise(wname, got, want)
        ms = ldlq_block_ms(checks, wb, ub, scales)
        plain_ms = host_ms(torch, lambda: ldlq_block_ref(wb, ub, scales))
        ms_64 = ldlq_block_ms(checks, wb[:, :64].contiguous(),
                              ub[:, :64, :64].contiguous(),
                              scales[:, :64].contiguous())
        how = plan(n, d_out)
        inst = instances.get(how["lanes"], {})
        row_chain = inst.get("row_chain_cycles")
        checks.record("ldlq_block", {"weight": wname, "N": n,
                                     "block": block, "d_out": d_out},
                      got[0], want[0], 0.0, ms, plain_ms, None,
                      ldlq_bytes(n, block, d_out),
                      ldlq_flops(n, block, d_out), "float32",
                      wname == "wd", plan=how, instance=inst.get("kernel"),
                      registers=inst.get("registers"),
                      spill_store_bytes=inst.get("spill_store_bytes"),
                      ms_block_64=ms_64,
                      row_cycles_measured=(ms - ms_64) / (block - 64)
                      * mhz * 1e3,
                      chain_estimate_row_cycles=row_chain,
                      chain_estimate_ms=None if row_chain is None
                      else block * row_chain / (mhz * 1e3),
                      max_sm_mhz=mhz, launches_a_layer=LDLQ_LAUNCHES)
        del wb, ub, scales, got, want
    reached = set()
    for n, d_out in ldlq_instance_shapes(sms):
        reached.add(plan(n, d_out)["lanes"])
        for rows in LDLQ_INSTANCE_BLOCKS:
            wb, ub, scales = ldlq_inputs(torch, g, n, rows, d_out)
            bitwise(f"N {n} block {rows} d_out {d_out}",
                    ldlq_block(wb, ub, scales),
                    ldlq_block_ref(wb, ub, scales))
    if reached != {1, 2, 4}:
        checks.bad.append(f"ldlq_block: the instance shapes reached R "
                          f"{sorted(reached)}, not 1, 2 and 4")
    for d_out in (8, 32768):
        wb, ub, scales = ldlq_inputs(torch, g, 1, block, d_out)
        bitwise(f"d_out {d_out}", ldlq_block(wb, ub, scales),
                ldlq_block_ref(wb, ub, scales))
    for step in (0.5, 0.25):
        d_out = 4096
        wb = tie_octets(64 * d_out // 8, step, seed=int(8 * step)).reshape(
            1, 64, d_out).to(dev)
        ub = torch.diag_embed(torch.rand((1, 64), generator=g, device=dev)
                              + 0.5)
        scales = torch.ones((1, 64), device=dev)
        bitwise(f"ties on a {step} grid", ldlq_block(wb, ub, scales),
                ldlq_block_ref(wb, ub, scales))
    # both divisions of every row halfway between two fp32 subnormals, at
    # R 4, 2 and 1 (one matrix of 256, 64 sms and 128 sms columns)
    for d_out in (256, 64 * sms, 128 * sms):
        wb, ub, scales = (t.to(dev) for t in subnormal_tie_inputs(
            block, d_out, seed=d_out))
        bitwise(f"subnormal ties d_out {d_out} R {plan(1, d_out)['lanes']}",
                ldlq_block(wb, ub, scales), ldlq_block_ref(wb, ub, scales))

    # where one solve's time goes: llama3-8b's wd (14336 x 4096: 112
    # launches, the Cholesky factor and inverse at d 14336, the scales, the
    # deferred products), warm, untraced and under the profiler
    from repro_torch.core.ldlq import ldlq_quantize

    w = torch.randn((14336, 4096), generator=g, device=dev) * 14336 ** -0.5
    x = torch.randn((CALIB_BATCH * CALIB_SEQ, 14336), generator=g,
                    device=dev)
    h = 2.0 * x.T @ x
    del x
    ldlq_quantize(w, h)
    wall_ms = host_ms(torch, lambda: ldlq_quantize(w, h), reps=1)
    before = ldlq_block.launches
    prof, _ = profile_engine(torch, lambda: ldlq_quantize(w, h))
    log({"ldlq_solve_profile": {"weight": "wd", "d_in": 14336,
                                "d_out": 4096, "untraced_wall_ms": wall_ms,
                                "launches": ldlq_block.launches - before,
                                **prof}})
    del w, h
    torch.cuda.empty_cache()


def wk_hessian(torch, dev):
    """Layer 0's rotated ``mixer/wk`` (fp32, on the card) and its Hessian
    from the quantize CLI's draws (seed SEED, N_CALIB x CALIB_SEQ tokens):
    the mixer's normed inputs weighted by AttnCon's scores, accumulated by
    the ``gram`` kernel, as the pipeline does."""
    from repro_torch.core import hessian as hess
    from repro_torch.core.importance import ImportanceInputs, attn_con
    from repro_torch.core.pipeline import RSQConfig
    from repro_torch.core.rotation import rotate_model
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.launch.quantize import model_config
    from repro_torch.models import attention as att
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.lm import Model

    rsq = RSQConfig(seed=SEED)
    cfg = model_config(ARCH, 1, "float32")
    model = Model(cfg, dev)
    params = model.init(generator(SEED, dev))
    params, _ = rotate_model(params, cfg, gen=generator(rsq.seed, dev))
    calib = calibration_set(cfg.vocab_size, N_CALIB, CALIB_SEQ, seed=SEED)
    blk = params["layers"][0]
    h = None
    for i in range(0, N_CALIB, CALIB_BATCH):
        x_b = model.embed(params, calib[i:i + CALIB_BATCH].to(dev))
        hn = rms_norm(x_b, blk["mixer_norm"], cfg.norm_eps)
        q, k, _ = att.gqa_qkv(blk["mixer"], cfg, hn,
                              torch.arange(x_b.shape[1], device=dev))
        r = attn_con(ImportanceInputs(z_in=x_b, attn_colsum=attn_colsum(
            q, k)), r_min=rsq.r_min, r_max=rsq.r_max).reshape(-1)
        h = hess.accumulate(h, hn.reshape(-1, hn.shape[-1]), r)
    w = blk["mixer"]["wk"].float().clone()
    del params, blk
    torch.cuda.empty_cache()
    return w, h


def ldlq_fp64(torch, w, h, scales, block: int = LDLQ_BLOCK,
              damp: float = 0.01) -> dict:
    """The LDLQ solve of ``core.ldlq.ldlq_quantize`` on the host in fp64
    (the same damping, factor, block order and E8 rounder, on the given
    fp32 scales): the arbiter of the fp32 solves.  Returns ``w_deq``,
    ``err`` and the factor ``u`` in fp64."""
    from repro_torch.core.ldlq import e8_quantize_row

    hf = h.double()
    hf = 0.5 * (hf + hf.T)
    d = torch.diagonal(hf)
    dead = d <= 0.0
    hf = hf + torch.diag(dead.double())
    mean_d = torch.where(dead, 0.0, d).mean()
    hf = hf + damp * torch.clamp_min(mean_d, 1e-8) * torch.eye(
        hf.shape[0], dtype=hf.dtype)
    lr = torch.linalg.cholesky(hf.flip(0, 1)).flip(0, 1)
    u = torch.linalg.solve_triangular(
        lr, torch.eye(lr.shape[0], dtype=lr.dtype), upper=True)
    wc = w.double().clone()
    sc = scales.double()
    deq = torch.empty_like(wc)
    err = 0.0
    for b0 in range(0, wc.shape[0], block):
        b1 = b0 + block
        errb = torch.empty((block, wc.shape[1]), dtype=wc.dtype)
        for i in range(b0, b1):
            row = wc[i]
            deq[i] = e8_quantize_row(row, sc[i])
            errb[i - b0] = (row - deq[i]) / u[i, i]
            wc[i + 1:b1] -= u[i, i + 1:b1, None] * errb[i - b0][None]
        wc[b1:] -= u[b0:b1, b1:].T @ errb
        err += float((errb * errb).sum())
    return {"w_deq": deq, "err": err, "u": u}


def ldlq_path(torch) -> dict:
    """The LDLQ path: the quantize CLI with ``--method ldlq`` on llama3-8b
    at full width, 1 layer, fp32, N_CALIB x CALIB_SEQ tokens in batches of
    CALIB_BATCH, sequential (each stage timed): layer seconds, capture_s,
    solve_s, the peak device memory and ``ppl_ratio`` (finite, < 1.5),
    launches counted (``ldlq_block`` must launch, ``solve_block`` must
    not).  Then layer 0's ``mixer/wk`` solved on the card (the kernel) and
    on the host CPU (the plain loop) on the same H: the same scales, at
    least LDLQ_MIN_OCTETS of the octets equal and the proxy loss within
    TOL_PROXY; and both solves against an fp64 solve of that H on the host
    (``ldlq_fp64``): the card's share of equal lattice points no more than
    LDLQ_FP64_MARGIN below the host's, its proxy loss within TOL_PROXY of
    the fp64 one.  Logged beside them: each factor's error against the
    fp64 one, in the port's precision (fp64, rounded) and in fp32, and the
    card's solve on its fp32 factor against the fp64 solve.  Then ``--pack-out`` with ``--method ldlq``, which must be
    refused (LDLQ has no integer codes)."""
    from repro_torch.core import ldlq as ldlq_mod
    from repro_torch.core.gptq import factor_stack
    from repro_torch.core.ldlq import ldlq_quantize
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.ldlq_block.ops import ldlq_block
    from repro_torch.kernels.ldlq_block.ref import ldlq_block_ref
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch import quantize

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block, "ldlq_block": ldlq_block}
    dev = torch.device("cuda")
    common = ["--arch", ARCH, "--n-layers", "1", "--device", "cuda",
              "--n-calib", str(N_CALIB), "--calib-seq", str(CALIB_SEQ),
              "--batch", str(CALIB_BATCH), "--dtype", "float32",
              "--seed", str(SEED), "--method", "ldlq"]
    reset_counts(counted)
    q, seconds, peak = quantize_run(torch, quantize, common + [
        "--scheduler", "sequential"])
    launches = read_counts(counted)
    summary = q["summary"]
    layer = q["report"]["layers"]["layer0"]
    del q
    check_ratio(summary, "ldlq_path")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    w, h = wk_hessian(torch, dev)
    card = ldlq_quantize(w, h)
    # the same solve on the card with the plain loop in the kernel's place
    # (the same U and products): bitwise
    ldlq_mod.ldlq_block = ldlq_block_ref
    try:
        plain = ldlq_quantize(w, h)
    finally:
        ldlq_mod.ldlq_block = ldlq_block
    in_situ = {k: bool(torch.equal(card[k], plain[k])) for k in card}
    del plain
    # the same solve on the card on an fp32 factor (the reference's
    # precision; the port factors LDLQ's H in fp64, core.ldlq.FACTOR_DTYPE)
    ldlq_mod.FACTOR_DTYPE = torch.float32
    try:
        card32 = ldlq_quantize(w, h)["w_deq"].cpu()
    finally:
        ldlq_mod.FACTOR_DTYPE = torch.float64
    w_cpu, h_cpu = w.cpu(), h.cpu()
    host = ldlq_quantize(w_cpu, h_cpu)
    t64 = time.perf_counter()
    exact = ldlq_fp64(torch, w_cpu, h_cpu, host["scales"])
    t64 = time.perf_counter() - t64
    scales = host["scales"].double()

    def u_err(hh, dtype) -> float:
        """The relative (Frobenius) error of a factor against fp64's."""
        u = factor_stack(hh[None], 0.01, True, dtype)[0][0].cpu().double()
        return float((u - exact["u"]).norm() / exact["u"].norm())

    u_errs = {"card": u_err(h, torch.float64),
              "cpu": u_err(h_cpu, torch.float64),
              "card_fp32_factor": u_err(h, torch.float32),
              "cpu_fp32_factor": u_err(h_cpu, torch.float32)}

    def octets(a, b):
        """1 where an octet's lattice points (w_deq / scale) agree."""
        pa = torch.round(2.0 * a.double() / scales)
        pb = torch.round(2.0 * b.double() / scales)
        return (pa == pb).reshape(w.shape[0], -1, 8).all(-1).float()

    def by_512(eq):
        return [float(eq[i:i + 512].mean()) for i in range(0, len(eq), 512)]

    card_deq = card["w_deq"].cpu()
    eq = octets(card_deq, host["w_deq"])
    eq_card64 = octets(card_deq, exact["w_deq"])
    eq_host64 = octets(host["w_deq"], exact["w_deq"])
    solve = {"weight": "layer0/mixer/wk", "octets_equal": float(eq.mean()),
             "octets_equal_by_512_rows": by_512(eq),
             "fp64": {"card_octets_equal": float(eq_card64.mean()),
                      "cpu_octets_equal": float(eq_host64.mean()),
                      "card_by_512_rows": by_512(eq_card64),
                      "cpu_by_512_rows": by_512(eq_host64),
                      "card_fp32_factor_octets_equal": float(octets(
                          card32, exact["w_deq"]).mean()),
                      "u_rel_err": u_errs,
                      "proxy": exact["err"], "seconds": t64},
             "kernel_vs_plain_loop_on_card": in_situ,
             "scales_equal": bool(torch.equal(card["scales"].cpu(),
                                              host["scales"])),
             "proxy_card": float(card["err"]),
             "proxy_cpu": float(host["err"]),
             "seconds": time.perf_counter() - t0}
    solve["proxy_rel_diff"] = (abs(solve["proxy_card"] - solve["proxy_cpu"])
                               / solve["proxy_cpu"])
    solve["fp64"]["card_proxy_rel_diff"] = (
        abs(solve["proxy_card"] - exact["err"]) / exact["err"])
    del w, h, card, card32, host, exact, w_cpu, h_cpu, card_deq
    torch.cuda.empty_cache()
    refused = None
    art = ROOT / "build" / "chip_smoke_ldlq_artifact"
    try:
        quantize.main(common + ["--pack-out", str(art)])
    except ValueError as e:
        refused = str(e)
    row = {"arch": ARCH, "reduced": {"n_layers": "1 of 32"},
           "method": "ldlq", "scheduler": summary["scheduler"],
           "quantize_s": seconds, "quantize_max_memory_allocated": peak,
           "layer_seconds": layer["seconds"],
           "capture_s": layer["capture_s"], "solve_s": layer["solve_s"],
           "apply_s": layer["apply_s"], "proxy_losses": layer["weights"],
           "ppl_fp": summary["ppl_fp"], "ppl_quant": summary["ppl_quant"],
           "ppl_ratio": summary["ppl_ratio"], "launches": launches,
           "wk_solve_check": solve, "pack_out_refused": refused}
    log({"ldlq_path": row})
    if launches["ldlq_block"] != LDLQ_LAUNCHES:
        fail(f"ldlq_path: {launches['ldlq_block']} ldlq_block launches, "
             f"expected {LDLQ_LAUNCHES} (one a 128-row block a shape group)")
    if launches["solve_block"] or not launches["gram"] or \
            not launches["attn_colsum"]:
        fail(f"ldlq_path: wrong kernels launched: {launches}")
    if not (all(in_situ.values()) and solve["scales_equal"]
            and solve["octets_equal"] >= LDLQ_MIN_OCTETS
            and solve["proxy_rel_diff"] <= TOL_PROXY):
        fail(f"ldlq_path: the card's wk solve against the host's: {solve}")
    fp64 = solve["fp64"]
    if not (fp64["card_octets_equal"] >= fp64["cpu_octets_equal"]
            - LDLQ_FP64_MARGIN
            and fp64["card_proxy_rel_diff"] <= TOL_PROXY):
        fail(f"ldlq_path: the card's whole wk solve against an fp64 solve "
             f"is clearly worse than the host's fp32 solve: {fp64}")
    if refused is None or "integer codes" not in refused or art.exists():
        fail(f"ldlq_path: --pack-out with --method ldlq was not refused "
             f"({refused!r})")
    return launches


# ------------------------------------------------ schedules and resume


def tree_equal(torch, a, b) -> bool:
    """Two trees of tensors and values: the same keys, dtypes and bits."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(tree_equal(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(tree_equal(torch, x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b.to(a.device)))
    return a == b


def counting_syncs(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, a row of the host's waits for the device: the implicit syncs
    PyTorch warns of, by the line of this package that made them, and the
    explicit ``torch.cuda.synchronize`` calls (the sequential schedule's
    clocks), and its wall seconds)."""
    import collections
    import warnings

    explicit = [0]
    real_sync = torch.cuda.synchronize

    def counted_sync(*args, **kw):
        explicit[0] += 1
        return real_sync(*args, **kw)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize = counted_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
            real_sync()
            seconds = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize = real_sync
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, {"implicit": sum(where.values()), "explicit": explicit[0],
                 "implicit_at": dict(where)}, seconds


def schedule_resume_path(torch) -> dict:
    """The schedulers and resumable quantization on the card: llama3-8b at
    full width, SR_LAYERS layers, bf16, GPTQ with ``pack_output``, from
    Python.  The sequential and the overlapped schedule (the wall time of
    each and the host syncs a layer PyTorch warns of) give the same params
    and artifact entries bit for bit (each schedule timed twice, in turns:
    the first run pays the card's warm-up); a run killed at 1:solve
    (``max_restarts`` 0, the default schedule) and resumed by a fresh
    pipeline and runner gives the sequential run's, bit for bit; an
    in-process retry at 1:capture (sequential, so that it resumes from
    layer 0's checkpoint) recovers with the same result; and the
    checkpoint overhead (seconds and bytes).  Compared in memory: no artifact is
    written."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.pipeline import RSQConfig, RSQPipeline
    from repro_torch.core.resume import QuantizeRunner
    from repro_torch.data.calibration import calibration_set
    from repro_torch.device import generator
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.ldlq_block.ops import ldlq_block
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.launch.quantize import model_config
    from repro_torch.models.lm import Model
    from repro_torch.runtime.fault import (FaultPlan, InjectedFailure,
                                           RetryPolicy)

    counted = {"gram": weighted_gram, "attn_colsum": attn_colsum,
               "quant_matmul": quant_matmul, "fwht": fwht,
               "solve_block": solve_block, "ldlq_block": ldlq_block}
    dev = torch.device("cuda")
    cfg = model_config(ARCH, SR_LAYERS, "bfloat16")
    model = Model(cfg, dev)
    params = model.init(generator(SEED, dev))
    calib = calibration_set(cfg.vocab_size, N_CALIB, CALIB_SEQ, seed=SEED)
    progress = ROOT / "build" / "chip_smoke_progress"

    def rsq(sched=None):
        return RSQConfig(bits=BITS, group_size=GROUP, seed=SEED,
                         pack_output=True, scheduler=sched)

    def run(sched):
        pipe = RSQPipeline(model, rsq(sched))
        q, rep = pipe.run(params, calib, batch_size=CALIB_BATCH)
        return q, rep, pipe.artifact

    row: dict = {"arch": ARCH, "reduced": {"n_layers": f"{SR_LAYERS} of 32"},
                 "dtype": "bfloat16", "method": "gptq"}
    bad: list = []
    reset_counts(counted)
    (q_seq, rep_seq, art_seq), syncs, secs = counting_syncs(
        torch, lambda: run("sequential"))
    launches = read_counts(counted)
    # the first run paid the card's warm-up: each schedule is timed again,
    # in turns, and the second pair is the one to compare
    (q_ovl, rep_ovl, art_ovl), o_syncs, o_secs = counting_syncs(
        torch, lambda: run(None))
    times = {"sequential": [secs], "overlapped": [o_secs]}
    for sched in ("sequential", None):
        _, _, t = counting_syncs(torch, lambda: run(sched)[1])
        times["sequential" if sched else "overlapped"].append(t)
        gc.collect()
        torch.cuda.empty_cache()
    per_layer = {k: v / SR_LAYERS for k, v in syncs.items()
                 if k != "implicit_at"}
    row["sequential"] = {"seconds": times["sequential"], "host_syncs": syncs,
                         "host_syncs_a_layer": per_layer,
                         "layers": {t: {k: v for k, v in r.items()
                                        if k != "weights"}
                                    for t, r in rep_seq["layers"].items()}}
    row["overlapped"] = {"scheduler": rep_ovl["scheduler"],
                         "seconds": times["overlapped"],
                         "host_syncs": o_syncs,
                         "host_syncs_a_layer": {
                             k: v / SR_LAYERS for k, v in o_syncs.items()
                             if k != "implicit_at"}}
    same = {"params": tree_equal(torch, q_seq, q_ovl),
            "entries": tree_equal(torch, art_seq["entries"],
                                  art_ovl["entries"]),
            "meta": art_seq["meta"] == art_ovl["meta"],
            "reports": all(rep_seq["layers"][t]["weights"]
                           == rep_ovl["layers"][t]["weights"]
                           for t in rep_seq["layers"])}
    row["overlapped"]["bitwise_sequential"] = same
    if rep_ovl["scheduler"] != "overlapped" or not all(same.values()):
        bad.append(f"overlapped against sequential: {same}")
    del q_ovl, art_ovl
    gc.collect()
    torch.cuda.empty_cache()

    def resumed_same(q, art) -> dict:
        return {"params": tree_equal(torch, q_seq, q),
                "entries": tree_equal(torch, art_seq["entries"],
                                      art["entries"]),
                "meta": art_seq["meta"] == art["meta"]}

    try:
        shutil.rmtree(progress, ignore_errors=True)
        r1 = QuantizeRunner(RSQPipeline(model, rsq()),
                            CheckpointManager(progress),
                            policy=RetryPolicy(max_restarts=0))
        t0 = time.perf_counter()
        try:
            r1.run(params, calib, batch_size=CALIB_BATCH,
                   fault=FaultPlan({(1, "solve"): 1}))
            bad.append("the fault at 1:solve did not stop the run")
        except InjectedFailure:
            pass
        killed_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in progress.rglob("*")
                         if f.is_file())
        pipe2 = RSQPipeline(model, rsq())
        r2 = QuantizeRunner(pipe2, CheckpointManager(progress),
                            policy=RetryPolicy(max_restarts=0))
        t0 = time.perf_counter()
        q2, rep2 = r2.run(params, calib, batch_size=CALIB_BATCH)
        resumed_s = time.perf_counter() - t0
        # each layer's blocks and entries are written once, in a part;
        # each step holds the activations (and, overlapped, Hessians)
        parts_bytes = sum(f.stat().st_size for f in
                          (progress / "parts").iterdir())
        steps_bytes = sum(f.stat().st_size for f in progress.rglob("*")
                          if f.is_file()) - parts_bytes
        same = resumed_same(q2, pipe2.artifact)
        row["kill_resume"] = {
            "fault": "1:solve", "killed_run_s": killed_s,
            "resumed_run_s": resumed_s, "checkpoint_bytes": ckpt_bytes,
            "after_resume": {"parts_bytes": parts_bytes,
                             "parts": len(list((progress / "parts")
                                               .iterdir())),
                             "steps_bytes": steps_bytes,
                             "steps": CheckpointManager(progress)
                             .all_steps()},
            "ckpt_overhead_s": r1.ckpt_overhead_s + r2.ckpt_overhead_s,
            "events": r1.events.kinds() + r2.events.kinds(),
            "layer0_resumed": bool(rep2["layers"]["layer0"].get("resumed")),
            "bitwise_sequential": same}
        if not all(same.values()) or not row["kill_resume"]["layer0_resumed"]:
            bad.append(f"killed and resumed against sequential: {same}")
        del q2, pipe2
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(progress, ignore_errors=True)
        # sequential: layer 1's capture comes after layer 0's commit, so
        # the retry resumes there (under the overlapped schedule layer 1's
        # capture runs inside layer 0's apply sweep, before any commit,
        # and a retry starts over)
        pipe3 = RSQPipeline(model, rsq("sequential"))
        r3 = QuantizeRunner(pipe3, CheckpointManager(progress),
                            policy=RetryPolicy(max_restarts=2,
                                               backoff_s=0.001))
        t0 = time.perf_counter()
        q3, _ = r3.run(params, calib, batch_size=CALIB_BATCH,
                       fault=FaultPlan.parse(["1:capture:1"]))
        same = resumed_same(q3, pipe3.artifact)
        row["retry"] = {"fault": "1:capture:1", "scheduler": "sequential",
                        "seconds":
                        time.perf_counter() - t0, "restarts": r3.restarts,
                        "events": r3.events.kinds(),
                        "ckpt_overhead_s": r3.ckpt_overhead_s,
                        "bitwise_sequential": same}
        if r3.restarts != 1 or not all(same.values()) or \
                "resume" not in r3.events.kinds():
            bad.append(f"in-process retry: {row['retry']}")
        del q3, pipe3
    finally:
        shutil.rmtree(progress, ignore_errors=True)
    row["launches"] = launches
    log({"schedule_resume_path": row})
    if bad:
        fail("schedule_resume_path: " + "; ".join(bad))
    if not launches["solve_block"] or launches["ldlq_block"]:
        fail(f"schedule_resume_path: wrong kernels launched: {launches}")
    del q_seq, art_seq, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def card_torch(src: Path):
    """torch with the card checked and ``repro_torch`` importable from
    ``src``; fails without a card or without the package there."""
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run chip_smoke.py from a "
             f"checkout of the repository")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def card_name() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def time_quant_matmul(torch) -> list:
    """``quant_matmul`` at llama3-8b's down projection (14336 -> 4096),
    bf16, group 128, 3 and 4 bits, m in QMM_M, with the ``repro_torch``
    that is on sys.path; ms per call from ``Timer`` on the inputs phase 2
    times (``rtn_packed``, ``packed_sets``)."""
    from repro_torch.kernels.quant_matmul.ops import quant_matmul

    g = torch.Generator(device="cuda").manual_seed(7)
    checks = Checks(Timer(torch))
    kk, nn = 14336, 4096
    out = []
    for bits in (3, 4):
        pw, _ = rtn_packed(torch, g, kk, nn, bits)
        for m in QMM_M:
            x = torch.randn((m, kk), generator=g, device="cuda").to(
                torch.bfloat16)
            pws = packed_sets(checks, x, pw)
            out.append({"bits": bits, "m": m, "k": kk, "n": nn,
                        "ms": checks.timer.ms(lambda a=a: quant_matmul(*a)
                                              for a in pws)})
    return out


def time_gram(torch) -> list:
    """``weighted_gram`` as phase 2 times it (one calibration batch, fp32
    x, r fused, alpha 2 into an fp32 accumulator) at d 4096 and 14336,
    with the ``repro_torch`` that is on sys.path; ms per call from
    ``Timer`` over cold copies."""
    from repro_torch.kernels.gram.ops import weighted_gram

    g = torch.Generator(device="cuda").manual_seed(9)
    checks = Checks(Timer(torch))
    n = CALIB_BATCH * CALIB_SEQ
    out = []
    for d in (4096, 14336):
        x = torch.randn((n, d), generator=g, device="cuda")
        r = torch.rand((n,), generator=g, device="cuda")
        sets = checks.clones((x, r, torch.zeros((d, d), device="cuda")),
                             n * d * 4 + n * 4 + 2 * d * d * 4)
        out.append({"kernel": "gram", "n": n, "d": d,
                    "ms": checks.timer.ms(lambda a=a: weighted_gram(
                        a[0], a[1], out=a[2], alpha=2.0) for a in sets)})
        del x, r, sets
        torch.cuda.empty_cache()
    return out


def time_gqa_attention(torch) -> list:
    """``flash_decode``, ``paged_flash_decode`` and ``paged_flash_extend``
    on phase 2's inputs (``gqa_decode_inputs``, ``gqa_extend_inputs``), kv8
    and kv2, with the ``repro_torch`` that is on sys.path; ms per call from
    ``Timer`` over cold copies."""
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      paged_flash_decode,
                                                      paged_flash_extend)

    g = torch.Generator(device="cuda").manual_seed(1)
    checks = Checks(Timer(torch))
    out = []
    for bits in KV_BITS:
        di = gqa_decode_inputs(torch, g, bits)
        page = di["page"]
        kw = dict(kv_bits=bits, chunk=di["codec"].chunk, dv=FD_DH)
        cache_b = sum(t.numel() * t.element_size() for t in di["flat"])
        sets = checks.clones((di["q"],) + di["flat"] + (di["pos"],), cache_b)
        out.append({"kernel": "flash_decode", "kv_bits": bits,
                    "ms": checks.timer.ms(lambda a=a: flash_decode(
                        *a, tile=page, **kw) for a in sets)})
        sets = checks.clones((di["tbl"], di["pos"], di["q"])
                             + tuple(di["pools"]), cache_b)
        out.append({"kernel": "paged_flash_decode", "kv_bits": bits,
                    "ms": checks.timer.ms(lambda a=a: paged_flash_decode(
                        *a, page=page, **kw) for a in sets)})
        del di, sets
        xi = gqa_extend_inputs(torch, g, bits)
        args = (xi["tbl"], xi["q"], xi["k_new"], xi["v_new"]) \
            + tuple(xi["pools"])
        sets = checks.clones(args, sum(t.numel() * t.element_size()
                                       for t in args))
        out.append({"kernel": "paged_flash_extend", "kv_bits": bits,
                    "ms": checks.timer.ms(lambda a=a: paged_flash_extend(
                        *a, **xi["ekw"]) for a in sets)})
        del xi, sets
        torch.cuda.empty_cache()
    return out


def time_mla_decode(torch) -> list:
    """``mla_flash_decode`` and ``paged_mla_flash_decode`` on phase 2's
    inputs (``mla_decode_inputs``) at both of its shapes (MD_SHAPES), kv8
    and kv2, with the ``repro_torch`` that is on sys.path; ms per call from
    ``Timer`` over cold copies."""
    from repro_torch.kernels.flash_decode.ops import (mla_flash_decode,
                                                      paged_mla_flash_decode)

    g = torch.Generator(device="cuda").manual_seed(11)
    checks = Checks(Timer(torch))
    out = []
    for name, positions in MD_SHAPES.items():
        for bits in KV_BITS:
            di = mla_decode_inputs(torch, g, bits, positions)
            kw, page = di["kw"], di["page"]
            for kernel, fn, args, arg in (
                    ("mla_flash_decode", mla_flash_decode, di["flat"],
                     {"tile": page}),
                    ("paged_mla_flash_decode", paged_mla_flash_decode,
                     di["paged"], {"page": page})):
                sets = checks.clones(args, di["cache_b"])
                out.append({"kernel": kernel, "shape": name,
                            "kv_bits": bits,
                            "ms": checks.timer.ms(lambda a=a: fn(
                                *a, **arg, **kw) for a in sets)})
                del sets
            del di
            torch.cuda.empty_cache()
    return out


def time_mla(torch) -> list:
    """MLA's absorb (``quant_matmul_t`` on the W_k views of a 3-bit
    deepseek-v3 wkv_b: H 128, d 128, k 512) and its expand (``quant_matmul``
    on the W_v views, fp32 x: H 128, k 512, n 128), each at m = SERVE_BATCH
    and ENGINE_CHUNK, ``paged_mla_flash_extend`` on phase 2's inputs
    (``mla_extend_inputs``), kv8 and kv2, and the latent decode
    (``time_mla_decode``), with the ``repro_torch`` that is on sys.path; ms
    per call from ``Timer`` over cold copies (the weight from
    ``rtn_packed`` and ``packed_sets``, as ``time_quant_matmul``)."""
    from repro_torch.kernels.flash_decode.ops import paged_mla_flash_extend
    from repro_torch.kernels.quant_matmul.ops import (mla_latent_weights,
                                                      quant_matmul,
                                                      quant_matmul_t)

    g = torch.Generator(device="cuda").manual_seed(8)
    checks = Checks(Timer(torch))
    h, dn, dv, dl = MLA_H, MLA_DN, MLA_DV, MLA_DL
    pw, _ = rtn_packed(torch, g, dl, h * (dn + dv), BITS)
    out = []
    for m in (SERVE_BATCH, ENGINE_CHUNK):
        x = torch.randn((h, m, dn), generator=g, device="cuda")
        args = [(a[0], mla_latent_weights(a[1], h, dn, dv)[0])
                for a in packed_sets(checks, x, pw)]
        out.append({"kernel": "quant_matmul_t", "bits": BITS, "H": h,
                    "m": m, "d": dn, "k": dl,
                    "ms": checks.timer.ms(lambda a=a: quant_matmul_t(*a)
                                          for a in args)})
        del args
    for m in (SERVE_BATCH, ENGINE_CHUNK):  # the expand: decode, a chunk
        x = torch.randn((h, m, dl), generator=g, device="cuda")
        args = [(a[0], mla_latent_weights(a[1], h, dn, dv)[1])
                for a in packed_sets(checks, x, pw)]
        out.append({"kernel": "quant_matmul", "x": "fp32", "bits": BITS,
                    "H": h, "m": m, "k": dl, "n": dv,
                    "ms": checks.timer.ms(lambda a=a: quant_matmul(*a)
                                          for a in args)})
        del args, x
    for bits in KV_BITS:
        xi = mla_extend_inputs(torch, g, bits)
        args = (xi["tbl"], xi["ql"], xi["qr"], xi["c_new"], xi["r_new"]) \
            + tuple(xi["pools"])
        sets = checks.clones(args, sum(t.numel() * t.element_size()
                                       for t in args))
        out.append({"kernel": "paged_mla_flash_extend", "kv_bits": bits,
                    "ms": checks.timer.ms(lambda a=a: paged_mla_flash_extend(
                        *a, **xi["ekw"]) for a in sets)})
        del xi, sets
        torch.cuda.empty_cache()
    return out + time_mla_decode(torch)


def time_attn_colsum(torch) -> list:
    """``attn_colsum`` as phase 2 times it (fp32 q and k of one calibration
    batch) at llama3-8b's heads (32 on 8, Dh 128) and the MLA path's (128 on
    128, Dh 192), with the ``repro_torch`` that is on sys.path; ms per call
    from ``Timer`` over cold copies."""
    from repro_torch.kernels.attn_colsum.ops import attn_colsum

    g = torch.Generator(device="cuda").manual_seed(10)
    checks = Checks(Timer(torch))
    out = []
    for b, t, h, kv, dh in ((CALIB_BATCH, CALIB_SEQ, 32, 8, 128),
                            (CALIB_BATCH, CALIB_SEQ, MLA_H, MLA_H,
                             MLA_DN + MLA_DR)):
        q = torch.randn((b, t, h, dh), generator=g, device="cuda")
        k = torch.randn((b, t, kv, dh), generator=g, device="cuda")
        sets = checks.clones((q, k), (q.numel() + k.numel()) * 4)
        out.append({"kernel": "attn_colsum", "B": b, "T": t, "H": h,
                    "KV": kv, "Dh": dh,
                    "ms": checks.timer.ms(lambda a=a: attn_colsum(*a)
                                          for a in sets)})
        del q, k, sets
        torch.cuda.empty_cache()
    return out


def time_solve_block(torch) -> list:
    """``solve_block`` at SOLVE_SHAPES (3-bit, group 128, sym, blocks of
    128 rows) on phase 2's inputs (``solve_inputs``), with the
    ``repro_torch`` that is on sys.path; ms per call from ``Timer`` over
    cold copies (``solve_block_ms``)."""
    from repro_torch.core.quantizer import QuantSpec

    g = torch.Generator(device="cuda").manual_seed(7)
    checks = Checks(Timer(torch))
    main = QuantSpec(bits=BITS, group_size=GROUP)
    out = []
    for wname, (n, d_out) in SOLVE_SHAPES.items():
        wb, ub = solve_inputs(torch, g, n, 128, d_out)
        out.append({"weight": wname, "N": n, "block": 128, "d_out": d_out,
                    "ms": solve_block_ms(checks, wb, ub, main)})
        del wb, ub
    torch.cuda.empty_cache()
    return out


def time_ldlq_block(torch) -> list:
    """``ldlq_block`` at LDLQ_SHAPES (blocks of 128 rows) on phase 2's
    inputs (``ldlq_inputs``), with the ``repro_torch`` that is on
    sys.path; ms per call from ``Timer`` over cold copies
    (``ldlq_block_ms``)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    checks = Checks(Timer(torch))
    out = []
    for wname, (n, d_out) in LDLQ_SHAPES.items():
        wb, ub, scales = ldlq_inputs(torch, g, n, 128, d_out)
        out.append({"weight": wname, "N": n, "block": 128, "d_out": d_out,
                    "ms": ldlq_block_ms(checks, wb, ub, scales)})
        del wb, ub, scales
    torch.cuda.empty_cache()
    return out


# ``compare``'s timers, by the name each run's entry takes
TIMERS = {"gram": "time_gram", "attn_colsum": "time_attn_colsum",
          "quant_matmul": "time_quant_matmul",
          "gqa_attention": "time_gqa_attention", "mla": "time_mla",
          "solve_block": "time_solve_block", "ldlq_block": "time_ldlq_block"}
# one process of ``compare``: times the tree named by argv[1] with the
# timers named by argv[2]
TIME_ONE_TREE = ("import sys; from pathlib import Path; import chip_smoke "
                 "as c; t = c.card_torch(Path(sys.argv[1])); "
                 "c.log({k: getattr(c, c.TIMERS[k])(t) "
                 "for k in sys.argv[2].split(',')})")


def compare(other: Path, names=tuple(TIMERS)) -> None:
    """Times ``gram`` (``time_gram``), ``attn_colsum``
    (``time_attn_colsum``), ``quant_matmul`` (``time_quant_matmul``), the
    three GQA attention wrappers (``time_gqa_attention``), MLA's absorb,
    fp32 expand, extend and latent decode (``time_mla``) and GPTQ's and
    LDLQ's in-block solves (``time_solve_block``, ``time_ldlq_block``), or
    the ``names`` of them (keys of TIMERS), of another checkout's ``src``
    and of this one in turns, other, this, this, other, one process each
    on the same card, and prints them as one JSON line."""
    card_torch(SRC)
    order = [other.resolve(), SRC, SRC, other.resolve()]
    runs = []
    for src in order:
        done = subprocess.run(
            [sys.executable, "-c", TIME_ONE_TREE, str(src),
             ",".join(names)], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            fail(f"timing {src} failed:\n{done.stderr}")
        runs.append({"src": str(src),
                     **json.loads(done.stdout.strip().splitlines()[-1])})
    log({"compare": {"card": card_name(), "runs": runs}})


def main() -> None:
    args = sys.argv[1:]
    if len(args) in (2, 3) and args[0] == "--compare":
        names = args[2].split(",") if len(args) == 3 else tuple(TIMERS)
        if not set(names) <= set(TIMERS):
            fail(f"--compare times {sorted(TIMERS)}, not {names}")
        compare(Path(args[1]), names)
        return
    only = None
    if len(args) == 2 and args[0] == "--only":
        only = set(args[1].split(","))
    elif args:
        fail("usage: chip_smoke.py [--compare OTHER/src [NAME,...] | "
             "--only PHASE[,PHASE...]]")
    torch = card_torch(SRC)
    t_start = time.perf_counter()

    log(card_name())
    from repro_torch.kernels import build

    built = build.build_all()
    log({"build": built})
    log({"phase_seconds": {"build": built["seconds"]}})
    for name in build.SOURCES:  # nvcc -Xptxas -v of this run's builds
        found = ptxas_kernels(build.ptxas_report(name)).values()
        if found:
            log({"ptxas": {"source": name, "kernels": len(found),
                           "max_registers": max(k["registers"] or 0
                                                for k in found),
                           "max_spill_store_bytes": max(
                               k["spill_store_bytes"] or 0 for k in found)}})

    checks = Checks(Timer(torch))
    for phase in (check_kernels, check_moe_kernels, check_hadamard,
                  check_kv_kernels, check_mla_kernels, check_gptq_block,
                  check_variant_kernels, check_hybrid_kernels,
                  check_cross_kernels, check_ldlq_block):
        if only is not None and phase.__name__ not in only:
            continue
        t0 = time.perf_counter()
        phase(torch, checks)
        log({"phase_seconds": {phase.__name__: time.perf_counter() - t0}})
    if checks.bad:
        fail("kernel disagrees with its plain version: "
             + "; ".join(checks.bad))
    rows = checks.rows
    if only is not None:  # a partial run for development: no result line
        for path in (moe_path, ldlq_path, schedule_resume_path):
            if path.__name__ in only:
                t0 = time.perf_counter()
                path(torch)
                log({"phase_seconds": {path.__name__:
                                       time.perf_counter() - t0}})
        log(f"partial run ({sorted(only)}): "
            f"{time.perf_counter() - t_start:.1f} s, no result")
        return
    t0 = time.perf_counter()
    launches, _ = main_path(torch)
    log({"phase_seconds": {"main_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    mla_launches = mla_path(torch)
    log({"phase_seconds": {"mla_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    moe_launches = moe_path(torch)
    log({"phase_seconds": {"moe_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    variant_launches = variants_path(torch)
    log({"phase_seconds": {"variants_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    ssm_launches = ssm_path(torch)
    log({"phase_seconds": {"ssm_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    hybrid_launches = hybrid_path(torch)
    log({"phase_seconds": {"hybrid_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    cross_launches = cross_path(torch)
    log({"phase_seconds": {"cross_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    ldlq_launches = ldlq_path(torch)
    log({"phase_seconds": {"ldlq_path": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    sr_launches = schedule_resume_path(torch)
    log({"phase_seconds": {"schedule_resume_path":
                           time.perf_counter() - t0}})
    t0 = time.perf_counter()
    strategy_sweep(torch)
    log({"phase_seconds": {"strategy_sweep": time.perf_counter() - t0}})
    main_launches = dict(launches)
    launches["ldlq_block"] = ldlq_launches["ldlq_block"]
    launches.update({name: mla_launches[name] for name in KvAudit.MLA})
    launches["fwht"] += (mla_launches["fwht"] + moe_launches["fwht"]
                         + variant_launches["fwht"] + ssm_launches["fwht"]
                         + hybrid_launches["fwht"] + cross_launches["fwht"]
                         + ldlq_launches["fwht"] + sr_launches["fwht"])
    by_path = {"main_path": main_launches, "mla_path": mla_launches,
               "moe_path": moe_launches, "variants_path": variant_launches,
               "ssm_path": ssm_launches, "hybrid_path": hybrid_launches,
               "cross_path": cross_launches, "ldlq_path": ldlq_launches,
               "schedule_resume_path": sr_launches}
    # quant_matmul's three kernels, each with its launches on both paths;
    # quant_matmul_t's two on the MLA path
    qmm_rows = {"qmm_decode": rows["quant_matmul"],
                "qmm_tc": rows["quant_matmul_prefill"],
                "qmm_tc_f32": rows["quant_matmul_prefill_fp32"]}
    qmm_t_rows = {"qmm_t_decode": rows["quant_matmul_t"],
                  "qmm_t_tile": rows["quant_matmul_t_prefill"]}

    fd = "src/repro/kernels/flash_decode/kernel.py"
    csrc = "src/repro_torch/csrc"
    sources = {"gram": f"{csrc}/gram.cu",
               "attn_colsum": f"{csrc}/attn_colsum.cu",
               "quant_matmul": f"{csrc}/quant_matmul.cu",
               "quant_matmul_t": f"{csrc}/quant_matmul.cu",
               "flash_decode": f"{csrc}/flash_decode.cu",
               "paged_flash_decode": f"{csrc}/flash_decode.cu",
               "paged_flash_extend": f"{csrc}/flash_decode.cu",
               "mla_flash_decode": f"{csrc}/mla_decode.cu",
               "paged_mla_flash_decode": f"{csrc}/mla_decode.cu",
               "paged_mla_flash_extend": f"{csrc}/mla_decode.cu",
               "fwht": f"{csrc}/hadamard.cu",
               "solve_block": f"{csrc}/gptq_block.cu",
               "ldlq_block": f"{csrc}/ldlq_block.cu"}
    replaces = {"gram": "src/repro/kernels/gram/kernel.py:33",
                "attn_colsum": "src/repro/kernels/attn_colsum/kernel.py:74",
                "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:66",
                "quant_matmul_t":
                    "src/repro/kernels/quant_matmul/kernel.py:121",
                "flash_decode": f"{fd}:125",
                "paged_flash_decode": f"{fd}:207",
                "paged_flash_extend": f"{fd}:323",
                "mla_flash_decode": f"{fd}:438",
                "paged_mla_flash_decode": f"{fd}:520",
                "paged_mla_flash_extend": f"{fd}:632",
                "fwht": "src/repro/kernels/hadamard/kernel.py:51",
                # no Pallas kernel: the loops XLA compiles (row_step)
                "solve_block": "src/repro/core/gptq.py:127",
                "ldlq_block": "src/repro/core/ldlq.py:70"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    kernels = []
    for name in sources:
        row = rows[name]
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name], "launches": launches[name],
                 **{key: row[key] for key in keys}}
        if name == "quant_matmul":  # decode row; both prefill rows beside
            subs = {}
            for sub, kern in (("", "qmm_decode"), ("prefill", "qmm_tc"),
                              ("prefill_fp32", "qmm_tc_f32")):
                subs[sub] = {key: qmm_rows[kern][key] for key in keys}
                subs[sub].update(kernel=kern, kernel_launches={
                    path: counts[kern] for path, counts in by_path.items()})
            entry.update(subs.pop(""), **subs)
            # the expert stacks (E 160): the tensor-core tile at m 8 and
            # 96; jamba's (E 16) at m 8 and 40
            entry["experts"] = {
                f"{w}_m{m}": {key: rows[f"quant_matmul_experts_{w}_m{m}"][
                    key] for key in keys}
                for w in ("wi/wu", "wd")
                for m in (MOE_CAP_DECODE, MOE_CAP_CALIB)}
            entry["experts"].update({
                f"hybrid_{w}_m{m}": {key: rows[
                    f"quant_matmul_experts_hybrid_{w}_m{m}"][key]
                    for key in keys}
                for w in ("wi/wu", "wd")
                for m in (HYB_CAP_DECODE, HYB_CAP_PREFILL)})
            # jamba's Mamba projections: the decode (m 4) and the
            # tensor-core tile (m 256) on outputs narrower than a tile
            entry["hybrid"] = {
                f"{w}_m{m}": {key: rows[f"quant_matmul{pre}_hybrid_{w}"][key]
                              for key in keys}
                for w, _, _ in HYB_QMM
                for pre, m in (("", SERVE_BATCH),
                               ("_prefill", SERVE_BATCH * PROMPT_LEN))}
        if name == "quant_matmul_t":  # decode row; the prefill row beside
            entry["kernel"] = "qmm_t_decode"
            entry["kernel_launches"] = {
                "mla_path": mla_launches["qmm_t_decode"],
                "moe_path": moe_launches["qmm_t_decode"]}
            entry["prefill"] = {key: qmm_t_rows["qmm_t_tile"][key]
                                for key in keys}
            entry["prefill"].update(kernel="qmm_t_tile", kernel_launches={
                "mla_path": mla_launches["qmm_t_tile"],
                "moe_path": moe_launches["qmm_t_tile"]})
        if name == "attn_colsum":  # the causal row; the non-causal beside
            entry["kernel"] = "colsum_causal"
            entry["kernel_launches"] = {
                path: counts["colsum_causal"]
                for path, counts in by_path.items() if "colsum_causal"
                in counts}
            entry["noncausal"] = {key: rows["attn_colsum_noncausal"][key]
                                  for key in keys}
            entry["noncausal"].update(kernel="colsum_noncausal",
                                      kernel_launches={
                                          path: counts["colsum_noncausal"]
                                          for path, counts in by_path.items()
                                          if "colsum_noncausal" in counts})
        if name == "gram":  # the expert stacks: one launch a stack
            entry["experts"] = {f"d{d}": {key: rows[f"gram_experts_d{d}"][key]
                                          for key in keys}
                                for d in (MOE_D, MOE_F)}
            entry["experts"].update({
                f"hybrid_d{d}": {key: rows[f"gram_experts_hybrid_d{d}"][key]
                                 for key in keys}
                for d in (HYB_D, HYB_F)})
            # a vision batch's media rows: bf16, no importances
            entry["media"] = {key: rows["gram_media"][key] for key in keys}
        if name == "solve_block":  # every path calibrates through it
            entry["kernel_launches"] = {path: counts[name]
                                        for path, counts in by_path.items()}
            entry.update({key: row[key] for key in (
                "instance", "registers", "spill_store_bytes")})
            entry["pallas"] = ("none: the reference's XLA compiles this "
                               "loop (a fori_loop in the scan over blocks, "
                               "vmapped by gptq_quantize_batched)")
        if name == "ldlq_block":  # the LDLQ path calibrates through it
            entry["kernel_launches"] = {path: counts[name]
                                        for path, counts in by_path.items()
                                        if name in counts}
            entry.update({key: row[key] for key in (
                "instance", "registers", "spill_store_bytes",
                "row_cycles_measured")})
            entry["pallas"] = ("none: the reference's XLA compiles this "
                               "loop (a fori_loop in the scan over blocks, "
                               "vmapped by ldlq_quantize_batched)")
        if name in NO_PATH:
            entry["path"] = NO_PATH[name]
        entry["path_launches"] = {path: counts[name]
                                  for path, counts in by_path.items()
                                  if name in counts}
        kernels.append(entry)
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
