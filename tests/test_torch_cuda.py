"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: CUDA kernels have no CPU mode, so these skip on a machine
without an NVIDIA GPU.  They import neither JAX nor the reference, so on the
card they run without the JAX-based ``tests/conftest.py``:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances are relative to the largest reference magnitude:
  * fp32 products: 1e-5 — the kernel and the plain version sum the same
    fp32 terms in different orders;
  * attn_colsum: 1e-4 — two passes of exp on scores from three-term bf16
    products on the tensor cores; the column sums are added in a fixed
    order, so two calls give the same bits; the same for its non-causal
    form (an encoder's, at Whisper's 1500 frames);
  * bf16 outputs: 8e-3 — one rounding of the fp32 result to bf16
    (2^-8 relative) at a different point; the bf16 prefill product on the
    tensor cores (exact bf16 products of x and code - zero, fp32 sums, each
    group's sum scaled in fp32) is held to the same, and its rows are
    compared bitwise across m;
  * fwht: fp32 1e-5 (the butterfly stages' adds in another order), bf16
    8e-3 (the one rounding of the fp32 result);
  * quantized-KV attention: 1e-5 — the same dequantized fp32 terms, the
    scale applied after each row's dot product and sums in another order;
    the paged and the flat decode kernels are compared bitwise;
  * the engine under overload: bitwise, a preempted request's tokens are
    those of the same engine over a pool where nobody is preempted;
  * the captured decode loops (``runtime.graphs``): bitwise, a CUDA graph
    replays the launches of the Python loop on the same shapes, so
    ``generate`` and the engine give the same tokens and launch counts
    with ``loop="graph"`` and ``loop="python"``;
  * the batched gram (an (E, n, d) stack of expert buffers, one launch):
    1e-5 per matrix against its plain version, and each matrix bitwise
    the 2-D call on its rows; the expert-stack quant_matmul (E 160): one
    bf16 rounding (8e-3) per expert against its plain version;
  * MLA: the head-batched quant_matmul (expand) and quant_matmul_t
    (absorb) 1e-5 against each head's plain version (fp32 sums in another
    order), quant_matmul_t's rows compared bitwise across m; the latent
    attention kernels (tensor cores on the exact codes, every fp32 operand
    as three bf16 terms, scales after the product) 1e-5 against their
    plain versions, the paged and the flat latent decode bitwise, as are a
    request decoded alone and in a batch, and two calls.  With unscaled
    unit queries (scores of tens) the extend and the decode are held
    within 1e-5 of the function's float64 value, which their fp32 plain
    versions themselves miss by more than 1e-5;
  * GPTQ's in-block solve (``solve_block``): bitwise, codes, dequantized
    rows, errors, scales and zeros; each step is the one correctly rounded
    operation the plain loop performs, with no FMA contraction.  A whole
    ``gptq_quantize_batched`` on the kernel is bitwise the same solve on
    the plain loop (the rest of the solve is the same torch code);
  * LDLQ's in-block solve (``ldlq_block``): bitwise, dequantized rows and
    errors, signs of zeros included on the rounder's ties; the layer
    schedulers: the overlapped schedule bitwise the sequential one on the
    card (params, reports, artifact entries).
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import gptq as gptq_mod
from repro_torch.core.gptq import (gptq_quantize_batched, hinv_cholesky,
                                   prepare_hessian)
from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
from repro_torch.kernels.attn_colsum.ops import attn_colsum
from repro_torch.kernels.attn_colsum.ref import attn_colsum_ref
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  mla_flash_decode,
                                                  paged_flash_decode,
                                                  paged_flash_extend,
                                                  paged_mla_flash_decode,
                                                  paged_mla_flash_extend)
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  mla_flash_decode_ref,
                                                  paged_flash_decode_ref,
                                                  paged_flash_extend_ref,
                                                  paged_mla_flash_decode_ref,
                                                  paged_mla_flash_extend_ref)
from repro_torch.kernels.gptq_block.kernel import plan
from repro_torch.kernels.gptq_block.ops import solve_block
from repro_torch.kernels.gptq_block.ref import (solve_block_ref,
                                                solver_params,
                                                subnormal_tie_inputs)
from repro_torch.kernels.gram.ops import weighted_gram
from repro_torch.kernels.gram.ref import weighted_gram_ref
from repro_torch.kernels.hadamard.ops import fwht
from repro_torch.kernels.ldlq_block.kernel import plan as ldlq_plan
from repro_torch.kernels.ldlq_block.ops import ldlq_block
from repro_torch.kernels.ldlq_block.ref import (
    ldlq_block_ref, subnormal_tie_inputs as ldlq_subnormal_tie_inputs,
    tie_octets)
from repro_torch.kernels.hadamard.ref import fwht_ref
from repro_torch.kernels.quant_matmul.ops import (mla_latent_weights,
                                                  pack_weight, quant_matmul,
                                                  quant_matmul_t)
from repro_torch.kernels.quant_matmul.ref import (quant_matmul_ref,
                                                  quant_matmul_t_ref)
from repro_torch.launch.serve import generate
from repro_torch.models.attention import kv_codec
from repro_torch.models.lm import Model
from repro_torch.runtime.graphs import Replay, read_counts
from repro_torch.serving import (Engine, SamplingParams, ServeRequest,
                                 poisson_trace, run_trace)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("n,d,dtype", [
    (37, 200, torch.float32), (300, 128, torch.bfloat16),
    (2048, 4096, torch.float32)])
def test_gram_kernel_vs_plain(cuda, n, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((n,), generator=g, device=cuda)
    acc = torch.randn((d, d), generator=g, device=cuda)
    want = acc + 2.0 * weighted_gram_ref(x, r)
    before = weighted_gram.launches
    got = weighted_gram(x, r, out=acc.clone(), alpha=2.0)
    torch.cuda.synchronize()
    assert weighted_gram.launches == before + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [37, 300])
@pytest.mark.parametrize("d", [200, 4160, 130])
def test_gram_kernel_ragged_into_non_symmetric_out(cuda, d, n, dtype):
    """Ragged tiles (d 200, 4160 = 32.5 tiles; n not a multiple of the
    64-token stage; d 130, not a multiple of the 4-feature loads) added
    with alpha 2 into an accumulator that is not symmetric: the transposed
    half of every off-diagonal tile lands on its own entries."""
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((n,), generator=g, device=cuda)
    acc = torch.randn((d, d), generator=g, device=cuda)
    want = acc + 2.0 * weighted_gram_ref(x, r)
    got = weighted_gram(x, r, out=acc.clone(), alpha=2.0)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n,d,dtype", [
    (37, 200, torch.float32), (300, 4160, torch.bfloat16),
    (2048, 4096, torch.float32)])
def test_gram_kernel_symmetric_and_deterministic(cuda, n, d, dtype):
    """From a zero accumulator the kernel's result is bitwise symmetric
    (a diagonal tile's (i, j) and (j, i) take one value, an off-diagonal
    tile is written to both sides), and a second call gives the same
    bits (a fixed order of every sum, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((n,), generator=g, device=cuda)
    first = weighted_gram(x, r)
    second = weighted_gram(x, r)
    plain = weighted_gram(x)
    torch.cuda.synchronize()
    assert torch.equal(first, first.T)
    assert torch.equal(first, second)
    assert torch.equal(plain, plain.T)
    assert _rel(plain, weighted_gram_ref(x)) < 1e-5


def test_gram_kernel_non_finite_entries_as_plain(cuda):
    """An Inf and a NaN in x make the same entries non-finite as in the
    plain product, and leave every other entry within 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(22)
    x = torch.randn((100, 300), generator=g, device=cuda)
    x[3, 7] = float("inf")
    x[50, 200] = float("nan")
    want = weighted_gram_ref(x)
    got = weighted_gram(x)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert _rel(got[finite], want[finite]) < 1e-5


@pytest.mark.parametrize("with_r", [True, False], ids=["r", "no_r"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [48, 1536, 5120])
@pytest.mark.parametrize("n", [0, 1, 17, 96])
@pytest.mark.parametrize("e", [1, 3, 160])
def test_gram_kernel_batched_vs_plain(cuda, e, n, d, dtype, with_r):
    """A stack of E grams (the experts' capacity buffers: deepseek-v2's E
    160, n 96 at d 5120 and 1536) in one launch, each matrix within 1e-5 of
    its plain version, added with alpha 2 into a random accumulator (the
    160 x 5120² stack, 16.8 GB, from zero: no room for two copies)."""
    g = torch.Generator(device=cuda).manual_seed(e + n + d)
    x = torch.randn((e, n, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((e, n), generator=g, device=cuda) if with_r else None
    big = e * d * d > 2 ** 30
    acc = None if big else torch.randn((e, d, d), generator=g, device=cuda)
    before = weighted_gram.launches
    got = weighted_gram(x, r, out=None if big else acc.clone(), alpha=2.0)
    torch.cuda.synchronize()
    assert weighted_gram.launches == before + 1
    assert got.shape == (e, d, d)
    for c in range(0, e, 16):
        want = 2.0 * weighted_gram_ref(x[c:c + 16],
                                       None if r is None else r[c:c + 16])
        if acc is not None:
            want += acc[c:c + 16]
        assert _rel(got[c:c + 16], want) < 1e-5, c
    del got, acc
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,d", [(96, 1536), (300, 200), (17, 48)])
def test_gram_kernel_batch_member_bitwise_the_2d_call(cuda, n, d, dtype):
    """Each matrix of a batched call is bitwise the 2-D call on its own
    rows (the batch is the grid's second axis and nothing else), and a
    batch of one is the 2-D call."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((3, n, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((3, n), generator=g, device=cuda)
    acc = torch.randn((3, d, d), generator=g, device=cuda)
    got = weighted_gram(x, r, out=acc.clone(), alpha=2.0)
    one = weighted_gram(x[:1], r[:1], out=acc[:1].clone(), alpha=2.0)
    for i in range(3):
        two_d = weighted_gram(x[i], r[i], out=acc[i].clone(), alpha=2.0)
        assert torch.equal(got[i], two_d), i
        if i == 0:
            assert torch.equal(one[0], two_d)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,t,h,kv,dh,dtype", [
    (2, 100, 4, 2, 16, torch.float32), (1, 512, 32, 8, 128, torch.float32),
    (2, 64, 4, 4, 40, torch.bfloat16)])
def test_attn_colsum_kernel_vs_plain(cuda, b, t, h, kv, dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, t, kv, dh), generator=g, device=cuda).to(dtype)
    want = attn_colsum_ref(q, k)
    before = attn_colsum.launches
    got = attn_colsum(q, k)
    torch.cuda.synchronize()
    assert attn_colsum.launches == before + 1
    assert got.shape == (b, t)
    assert _rel(got, want) < 1e-4
    # every query's softmax row sums to one: the column mass totals T·H
    np.testing.assert_allclose(got.sum(-1).cpu().numpy(), t * h, rtol=1e-4)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 70])
@pytest.mark.parametrize("k,n,gs", [(384, 200, 128), (300, 96, 100)])
def test_quant_matmul_kernel_vs_plain(cuda, bits, m, k, n, gs):
    g = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn((k, n), generator=g, device=cuda)
    _, q, scale, zero = quantize_weight_rtn(w, QuantSpec(bits, gs))
    pw = pack_weight(q, scale, zero, QuantSpec(bits, gs))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
        want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                                bits=bits, group_size=gs)
        before = quant_matmul.launches
        got = quant_matmul(x, pw)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        assert _rel(got, want) < tol



def _packed(device, bits, k, n, gs, seed, positive=False):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=device) * k ** -0.5
    if positive:
        w = w.abs()
    spec = QuantSpec(bits, gs)
    _, q, scale, zero = quantize_weight_rtn(w, spec)
    return pack_weight(q, scale, zero, spec), g


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [5, 64, 65, 200, 512])
@pytest.mark.parametrize("k,n,gs", [(640, 200, 128), (512, 136, 128),
                                    (300, 96, 100), (300, 96, -1),
                                    (256, 70, 32)])
def test_quant_matmul_bf16_prefill_kernel_vs_plain(cuda, bits, m, k, n, gs):
    """The bf16 prefill kernel (m > 4, tensor cores): ragged m and n, the
    ragged 3-bit word (k 512), groups that do not align with 16-row steps
    (gs 100, and one group of 300 rows), k not a multiple of 8, and more
    groups per k-tile than the kernel stages (gs 32) on rows of words and
    scales that are not 16-byte aligned (n 70)."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=9)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                            bits=bits, group_size=pw.group_size)
    before = quant_matmul.launches
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _rel(got, want) < 8e-3


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k,n,gs", [(640, 200, 128), (300, 96, 100)])
def test_quant_matmul_bf16_prefill_rows_do_not_depend_on_m(cuda, bits, k, n,
                                                           gs):
    """Rows 0-63 of an m 512 product are bitwise the same rows computed at
    m 64: a prompt's logits do not depend on what shares its call."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=10)
    x = torch.randn((512, k), generator=g, device=cuda).to(torch.bfloat16)
    full = quant_matmul(x, pw)
    part = quant_matmul(x[:64].clone(), pw)
    torch.cuda.synchronize()
    assert torch.equal(full[:64], part)


@pytest.mark.parametrize("bits", [3, 4])
def test_quant_matmul_bf16_prefill_head_batched_views(cuda, bits):
    """bf16 x through the prefill kernel on strided per-head views of one
    packed weight (MLA's wkv_b layout): each head against its own plain
    call."""
    h, dn, dv, kvr, m = 4, 128, 128, 512, 70
    g = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn((kvr, h * (dn + dv)), generator=g, device=cuda)
    spec = QuantSpec(bits, 128)
    _, q, scale, zero = quantize_weight_rtn(w, spec)
    _, pw_v = mla_latent_weights(pack_weight(q, scale, zero, spec), h, dn, dv)
    x = torch.randn((h, m, kvr), generator=g, device=cuda).to(torch.bfloat16)
    got = quant_matmul(x, pw_v)
    torch.cuda.synchronize()
    for i in range(h):
        want = quant_matmul_ref(x[i].float(), pw_v.w_packed[i], pw_v.scale[i],
                                pw_v.zero[i], bits=bits, group_size=128,
                                d_in=kvr)
        assert _rel(got[i], want) < 8e-3, i


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [5, 64, 65, 200, 512])
@pytest.mark.parametrize("k,n,gs", [(640, 200, 128), (512, 136, 128),
                                    (300, 96, 100), (300, 96, -1),
                                    (256, 70, 32), (302, 96, 151)])
def test_quant_matmul_fp32_prefill_kernel_vs_plain(cuda, bits, m, k, n, gs):
    """The fp32 prefill (m > 4): the tensor-core tile with x split into
    three bf16 terms, on the bf16 prefill's cases (ragged m, n and 3-bit
    word, gs 100 crossing 16-row steps, one group of 300 rows, gs 32 on
    unaligned rows) and k 302, whose fp32 rows are not 16-byte aligned."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=13)
    x = torch.randn((m, k), generator=g, device=cuda)
    want = quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero, bits=bits,
                            group_size=pw.group_size)
    before, by = quant_matmul.launches, quant_matmul.by_kernel["qmm_tc_f32"]
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert quant_matmul.by_kernel["qmm_tc_f32"] == by + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("m", [65, 256])
@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("gs", [128, -1])
@pytest.mark.parametrize("positive", [False, True], ids=["normal", "positive"])
def test_quant_matmul_fp32_prefill_long_rows(cuda, bits, m, k, gs, positive):
    """fp32 x over llama3-8b's row lengths (k 4096, and 14336: wd's d_in)
    in groups of 128 and in one group for the whole row (gs -1, the
    per-tensor fallback), within 1e-5: no tensor-core sum spans more than
    one 128-row tile.  The positive case (x and W >= 0, every partial sum
    growing) is where truncating sums drift furthest."""
    pw, g = _packed(cuda, bits, k, 200, gs, seed=17, positive=positive)
    x = torch.randn((m, k), generator=g, device=cuda)
    if positive:
        x = x.abs()
    want = quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero, bits=bits,
                            group_size=pw.group_size)
    by = quant_matmul.by_kernel["qmm_tc_f32"]
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.by_kernel["qmm_tc_f32"] == by + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k,n,gs", [(640, 200, 128), (300, 96, 100),
                                    (4096, 200, -1), (1200, 96, 300)])
def test_quant_matmul_fp32_prefill_rows_do_not_depend_on_m(cuda, bits, k, n,
                                                           gs):
    """Rows 0-63 of an fp32 m 512 product are bitwise the rows computed at
    m 64 and m 65."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=14)
    x = torch.randn((512, k), generator=g, device=cuda)
    full = quant_matmul(x, pw)
    part = quant_matmul(x[:64].clone(), pw)
    odd = quant_matmul(x[:65].clone(), pw)
    torch.cuda.synchronize()
    assert torch.equal(full[:64], part)
    assert torch.equal(full[:65], odd)


def _packed_stack(w: torch.Tensor, spec: QuantSpec):
    """An (E, k, n) expert stack RTN-packed expert by expert into one
    (E, ·, n) ``PackedWeight``."""
    parts = []
    for e in range(w.shape[0]):
        _, q, sc, zr = quantize_weight_rtn(w[e].float(), spec)
        parts.append(pack_weight(q, sc, zr, spec))
    return dataclasses.replace(
        parts[0], w_packed=torch.stack([p.w_packed for p in parts]),
        scale=torch.stack([p.scale for p in parts]),
        zero=torch.stack([p.zero for p in parts]))


@pytest.mark.parametrize("m", [8, 96])
@pytest.mark.parametrize("k,n", [(5120, 1536), (1536, 5120)])
def test_quant_matmul_expert_stack_vs_plain(cuda, m, k, n):
    """deepseek-v2's expert stacks (E 160, 3-bit, group 128: wi / wu 5120
    -> 1536, wd 1536 -> 5120) at the decode capacity (m 8) and the
    calibration's (m 96): one launch for all 160 experts, each expert's
    bf16 output within one bf16 rounding of its plain version."""
    g = torch.Generator(device=cuda).manual_seed(24)
    w = torch.randn((160, k, n), generator=g, device=cuda) * k ** -0.5
    pw = _packed_stack(w, QuantSpec(3, 128))
    del w
    x = torch.randn((160, m, k), generator=g, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert got.shape == (160, m, n) and got.dtype == torch.bfloat16
    for e in range(160):
        want = quant_matmul_ref(x[e].float(), pw.w_packed[e], pw.scale[e],
                                pw.zero[e], bits=3, group_size=128, d_in=k)
        assert _rel(got[e], want) < 8e-3, e


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [5, 128, 200])
def test_quant_matmul_fp32_prefill_head_batched_views(cuda, bits, m):
    """fp32 x through the prefill kernel on strided per-head views of one
    packed weight (MLA's expand on wkv_b, H 4): each head against its own
    plain call within 1e-5."""
    h, dn, dv, kvr = 4, 128, 128, 512
    g = torch.Generator(device=cuda).manual_seed(15)
    w = torch.randn((kvr, h * (dn + dv)), generator=g, device=cuda)
    spec = QuantSpec(bits, 128)
    _, q, scale, zero = quantize_weight_rtn(w, spec)
    _, pw_v = mla_latent_weights(pack_weight(q, scale, zero, spec), h, dn, dv)
    x = torch.randn((h, m, kvr), generator=g, device=cuda)
    got = quant_matmul(x, pw_v)
    torch.cuda.synchronize()
    for i in range(h):
        want = quant_matmul_ref(x[i], pw_v.w_packed[i], pw_v.scale[i],
                                pw_v.zero[i], bits=bits, group_size=128,
                                d_in=kvr)
        assert _rel(got[i], want) < 1e-5, i


def test_quant_matmul_fp32_prefill_non_finite_rows_as_plain(cuda):
    """An Inf and a NaN in fp32 x make the same outputs non-finite as the
    plain version (their rows), the other rows within 1e-5."""
    pw, g = _packed(cuda, 3, 384, 200, 128, seed=16)
    x = torch.randn((70, 384), generator=g, device=cuda)
    x[3, 7] = float("inf")
    x[40, 300] = float("nan")
    want = quant_matmul_ref(x, pw.w_packed, pw.scale, pw.zero, bits=3,
                            group_size=128)
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert _rel(got[finite], want[finite]) < 1e-5


@pytest.mark.parametrize("m,dtype,kernel", [
    (4, torch.bfloat16, "qmm_decode"), (4, torch.float32, "qmm_decode"),
    (5, torch.bfloat16, "qmm_tc"), (5, torch.float32, "qmm_tc_f32")])
def test_quant_matmul_counts_the_kernel_that_ran(cuda, m, dtype, kernel):
    """A launch adds one to quant_matmul's count and to its kernel's."""
    pw, g = _packed(cuda, 3, 256, 64, 128, seed=12)
    x = torch.randn((m, 256), generator=g, device=cuda).to(dtype)
    before, by = quant_matmul.launches, dict(quant_matmul.by_kernel)
    quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert quant_matmul.by_kernel == dict(by, **{kernel: by[kernel] + 1})


@pytest.mark.parametrize("log2_d", range(16))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fwht_kernel_vs_plain(cuda, log2_d, dtype):
    d = 1 << log2_d
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    g = torch.Generator(device=cuda).manual_seed(log2_d)
    for n in (1, 3, 1000):
        x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
        before = fwht.launches
        got = fwht(x)
        torch.cuda.synchronize()
        assert fwht.launches == before + 1
        assert got.dtype == dtype and got.shape == (n, d)
        assert _rel(got, fwht_ref(x)) < tol, n


def test_fwht_kernel_rejects_wider_rows(cuda):
    with pytest.raises(ValueError, match="exceeds"):
        fwht(torch.zeros((2, 1 << 16), device=cuda))

def _kv_cache(g, b, s, kv, d, kv_bits, device, page=64):
    """Random K/V encoded by the port's codec: (kq, ks, vq, vs)."""
    codec = kv_codec(kv_bits, page)
    out = []
    for _ in range(2):
        x = torch.randn((b, s, kv, d), generator=g, device=device)
        out.extend(codec.encode(x))
    return out[0], out[1], out[2], out[3], codec.chunk


def _finalized(acc, l):
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("b,s,kv,grp,d,pos", [
    (2, 192, 2, 4, 16, 150), (1, 100, 2, 2, 40, 99), (3, 700, 4, 4, 128, 37),
    (2, 1088, 8, 4, 128, 1087)])
def test_flash_decode_kernel_vs_plain(cuda, kv_bits, b, s, kv, grp, d, pos):
    g = torch.Generator(device=cuda).manual_seed(3)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    acc, _, l = flash_decode_ref(q, kq, ks, vq, vs, pos, kv_bits=kv_bits,
                                 chunk=chunk, dh=d, dv=d, tile=64)
    want = _finalized(acc, l)
    for p in (pos, torch.full((b,), pos, dtype=torch.int32, device=cuda)):
        before = flash_decode.launches
        got = flash_decode(q, kq, ks, vq, vs, p, kv_bits=kv_bits,
                           chunk=chunk, dv=d, tile=64)
        torch.cuda.synchronize()
        assert flash_decode.launches == before + 1
        assert got.shape == (b, kv, grp, d)
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("d,pos", [(16, [70, 191, 0]), (128, [37, 500, 255]),
                                   (40, [64, 63, 129])])
def test_paged_flash_decode_kernel_vs_plain_and_flat(cuda, kv_bits, d, pos):
    """Pages scattered through a shuffled table with a trash entry past
    every request's position: paged kernel == plain version within 1e-5
    and == the flat kernel on the same codes bitwise (tile = page)."""
    page, b, kv, grp = 64, len(pos), 2, 4
    s = 512
    g = torch.Generator(device=cuda).manual_seed(4)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    n_tiles = s // page
    perm = torch.randperm(b * n_tiles, generator=torch.Generator()
                          .manual_seed(5)) + 1     # page 0 stays trash
    tbl = perm.reshape(b, n_tiles).to(torch.int32)
    n_pages = b * n_tiles + 1
    pools = []
    for codes, scales in ((kq, ks), (vq, vs)):
        cp = torch.zeros((n_pages, page) + codes.shape[2:], dtype=codes.dtype,
                         device=cuda)
        sp = torch.zeros((n_pages, page // chunk) + scales.shape[2:],
                         dtype=scales.dtype, device=cuda)
        cp[tbl.reshape(-1).long()] = codes.reshape((b * n_tiles, page)
                                                   + codes.shape[2:])
        sp[tbl.reshape(-1).long()] = scales.reshape(
            (b * n_tiles, page // chunk) + scales.shape[2:])
        pools += [cp, sp]
    # stale data in the trash page, and a trash entry past every position
    pools[0][0] = kq[0, :page]
    tbl = torch.cat([tbl, torch.zeros((b, 1), dtype=torch.int32)], 1).to(cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    acc, _, l = paged_flash_decode_ref(tbl, pos_t, q, *pools, kv_bits=kv_bits,
                                       chunk=chunk, dh=d, dv=d, page=page)
    before = paged_flash_decode.launches
    got = paged_flash_decode(tbl, pos_t, q, *pools, kv_bits=kv_bits,
                             chunk=chunk, dv=d, page=page)
    flat = flash_decode(q, kq, ks, vq, vs, pos_t, kv_bits=kv_bits,
                        chunk=chunk, dv=d, tile=page)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert _rel(got, _finalized(acc, l)) < 1e-5
    assert torch.equal(got, flat)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L,d", [(0, 37, 16), (3, 64, 40),
                                        (2, 1, 128), (4, 200, 128)])
def test_paged_flash_extend_kernel_vs_plain(cuda, kv_bits, n_past, L, d):
    page, kv, h = 64, 2, 8
    g = torch.Generator(device=cuda).manual_seed(6)
    n_pages = n_past + 3
    kq, ks, vq, vs, chunk = _kv_cache(g, 1, n_pages * page, kv, d, kv_bits,
                                      cuda)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape((n_pages, page // chunk) + ks.shape[2:]),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape((n_pages, page // chunk) + vs.shape[2:])]
    tbl = torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(7))[:n_past].to(torch.int32) + 1
    tbl = tbl.to(cuda)
    q = torch.randn((1, L, h, d), generator=g, device=cuda)
    k_new = torch.randn((1, L, kv, d), generator=g, device=cuda)
    v_new = torch.randn((1, L, kv, d), generator=g, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page)
    want = paged_flash_extend_ref(tbl, q, k_new, v_new, *pools, **kw)
    before = paged_flash_extend.launches
    got = paged_flash_extend(tbl, q, k_new, v_new, *pools, **kw)
    torch.cuda.synchronize()
    assert paged_flash_extend.launches == before + 1
    assert got.shape == (1, L, h, d)
    assert _rel(got, want) < 1e-5


def _paged_pools(kq, ks, vq, vs, chunk, page, extra, seed):
    """The flat cache's pages scattered through a shuffled table (page 0 is
    trash) with ``extra`` trash columns past every request's tiles:
    (tbl, [kq, ks, vq, vs] pools)."""
    b, s = kq.shape[:2]
    n_tiles = s // page
    perm = torch.randperm(b * n_tiles, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    tbl = perm.reshape(b, n_tiles).to(torch.int32)
    pools = []
    for codes, scales in ((kq, ks), (vq, vs)):
        cp = torch.zeros((b * n_tiles + 1, page) + codes.shape[2:],
                         dtype=codes.dtype, device=codes.device)
        sp = torch.zeros((b * n_tiles + 1, page // chunk) + scales.shape[2:],
                         dtype=scales.dtype, device=scales.device)
        cp[tbl.reshape(-1).long()] = codes.reshape((b * n_tiles, page)
                                                   + codes.shape[2:])
        sp[tbl.reshape(-1).long()] = scales.reshape(
            (b * n_tiles, page // chunk) + scales.shape[2:])
        pools += [cp, sp]
    tbl = torch.cat([tbl, torch.zeros((b, extra), dtype=torch.int32)], 1)
    return tbl.to(kq.device), pools


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("grp,d", [(16, 256), (8, 128), (16, 40)])
def test_flash_decode_kernels_at_the_limits(cuda, kv_bits, grp, d):
    """G up to 16 (queries in shared memory) and Dh up to 256 (two V
    columns per lane), flat and paged: within 1e-5 of the plain version,
    paged == flat bitwise."""
    page, b, kv, s = 64, 2, 2, 320
    pos = [319, 130]
    g = torch.Generator(device=cuda).manual_seed(21)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    acc, _, l = flash_decode_ref(q, kq, ks, vq, vs, pos_t, kv_bits=kv_bits,
                                 chunk=chunk, dh=d, dv=d, tile=page)
    flat = flash_decode(q, kq, ks, vq, vs, pos_t, kv_bits=kv_bits,
                        chunk=chunk, dv=d, tile=page)
    tbl, pools = _paged_pools(kq, ks, vq, vs, chunk, page, 1, 22)
    paged = paged_flash_decode(tbl, pos_t, q, *pools, kv_bits=kv_bits,
                               chunk=chunk, dv=d, page=page)
    torch.cuda.synchronize()
    assert _rel(flat, _finalized(acc, l)) < 1e-5
    assert torch.equal(paged, flat)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("extra", [1, 2, 5])
def test_paged_flash_decode_wide_table_equals_flat(cuda, kv_bits, extra):
    """A page table wider than the flat cache's tile count (trash columns
    past every position, crossing split boundaries) changes nothing:
    paged == flat bitwise."""
    page, b, kv, grp, d, s = 64, 3, 2, 4, 128, 448
    pos_t = torch.tensor([447, 200, 63], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(23)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    tbl, pools = _paged_pools(kq, ks, vq, vs, chunk, page, extra, 24)
    paged = paged_flash_decode(tbl, pos_t, q, *pools, kv_bits=kv_bits,
                               chunk=chunk, dv=d, page=page)
    flat = flash_decode(q, kq, ks, vq, vs, pos_t, kv_bits=kv_bits,
                        chunk=chunk, dv=d, tile=page)
    acc, _, l = paged_flash_decode_ref(tbl, pos_t, q, *pools,
                                       kv_bits=kv_bits, chunk=chunk, dh=d,
                                       dv=d, page=page)
    torch.cuda.synchronize()
    assert torch.equal(paged, flat)
    assert _rel(paged, _finalized(acc, l)) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_flash_decode_never_reads_rows_past_pos(cuda, kv_bits):
    """The trash page and every scale past each request's position hold
    NaN / inf (kv2: whole scale chunks past pos), with stale codes: the
    kernels' results are bitwise those on the clean cache, within 1e-5 of
    the plain version on the clean cache (whose 0 * NaN would propagate),
    and paged == flat bitwise."""
    page, b, kv, grp, d, s = 64, 3, 2, 4, 128, 384
    pos = [300, 64, 127]
    g = torch.Generator(device=cuda).manual_seed(25)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    bad = (float("nan"), float("inf"), float("-inf"))
    pks, pvs = ks.clone(), vs.clone()
    for i, p in enumerate(pos):
        first = p // chunk + 1  # the first scale row wholly past pos
        for j, sc in enumerate((pks, pvs)):
            sc[i, first:] = bad[(i + j) % 3]
    tbl, clean = _paged_pools(kq, ks, vq, vs, chunk, page, 1, 26)
    _, poisoned = _paged_pools(kq, pks, vq, pvs, chunk, page, 1, 26)
    for pool in (poisoned[1], poisoned[3]):
        pool[0] = float("nan")  # the trash page
    poisoned[0][0] = kq[0, :page]  # stale codes in the trash page
    kw = dict(kv_bits=kv_bits, chunk=chunk, dv=d)
    want = paged_flash_decode(tbl, pos_t, q, *clean, page=page, **kw)
    got = paged_flash_decode(tbl, pos_t, q, *poisoned, page=page, **kw)
    flat = flash_decode(q, kq, pks, vq, pvs, pos_t, tile=page, **kw)
    acc, _, l = paged_flash_decode_ref(tbl, pos_t, q, *clean, dh=d,
                                       page=page, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert torch.equal(flat, got)
    assert _rel(got, _finalized(acc, l)) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("n_past,L,h,kv,d", [
    (2, 70, 16, 1, 256), (0, 33, 32, 2, 256), (3, 100, 16, 1, 40)])
def test_paged_flash_extend_kernel_at_the_limits(cuda, kv_bits, dtype,
                                                 n_past, L, h, kv, d):
    """G 16 and Dh 256 (the limits) and a ragged Dh, with bf16 inputs
    (exact on the tensor cores) and fp32 inputs (split into TF32 hi + lo)."""
    page = 64
    g = torch.Generator(device=cuda).manual_seed(27)
    n_pages = n_past + 2
    kq, ks, vq, vs, chunk = _kv_cache(g, 1, n_pages * page, kv, d, kv_bits,
                                      cuda)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape((n_pages, page // chunk) + ks.shape[2:]),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape((n_pages, page // chunk) + vs.shape[2:])]
    tbl = (torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(28))[:n_past].to(torch.int32)
           + 1).to(cuda)
    q, k_new, v_new = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                       for shape in ((1, L, h, d), (1, L, kv, d),
                                     (1, L, kv, d)))
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page)
    want = paged_flash_extend_ref(tbl, q, k_new, v_new, *pools, **kw)
    got = paged_flash_extend(tbl, q, k_new, v_new, *pools, **kw)
    torch.cuda.synchronize()
    assert got.shape == (1, L, h, d) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L", [(0, 128), (3, 128), (16, 256)])
def test_paged_flash_extend_kernel_bf16_as_the_model_passes(cuda, kv_bits,
                                                            n_past, L):
    """bf16 q / k_new / v_new at llama3-8b's heads (32 / 8, Dh 128), as
    ``models.attention`` passes them: within 1e-5 of the plain version."""
    page, h, kv, d = 64, 32, 8, 128
    g = torch.Generator(device=cuda).manual_seed(29)
    n_pages = n_past + 1
    kq, ks, vq, vs, chunk = _kv_cache(g, 1, n_pages * page, kv, d, kv_bits,
                                      cuda)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape((n_pages, page // chunk) + ks.shape[2:]),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape((n_pages, page // chunk) + vs.shape[2:])]
    tbl = (torch.randperm(n_past, generator=torch.Generator()
                          .manual_seed(30)).to(torch.int32) + 1).to(cuda)
    q, k_new, v_new = (torch.randn(shape, generator=g, device=cuda).to(
        torch.bfloat16) for shape in ((1, L, h, d), (1, L, kv, d),
                                      (1, L, kv, d)))
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page)
    want = paged_flash_extend_ref(tbl, q, k_new, v_new, *pools, **kw)
    before = paged_flash_extend.launches
    got = paged_flash_extend(tbl, q, k_new, v_new, *pools, **kw)
    torch.cuda.synchronize()
    assert paged_flash_extend.launches == before + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("page,n_past", [(16, 3), (16, 8), (48, 3), (48, 4),
                                         (96, 2)])
def test_paged_flash_extend_kernel_at_other_page_sizes(cuda, kv_bits, dtype,
                                                       page, n_past):
    """Pages (``cfg.kv_chunk``) that are not 64 against the kernel's 32-key
    tiles: at 16 a tile spans two pages, at 48 every other tile starts
    partway into a page and ends in the next, at 96 a page holds three
    tiles; at n_past * page not a multiple of 32 the last past tile is
    partial.  Within 1e-5 of the plain version."""
    L, h, kv, d = 70, 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(31)
    n_pages = n_past + 2
    kq, ks, vq, vs, chunk = _kv_cache(g, 1, n_pages * page, kv, d, kv_bits,
                                      cuda, page=page)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape((n_pages, page // chunk) + ks.shape[2:]),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape((n_pages, page // chunk) + vs.shape[2:])]
    tbl = (torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(32))[:n_past].to(torch.int32)
           + 1).to(cuda)
    q, k_new, v_new = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                       for shape in ((1, L, h, d), (1, L, kv, d),
                                     (1, L, kv, d)))
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page)
    want = paged_flash_extend_ref(tbl, q, k_new, v_new, *pools, **kw)
    before = paged_flash_extend.launches
    got = paged_flash_extend(tbl, q, k_new, v_new, *pools, **kw)
    torch.cuda.synchronize()
    assert paged_flash_extend.launches == before + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("page", [16, 48, 96])
def test_paged_flash_decode_at_other_page_sizes(cuda, kv_bits, page):
    """Tiles (= pages) of 16, 48 and 96 rows, flat and paged: within 1e-5 of
    the plain version, paged == flat bitwise."""
    b, kv, grp, d, n_tiles = 3, 2, 4, 128, 7
    s = n_tiles * page
    pos_t = torch.tensor([s - 1, 3 * page + 5, 0], dtype=torch.int32,
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(33)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda,
                                      page=page)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda)
    tbl, pools = _paged_pools(kq, ks, vq, vs, chunk, page, 1, 34)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dv=d)
    flat = flash_decode(q, kq, ks, vq, vs, pos_t, tile=page, **kw)
    paged = paged_flash_decode(tbl, pos_t, q, *pools, page=page, **kw)
    acc, _, l = flash_decode_ref(q, kq, ks, vq, vs, pos_t, dh=d, tile=page,
                                 **kw)
    torch.cuda.synchronize()
    assert _rel(flat, _finalized(acc, l)) < 1e-5
    assert torch.equal(paged, flat)


# ------------------------------------------------------------------- MLA


def _wkv_b(cuda, bits, h, dn, dv, kvr, gs, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((kvr, h * (dn + dv)), generator=g, device=cuda)
    spec = QuantSpec(bits, gs)
    _, q, scale, zero = quantize_weight_rtn(w, spec)
    return pack_weight(q, scale, zero, spec), g


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("h,m,kvr,gs", [(4, 1, 256, 128), (8, 4, 512, 128),
                                        (3, 9, 130, 130), (128, 4, 512, 128),
                                        (16, 70, 512, 128)])
def test_mla_absorb_and_expand_kernels_vs_plain(cuda, bits, h, m, kvr, gs):
    """One launch each for all heads, on strided views of one packed wkv_b:
    quant_matmul_t (row 4) and the head-batched quant_matmul (row 3), each
    head against its own plain call."""
    dn, dv = 128, 128
    pw, g = _wkv_b(cuda, bits, h, dn, dv, kvr, gs, seed=8)
    pw_k, pw_v = mla_latent_weights(pw, h, dn, dv)
    assert not pw_k.w_packed.is_contiguous()
    qn = torch.randn((h, m, dn), generator=g, device=cuda)
    cl = torch.randn((h, m, kvr), generator=g, device=cuda)
    before = (quant_matmul_t.launches, quant_matmul.launches)
    lat = quant_matmul_t(qn, pw_k)
    ctx = quant_matmul(cl, pw_v)
    torch.cuda.synchronize()
    assert (quant_matmul_t.launches, quant_matmul.launches) == (
        before[0] + 1, before[1] + 1)
    assert lat.shape == (h, m, kvr) and ctx.shape == (h, m, dv)
    for i in range(h):
        want_k = quant_matmul_t_ref(qn[i], pw_k.w_packed[i], pw_k.scale[i],
                                    pw_k.zero[i], bits=bits, group_size=gs,
                                    d_in=kvr)
        want_v = quant_matmul_ref(cl[i], pw_v.w_packed[i], pw_v.scale[i],
                                  pw_v.zero[i], bits=bits, group_size=gs,
                                  d_in=kvr)
        assert _rel(lat[i], want_k) < 1e-5, i
        assert _rel(ctx[i], want_v) < 1e-5, i


def _latent(g, b, s, d, kv_bits, device, page=64):
    codec = kv_codec(kv_bits, page)
    return codec.encode(torch.randn((b, s, d), generator=g, device=device))


# the engine's MLA decode: 4 slots at positions 512-575 over 9 pages of 64,
# one slot at position 0
ENGINE_POS = (575, 543, 512, 0)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("b,s,h,dl,dr,pos", [
    (2, 192, 4, 32, 16, 150), (1, 100, 3, 40, 8, 99),
    (2, 1088, 128, 512, 64, 1087), (4, 700, 20, 512, 64, 37),
    (4, 576, 128, 512, 64, ENGINE_POS)])
def test_mla_flash_decode_kernel_vs_plain(cuda, kv_bits, b, s, h, dl, dr,
                                          pos):
    """One position for every request (an int and a (B,) tensor), or one
    each (the engine's four)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    cq, cs = _latent(g, b, s, dl, kv_bits, cuda)
    rq, rs = _latent(g, b, s, dr, kv_bits, cuda)
    chunk = kv_codec(kv_bits, 64).chunk
    ql = torch.randn((b, h, dl), generator=g, device=cuda) * 0.05
    qr = torch.randn((b, h, dr), generator=g, device=cuda) * 0.05
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr)
    pos_t = torch.tensor(pos if isinstance(pos, tuple) else (pos,) * b,
                         dtype=torch.int32, device=cuda)
    acc, _, l = mla_flash_decode_ref(ql, qr, cq, cs, rq, rs, pos_t, tile=64,
                                     **kw)
    want = _finalized(acc, l)
    for p in ((pos_t,) if isinstance(pos, tuple) else (pos, pos_t)):
        before = mla_flash_decode.launches
        got = mla_flash_decode(ql, qr, cq, cs, rq, rs, p, tile=64, **kw)
        torch.cuda.synchronize()
        assert mla_flash_decode.launches == before + 1
        assert got.shape == (b, h, dl)
        assert _rel(got, want) < 1e-5


def _paged_latent(cuda, kv_bits, b, s, dl, dr, h, seed, page=64,
                  trash=None):
    """A flat latent cache of b x s rows and the same codes in pools of
    ``page``-row pages under a shuffled table with a trash entry past
    every position; stale codes on the trash page (0).  Slot ``trash``
    is inactive: its table row is the trash page throughout.  Returns
    (flat (cq, cs, rq, rs), pools, tbl, ql, qr, chunk)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cq, cs = _latent(g, b, s, dl, kv_bits, cuda)
    rq, rs = _latent(g, b, s, dr, kv_bits, cuda)
    chunk = kv_codec(kv_bits, page).chunk
    ql = torch.randn((b, h, dl), generator=g, device=cuda) * 0.05
    qr = torch.randn((b, h, dr), generator=g, device=cuda) * 0.05
    n_tiles = s // page
    perm = torch.randperm(b * n_tiles, generator=torch.Generator()
                          .manual_seed(seed + 1)) + 1
    tbl = perm.reshape(b, n_tiles).to(torch.int32)
    pools = []
    for codes, scales in ((cq, cs), (rq, rs)):
        cp = torch.zeros((b * n_tiles + 1, page, codes.shape[-1]),
                         dtype=codes.dtype, device=cuda)
        sp = torch.zeros((b * n_tiles + 1, page // chunk),
                         dtype=scales.dtype, device=cuda)
        cp[perm.to(cuda)] = codes.reshape(b * n_tiles, page, -1)
        sp[perm.to(cuda)] = scales.reshape(b * n_tiles, page // chunk)
        pools += [cp, sp]
    pools[0][0] = cq[0, :page]
    tbl = torch.cat([tbl, torch.zeros((b, 1), dtype=torch.int32)], 1)
    if trash is not None:
        tbl[trash] = 0
    return (cq, cs, rq, rs), pools, tbl.to(cuda), ql, qr, chunk


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("h,dl,dr,pos,trash", [
    (4, 32, 16, [70, 511, 0], None), (128, 512, 64, [37, 500, 255], None),
    (128, 512, 64, list(ENGINE_POS), 3)])
def test_paged_mla_flash_decode_kernel_vs_plain_and_flat(cuda, kv_bits, h,
                                                         dl, dr, pos, trash):
    """Shuffled page table with a trash entry past every position and stale
    codes on the trash page: paged == plain within 1e-5 and == the flat
    kernel bitwise (tile = page).  At the engine's shape one slot is
    inactive, its table row all trash (held to the plain version only)."""
    page, b = 64, len(pos)
    s = -(-(max(pos) + 1) // page) * page
    flat, pools, tbl, ql, qr, chunk = _paged_latent(
        cuda, kv_bits, b, s, dl, dr, h, seed=10, trash=trash)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr)
    acc, _, l = paged_mla_flash_decode_ref(tbl, pos_t, ql, qr, *pools,
                                           page=page, **kw)
    before = paged_mla_flash_decode.launches
    got = paged_mla_flash_decode(tbl, pos_t, ql, qr, *pools, page=page, **kw)
    want_flat = mla_flash_decode(ql, qr, *flat, pos_t, tile=page, **kw)
    torch.cuda.synchronize()
    assert paged_mla_flash_decode.launches == before + 1
    assert _rel(got, _finalized(acc, l)) < 1e-5
    live = [i for i in range(b) if i != trash]
    assert torch.equal(got[live], want_flat[live])


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("s,pos", [(576, ENGINE_POS),
                                   (1600, (1599, 1000, 70, 0))])
def test_mla_flash_decode_request_alone_equals_in_batch(cuda, kv_bits, s,
                                                        pos):
    """A request's output is bitwise the same computed alone (B 1) and
    inside a batch of other positions, flat and paged: its splits depend
    on its own position only."""
    b, page = len(pos), 64
    flat, pools, tbl, ql, qr, chunk = _paged_latent(
        cuda, kv_bits, b, s, 512, 64, 128, seed=30)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=512, dr=64)
    batch_flat = mla_flash_decode(ql, qr, *flat, pos_t, tile=page, **kw)
    batch_paged = paged_mla_flash_decode(tbl, pos_t, ql, qr, *pools,
                                         page=page, **kw)
    for i in range(b):
        one = slice(i, i + 1)
        alone_flat = mla_flash_decode(ql[one], qr[one],
                                      *(x[one] for x in flat), pos_t[one],
                                      tile=page, **kw)
        alone_paged = paged_mla_flash_decode(tbl[one], pos_t[one], ql[one],
                                             qr[one], *pools, page=page,
                                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone_flat, batch_flat[one]), i
        assert torch.equal(alone_paged, batch_paged[one]), i
    assert torch.equal(batch_flat, batch_paged)


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_mla_flash_decode_two_calls_equal(cuda, kv_bits):
    """The split rows are merged in a fixed order: two calls, flat and
    paged, give the same bits."""
    pos = (2047, 1500, 600, 64)
    flat, pools, tbl, ql, qr, chunk = _paged_latent(
        cuda, kv_bits, 4, 2048, 512, 64, 128, seed=31)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=512, dr=64)
    calls = [(mla_flash_decode(ql, qr, *flat, pos_t, tile=64, **kw),
              paged_mla_flash_decode(tbl, pos_t, ql, qr, *pools, page=64,
                                     **kw)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(calls[0][0], calls[1][0])
    assert torch.equal(calls[0][1], calls[1][1])


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("s,pos", [(576, ENGINE_POS), (1100, (1099, 700))])
def test_mla_flash_decode_x1_queries_hold_to_float64(cuda, kv_bits, s, pos):
    """Unscaled unit-normal queries (scores of tens): at the engine's shape
    the fp32 plain version is itself more than 1e-5 from the function's
    float64 value (tests/test_torch_mla_precision.py), so the kernel is
    held within 1e-5 of that value."""
    g = torch.Generator(device=cuda).manual_seed(32)
    b = len(pos)
    cq, cs = _latent(g, b, s, 512, kv_bits, cuda)
    rq, rs = _latent(g, b, s, 64, kv_bits, cuda)
    ql = torch.randn((b, 128, 512), generator=g, device=cuda)
    qr = torch.randn((b, 128, 64), generator=g, device=cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=kv_codec(kv_bits, 64).chunk, dl=512,
              dr=64)
    acc, _, l = mla_flash_decode_ref(ql, qr, cq, cs, rq, rs, pos_t, tile=64,
                                     dtype=torch.float64, **kw)
    got = mla_flash_decode(ql, qr, cq, cs, rq, rs, pos_t, tile=64, **kw)
    torch.cuda.synchronize()
    assert _rel(got, _finalized(acc, l)) < 1e-5


def test_mla_flash_decode_refuses_wide_rows(cuda):
    """A latent and rope row wider than the kernel's 576-wide key tile is
    refused with a ValueError, never handed to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(33)
    cq, cs = _latent(g, 1, 64, 512, 8, cuda)
    rq, rs = _latent(g, 1, 64, 128, 8, cuda)
    ql = torch.randn((1, 4, 512), generator=g, device=cuda)
    qr = torch.randn((1, 4, 128), generator=g, device=cuda)
    before = mla_flash_decode.launches
    with pytest.raises(ValueError, match="wider than the decode kernel"):
        mla_flash_decode(ql, qr, cq, cs, rq, rs, 63, kv_bits=8, chunk=1,
                         dl=512, dr=128, tile=64)
    assert mla_flash_decode.launches == before


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L,h,dl,dr", [
    (0, 37, 4, 32, 16), (3, 64, 3, 40, 8), (2, 1, 128, 512, 64),
    (4, 130, 128, 512, 64)])
def test_paged_mla_flash_extend_kernel_vs_plain(cuda, kv_bits, n_past, L, h,
                                                dl, dr):
    page = 64
    g = torch.Generator(device=cuda).manual_seed(12)
    n_pages = n_past + 3
    cq, cs = _latent(g, 1, n_pages * page, dl, kv_bits, cuda)
    rq, rs = _latent(g, 1, n_pages * page, dr, kv_bits, cuda)
    chunk = kv_codec(kv_bits, 64).chunk
    pools = [cq.reshape(n_pages, page, -1), cs.reshape(n_pages, -1),
             rq.reshape(n_pages, page, -1), rs.reshape(n_pages, -1)]
    tbl = (torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(13))[:n_past].to(torch.int32)
           + 1).to(cuda)
    ql = torch.randn((L, h, dl), generator=g, device=cuda) * 0.05
    qr = torch.randn((L, h, dr), generator=g, device=cuda) * 0.05
    c_new = torch.randn((L, dl), generator=g, device=cuda)
    r_new = torch.randn((L, dr), generator=g, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr, page=page)
    want = paged_mla_flash_extend_ref(tbl, ql, qr, c_new, r_new, *pools, **kw)
    before = paged_mla_flash_extend.launches
    got = paged_mla_flash_extend(tbl, ql, qr, c_new, r_new, *pools, **kw)
    torch.cuda.synchronize()
    assert paged_mla_flash_extend.launches == before + 1
    assert got.shape == (L, h, dl)
    assert _rel(got, want) < 1e-5


# ------------------------------------------- MLA: the rebuilt kernels
#
# quant_matmul_t's decode (m <= 4: qmm_t_decode) and prefill (qmm_t_tile)
# shapes, and the tensor-core paged_mla_flash_extend.


def _absorb_views(cuda, bits, h, dn, kvr, gs, seed):
    """quant_matmul_t's operand: the W_k views of one packed wkv_b (value
    heads as wide as dn), strided, not copied."""
    pw, g = _wkv_b(cuda, bits, h, dn, dn, kvr, gs, seed)
    pw_k, _ = mla_latent_weights(pw, h, dn, dn)
    assert not pw_k.w_packed.is_contiguous()
    return pw_k, g


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 16, 70, 128])
@pytest.mark.parametrize("h,kvr,gs", [(3, 130, 130), (128, 512, 128),
                                      (1, 512, 128)])
def test_quant_matmul_t_kernels_vs_plain(cuda, bits, m, h, kvr, gs):
    """Both qmm_t kernels on strided wkv_b views, ragged k (130, a 3-bit
    word straddling its end) and H 1 / 3 / 128: within 1e-5 of the plain
    version, one launch counted under the kernel that ran."""
    pw_k, g = _absorb_views(cuda, bits, h, 128, kvr, gs, seed=40)
    x = torch.randn((h, m, 128), generator=g, device=cuda)
    want = quant_matmul_t_ref(x, pw_k.w_packed, pw_k.scale, pw_k.zero,
                              bits=bits, group_size=gs, d_in=kvr)
    kernel = "qmm_t_decode" if m <= 4 else "qmm_t_tile"  # gs >= 32 / bits
    before, by = quant_matmul_t.launches, dict(quant_matmul_t.by_kernel)
    got = quant_matmul_t(x, pw_k)
    torch.cuda.synchronize()
    assert quant_matmul_t.launches == before + 1
    assert quant_matmul_t.by_kernel == dict(by, **{kernel: by[kernel] + 1})
    assert got.shape == (h, m, kvr)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("dn,m", [(40, 3), (40, 20), (136, 4), (136, 9),
                                  (30, 2), (30, 33), (256, 1), (256, 70)])
def test_quant_matmul_t_kernels_at_other_widths(cuda, bits, dn, m):
    """Contraction widths other than 128: narrower (40), two column passes
    of the decode (136, 256), and no multiple of 4 (30: scalar word
    loads)."""
    h, kvr, gs = 3, 320, 64
    pw_k, g = _absorb_views(cuda, bits, h, dn, kvr, gs, seed=41)
    x = torch.randn((h, m, dn), generator=g, device=cuda)
    want = quant_matmul_t_ref(x, pw_k.w_packed, pw_k.scale, pw_k.zero,
                              bits=bits, group_size=gs, d_in=kvr)
    got = quant_matmul_t(x, pw_k)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quant_matmul_t_rows_do_not_depend_on_m(cuda, bits):
    """A row of y is bitwise the same computed in a launch at m 1 or m 4
    (the decode kernel) and at m 16 or m 128 (the tile): the engine holds a
    slot's step to the flat step."""
    pw_k, g = _absorb_views(cuda, bits, 128, 128, 512, 128, seed=42)
    x = torch.randn((128, 128, 128), generator=g, device=cuda)
    y4 = quant_matmul_t(x[:, :4].contiguous(), pw_k)
    y128 = quant_matmul_t(x, pw_k)
    torch.cuda.synchronize()
    for i in range(4):
        y1 = quant_matmul_t(x[:, i:i + 1].contiguous(), pw_k)
        assert torch.equal(y1, y4[:, i:i + 1]), i
    assert torch.equal(quant_matmul_t(x[:, :16].contiguous(), pw_k),
                       y128[:, :16])
    assert torch.equal(quant_matmul_t(x[:, 100:].contiguous(), pw_k),
                       y128[:, 100:])


def _mla_extend_case(cuda, kv_bits, n_past, L, h, page, q_scale, seed,
                     extra_pages=2, dl=512, dr=64):
    """Latent pools of n_past + extra_pages pages (page 0 unused), a
    shuffled table of n_past of them, queries of unit normals times
    q_scale, the chunk's own latents."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = n_past + extra_pages
    cq, cs = _latent(g, 1, n_pages * page, dl, kv_bits, cuda, page=page)
    rq, rs = _latent(g, 1, n_pages * page, dr, kv_bits, cuda, page=page)
    chunk = kv_codec(kv_bits, page).chunk
    pools = [cq.reshape(n_pages, page, -1), cs.reshape(n_pages, -1),
             rq.reshape(n_pages, page, -1), rs.reshape(n_pages, -1)]
    tbl = (torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed))[:n_past].to(torch.int32)
           + 1).to(cuda)
    ql = torch.randn((L, h, dl), generator=g, device=cuda) * q_scale
    qr = torch.randn((L, h, dr), generator=g, device=cuda) * q_scale
    c_new = torch.randn((L, dl), generator=g, device=cuda)
    r_new = torch.randn((L, dr), generator=g, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr, page=page)
    return (tbl, ql, qr, c_new, r_new, *pools), kw


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("q_scale", [1.0, 0.05], ids=["x1", "x0.05"])
@pytest.mark.parametrize("L,n_past,h", [
    (1, 0, 3), (1, 16, 128), (37, 2, 20), (37, 0, 128), (128, 6, 128),
    (129, 16, 20), (129, 2, 3), (256, 16, 128), (256, 0, 20)])
def test_paged_mla_flash_extend_tensor_cores(cuda, kv_bits, q_scale, L,
                                             n_past, h):
    """The extend at deepseek-v3's widths over L 1 - 256 chunk tokens, 0 -
    16 past pages and H 3 / 20 / 128 heads (rows past H in a block of 32).
    At x0.05 within 1e-5 of the plain version; at x1 (scores of tens, a
    peaked softmax) the fp32 plain version is itself ~1.6e-5 from the
    function's float64 value (tests/test_torch_mla_precision.py), so the
    kernel is held within 1e-5 of that value instead."""
    args, kw = _mla_extend_case(cuda, kv_bits, n_past, L, h, 64, q_scale,
                                seed=43)
    dtype = torch.float64 if q_scale == 1.0 else torch.float32
    want = paged_mla_flash_extend_ref(*args, dtype=dtype, **kw)
    before = paged_mla_flash_extend.launches
    got = paged_mla_flash_extend(*args, **kw)
    torch.cuda.synchronize()
    assert paged_mla_flash_extend.launches == before + 1
    assert got.shape == (L, h, 512) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("page,n_past", [(64, 3), (128, 3), (128, 1)])
def test_paged_mla_flash_extend_at_pages_64_and_128(cuda, kv_bits, page,
                                                    n_past):
    """Pages (= kv2 scale chunks) of 64 and 128 rows: within 1e-5 of the
    plain version."""
    args, kw = _mla_extend_case(cuda, kv_bits, n_past, 70, 20, page, 0.05,
                                seed=44)
    want = paged_mla_flash_extend_ref(*args, **kw)
    got = paged_mla_flash_extend(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("page,n_past", [(16, 3), (16, 8), (48, 3), (48, 4)])
def test_paged_mla_flash_extend_at_other_page_sizes(cuda, kv_bits, page,
                                                    n_past):
    """Pages (``cfg.kv_chunk``) that are not 64 against the kernel's 32-key
    tiles: at 16 a tile spans two pages (one run of bulk copies a page), at
    48 every other tile starts partway into a page and ends in the next; at
    n_past * page not a multiple of 32 the last past tile is partial.
    Within 1e-5 of the plain version."""
    args, kw = _mla_extend_case(cuda, kv_bits, n_past, 70, 20, page, 0.05,
                                seed=47)
    want = paged_mla_flash_extend_ref(*args, **kw)
    got = paged_mla_flash_extend(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("dl,dr,page", [(510, 64, 64), (512, 62, 16),
                                        (200, 30, 48), (500, 60, 48)])
def test_paged_mla_flash_extend_kv8_rows_of_any_width(cuda, dl, dr, page):
    """kv8 code rows of dl and dr bytes: where either is not a multiple of 4
    the past tiles' rows are copied byte by byte, where both are multiples
    of 4 but not of 16 by 4-byte cp.async (500, 60), at pages 64, 16 and
    48.  Within 1e-5 of the plain version."""
    args, kw = _mla_extend_case(cuda, 8, 3, 45, 20, page, 0.05, seed=48,
                                dl=dl, dr=dr)
    want = paged_mla_flash_extend_ref(*args, **kw)
    got = paged_mla_flash_extend(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == (45, 20, dl)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_mla_flash_extend_never_reads_pages_outside_tbl(cuda,
                                                             kv_bits):
    """A page left out of tbl holds NaN scales and stale codes: the result
    is bitwise that of the clean pools, finite, and within 1e-5 of the
    plain version on the clean pools."""
    args, kw = _mla_extend_case(cuda, kv_bits, 4, 90, 20, 64, 0.05, seed=45,
                                extra_pages=3)
    tbl, pools = args[0], list(args[5:])
    unused = sorted(set(range(pools[0].shape[0])) - set(tbl.tolist()))
    assert unused
    poisoned = [p.clone() for p in pools]
    for i in unused:
        poisoned[1][i] = float("nan")
        poisoned[3][i] = float("nan")
        poisoned[0][i] = pools[0][tbl[0]]
        poisoned[2][i] = pools[2][tbl[0]]
    clean = paged_mla_flash_extend(*args, **kw)
    got = paged_mla_flash_extend(*args[:5], *poisoned, **kw)
    want = paged_mla_flash_extend_ref(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("L,n_past,h,rows", [
    (128, 0, 128, None), (128, 6, 128, None), (70, 2, 20, (32, 64)),
    (256, 16, 20, (0, 100))])
def test_paged_mla_flash_extend_bf16_valued_own_latents(cuda, kv_bits, L,
                                                       n_past, h, rows):
    """Own latents that are bf16 values widened to fp32, as the model
    passes its cache rows: their second and third bf16 terms are zero and
    the kernel skips those stages of the tiles they fill (all of them, or
    only the tiles inside ``rows``, the others fp32).  Within 1e-5 of the
    plain version."""
    args, kw = _mla_extend_case(cuda, kv_bits, n_past, L, h, 64, 0.05,
                                seed=46)
    lo, hi = rows if rows else (0, L)
    for x in (args[3], args[4]):  # c_new, r_new in place
        x[lo:hi] = x[lo:hi].to(torch.bfloat16).float()
    want = paged_mla_flash_extend_ref(*args, **kw)
    got = paged_mla_flash_extend(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5


# ---- the decode (m <= 4, qmm_decode) at the models' widths ----

@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k,n,gs", [
    (4096, 4096, 128), (14336, 4096, 128), (18432, 576, 128),
    (18432, 1536, -1), (4096, 1536, -1), (14300, 576, 100),
    (14336, 4096, -1), (18432, 4096, 128)])
def test_quant_matmul_decode_at_real_widths(cuda, bits, k, n, gs):
    """The decode kernel at llama3-8b's and deepseek-v3's row lengths (k
    4096, 14336, 18432) and widths (wkv_a's 576, wq_a's 1536, 4096), gs 128,
    100 and -1 (one group a row), bf16 and fp32 x, m 1-4: one launch of
    qmm_decode a call, within 8e-3 (bf16) and 1e-5 (fp32)."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=20)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        for m in (1, 2, 3, 4):
            x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
            want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale,
                                    pw.zero, bits=bits,
                                    group_size=pw.group_size)
            by = quant_matmul.by_kernel["qmm_decode"]
            got = quant_matmul(x, pw)
            torch.cuda.synchronize()
            assert quant_matmul.by_kernel["qmm_decode"] == by + 1
            assert got.dtype == dtype and got.shape == (m, n)
            assert _rel(got, want) < tol, (dtype, m)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k,n,gs", [(14336, 4096, 128), (300, 96, 100),
                                    (7168, 576, -1), (512, 70, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_quant_matmul_decode_rows_bitwise_across_m_and_calls(cuda, bits, k,
                                                             n, gs, dtype):
    """A row of the decode's y is the same bits at m 1, 2, 3 and 4, and from
    one call to the next: the split-k sums meet in a fixed order."""
    pw, g = _packed(cuda, bits, k, n, gs, seed=21)
    x = torch.randn((4, k), generator=g, device=cuda).to(dtype)
    full = quant_matmul(x, pw)
    again = quant_matmul(x, pw)
    parts = [quant_matmul(x[:m].clone(), pw) for m in (1, 2, 3)]
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for m, part in zip((1, 2, 3), parts):
        assert torch.equal(full[:m], part), m


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4])
def test_quant_matmul_decode_on_wkv_b_views(cuda, bits, m):
    """MLA's expand at deepseek-v3's width: fp32 x through the decode on
    the 128 strided W_v views of one packed wkv_b (kv_lora 512), each head
    within 1e-5 of its own plain call."""
    h, dn, dv, kvr = 128, 128, 128, 512
    pw, g = _wkv_b(cuda, bits, h, dn, dv, kvr, 128, seed=22)
    _, pw_v = mla_latent_weights(pw, h, dn, dv)
    x = torch.randn((h, m, kvr), generator=g, device=cuda)
    by = quant_matmul.by_kernel["qmm_decode"]
    got = quant_matmul(x, pw_v)
    torch.cuda.synchronize()
    assert quant_matmul.by_kernel["qmm_decode"] == by + 1
    for i in range(h):
        want = quant_matmul_ref(x[i], pw_v.w_packed[i], pw_v.scale[i],
                                pw_v.zero[i], bits=bits, group_size=128,
                                d_in=kvr)
        assert _rel(got[i], want) < 1e-5, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_quant_matmul_decode_non_finite_as_plain(cuda, dtype):
    """An Inf and a NaN in x make the same decode outputs non-finite as the
    plain version (their rows), the other rows within tolerance."""
    pw, g = _packed(cuda, 3, 4096, 576, 128, seed=23)
    x = torch.randn((4, 4096), generator=g, device=cuda).to(dtype)
    x[1, 7] = float("inf")
    x[3, 3000] = float("nan")
    want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                            bits=3, group_size=128)
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert _rel(got[finite], want[finite]) < tol


# ---- attn_colsum on the tensor cores: deterministic, the MLA shape ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,kv,dh", [(4, 512, 32, 8, 128),
                                         (2, 300, 128, 128, 192)])
def test_attn_colsum_kernel_same_bits_every_call(cuda, dtype, b, t, h, kv,
                                                 dh):
    """Two calls on the same q and k give the same bits: the column pieces
    are added in a fixed order, with no float atomics."""
    g = torch.Generator(device=cuda).manual_seed(30)
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, t, kv, dh), generator=g, device=cuda).to(dtype)
    first = attn_colsum(q, k)
    second = attn_colsum(q, k)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,kv,dh", [
    (2, 300, 128, 128, 192),  # MLA: H = KV heads of dn + dr
    (1, 1, 4, 4, 16), (2, 37, 8, 2, 40), (1, 65, 6, 3, 72),
    (2, 130, 16, 2, 100), (1, 200, 8, 1, 130), (2, 97, 4, 4, 42),
    (1, 129, 8, 8, 36), (1, 600, 32, 8, 128)])
def test_attn_colsum_kernel_shapes_vs_plain(cuda, dtype, b, t, h, kv, dh):
    """MLA's shape, ragged T (1, 37, 65, 97, 129, 130, 200, 300, 600) and
    Dh (16 to 192; 42 and 36 leave rows that 16-byte copies cannot take),
    GQA groups of 1 to 8 heads, fp32 and bf16: within 1e-4 of the plain
    version, and the column mass totals T·H."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, t, kv, dh), generator=g, device=cuda).to(dtype)
    want = attn_colsum_ref(q, k)
    before = attn_colsum.launches
    got = attn_colsum(q, k)
    torch.cuda.synchronize()
    assert attn_colsum.launches == before + 1
    assert got.shape == (b, t) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    np.testing.assert_allclose(got.sum(-1).cpu().numpy(), t * h, rtol=1e-4)


def test_attn_colsum_kernel_refuses_wider_heads(cuda):
    """Dh past 192 raises rather than leaving the kernel."""
    q = torch.randn((1, 8, 2, 200), device=cuda)
    with pytest.raises(ValueError):
        attn_colsum(q, q)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("chunk,attn", [(None, "exact"), (64, "paged")],
                         ids=["whole", "chunked-paged"])
def test_engine_under_oversubscription_equals_large_pool(cuda, kv_bits,
                                                         chunk, attn):
    """A 2-layer bf16 engine on the card (paged decode and, chunked, the
    paged extend kernel) with 8 requests over a pool of half the hot demand
    (4 slots x 2 pages against 4 pages), two of them at priority 1, one
    sampled: every request finishes, some after a preemption, each with
    the tokens of the same requests at one priority over 32 pages, where
    nobody is preempted, bit for bit."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_layers=2,
                              dtype="bfloat16", kv_bits=kv_bits)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = rng.integers(2, cfg.vocab_size, (8, 100)).tolist()
    budgets = [int(b) for b in rng.integers(10, 29, 8)]

    def serve(n_pages, priority):
        reqs = [ServeRequest(tokens=prompts[i], max_new_tokens=budgets[i],
                             sampling=SamplingParams(
                                 temperature=0.8 if i == 7 else 0.0, seed=i,
                                 priority=priority * int(i >= 6)))
                for i in range(8)]
        engine = Engine(model, params, max_slots=4, n_pages=n_pages,
                        max_pages_per_request=2, burst_steps=4,
                        prefill_chunk=chunk, prefill_attn=attn)
        st = run_trace(engine, poisson_trace(reqs, rate=2.0, seed=0))
        assert st["n_requests"] == 8
        assert all(o.finished_ok for o in st["outputs"].values())
        return st

    full, tight = serve(32, 0), serve(4, 1)
    assert full["n_preemptions"] == 0
    assert tight["n_preemptions"] >= 1 and tight["n_preempted_requests"] >= 1
    for rid in range(8):
        assert tight["outputs"][rid].tokens == full["outputs"][rid].tokens


# ------------------------------------------------------ captured decode loops
EXPERT_FREE = dict(n_routed_experts=0, n_shared_experts=0, moe_top_k=0,
                   moe_d_ff=0)


def _graph_model(cuda, kind, kv_bits):
    """A 2-layer bf16 model on the card (llama3-8b's reduced GQA,
    deepseek-v3's reduced, expert-free MLA, or deepseek-v2's reduced MLA
    with its routed-expert layer 1, "moe") with every block projection
    RTN-packed at 3 bits, so that its decode runs ``qmm_decode`` (and MLA's
    absorb ``qmm_t_decode``; the expert stacks ``qmm_tc``, m 8) besides the
    attention kernels and the LM head's cuBLAS product."""
    arch = {"gqa": "llama3-8b", "mla": "deepseek-v3-671b",
            "moe": "deepseek-v2-236b"}[kind]
    extra = EXPERT_FREE if kind == "mla" else {}
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16",
                              kv_bits=kv_bits, **extra)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    spec = QuantSpec(bits=3, group_size=32)

    def pack(node):
        for name, w in node.items():
            if isinstance(w, dict):
                pack(w)
            elif name == "router":
                continue
            elif w.ndim == 3:
                node[name] = _packed_stack(w, spec)
            elif w.ndim == 2:
                _, q, sc, zr = quantize_weight_rtn(w.float(), spec)
                node[name] = pack_weight(q, sc, zr, spec)

    for layer in params["layers"]:
        pack(layer["mixer"])
        pack(layer["ffn"])
    return model, params


def _count_delta(after, before):
    return {name: (n - before[name][0],
                   {k: v - before[name][1][k] for k, v in by.items()})
            for name, (n, by) in after.items()}


def _loops(run):
    """``run(loop)`` for the graph loop, then the Python loop; their
    results and the launches each one counted."""
    c0 = read_counts()
    graph = run("graph")
    torch.cuda.synchronize()
    c1 = read_counts()
    python = run("python")
    torch.cuda.synchronize()
    return graph, python, _count_delta(c1, c0), _count_delta(read_counts(),
                                                             c1)


@pytest.mark.parametrize("kind", ["gqa", "mla", "moe"])
@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_generate_graph_equals_python_loop(cuda, kind, kv_bits):
    """``generate`` through a captured CUDA graph gives the Python loop's
    tokens bit for bit, greedy and sampled, over a prompt whose decode
    crosses a kv page (and, kv2, a scale chunk), and counts the same
    launches of every kernel (the graph's warm-up and capture count
    none)."""
    model, params = _graph_model(cuda, kind, kv_bits)
    prompts = torch.randint(2, model.cfg.vocab_size, (3, 60),
                            generator=torch.Generator(device=cuda)
                            .manual_seed(1), device=cuda)
    for temperature in (0.0, 1.3):
        graph, python, n_graph, n_python = _loops(
            lambda loop: generate(model, params, prompts, 9,
                                  temperature=temperature, seed=4,
                                  loop=loop))
        assert torch.equal(graph, python), (graph.tolist(), python.tolist())
        assert n_graph == n_python
    assert n_python["quant_matmul"][1]["qmm_decode"] > 0
    attention = ("flash_decode" if kind == "gqa" else "mla_flash_decode")
    assert (n_python[attention][0] > 0) == bool(kv_bits)
    assert all(r.captured for r, _ in model.graphs.values())


def test_generate_one_capture_per_key(cuda):
    """A graph is captured once per (params, batch, prompt length, n_gen,
    sampled): a second call with the same shapes and another temperature
    replays it; a new prompt length or a new params dict (the graph reads
    the old one's addresses) captures another."""
    model, params = _graph_model(cuda, "gqa", 8)
    g = torch.Generator(device=cuda).manual_seed(2)
    prompts = torch.randint(2, model.cfg.vocab_size, (2, 40), generator=g,
                            device=cuda)
    st: dict = {}
    first = generate(model, params, prompts, 6, temperature=0.7, stats=st)
    assert len(model.graphs) == 1 and st["capture_s"] > 0
    replay, _ = next(iter(model.graphs.values()))
    again = generate(model, params, prompts, 6, temperature=0.9, stats=st)
    assert len(model.graphs) == 1 and st["capture_s"] == 0.0
    assert replay.replays == 2
    assert torch.equal(again, generate(model, params, prompts, 6,
                                       temperature=0.9, loop="python"))
    assert torch.equal(first, generate(model, params, prompts, 6,
                                       temperature=0.7, loop="python"))
    generate(model, params, prompts[:, :30], 6, temperature=0.7)
    assert len(model.graphs) == 2
    other = {k: v for k, v in params.items()}
    generate(model, other, prompts, 6, temperature=0.7, stats=st)
    assert len(model.graphs) == 3 and st["capture_s"] > 0
    assert all(r.captured for r, _ in model.graphs.values())


def test_generate_capture_error_propagates(cuda):
    """An error raised while the decode loop is captured leaves
    ``generate``: no eager loop runs in its place (no decode kernel's count
    moves: the prefill's do), and no graph is kept."""
    model, params = _graph_model(cuda, "gqa", 8)
    prompts = torch.randint(2, model.cfg.vocab_size, (2, 40), device=cuda)
    step, calls = model.decode_step, []

    def failing(*args, **kw):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused under capture")
        return step(*args, **kw)

    model.decode_step = failing
    before = read_counts()
    with pytest.raises(RuntimeError, match="refused under capture"):
        generate(model, params, prompts, 5)
    assert calls == [False, True]  # the warm-up's step, then the capture's
    after = read_counts()
    assert after["flash_decode"] == before["flash_decode"]
    assert after["quant_matmul"][1]["qmm_decode"] == \
        before["quant_matmul"][1]["qmm_decode"]
    assert not any(r.captured for r, _ in model.graphs.values())


def test_capture_survives_garbage_that_holds_a_graph(cuda):
    """A captured graph whose owner is unreachable in a reference cycle
    waits for Python's cyclic collector; a collection while another region
    is captured would destroy that graph inside the capture, which CUDA
    refuses (the capture is invalidated).  The collector is off while a
    region is captured, so this one's many allocations run none."""
    x = torch.arange(8.0, device=cuda)
    held = Replay(lambda: x * 2, cuda)
    assert torch.equal(held.run(), x * 2)

    class Owner:
        pass
    owner = Owner()
    owner.me, owner.replay = owner, held
    del owner, held
    assert gc.isenabled()

    def region():
        junk = [[i] for i in range(50000)]  # many collections' worth
        return x + len(junk)

    # a warm-up that allocates little, so the garbage lives until the capture
    replay = Replay(region, cuda, warm_up=lambda: x + 1)
    assert torch.equal(replay.run(), x + 50000)
    assert gc.isenabled()
    gc.collect()


@pytest.mark.parametrize("kind,kv_bits,chunk,attn", [
    ("gqa", 8, None, "exact"), ("gqa", 2, 64, "exact"),
    ("gqa", 8, 64, "paged"), ("mla", 8, None, "exact"),
    ("mla", 2, 64, "paged"), ("moe", 8, None, "exact"),
    ("moe", 2, 64, "paged")])
def test_engine_graph_equals_python_loop(cuda, kind, kv_bits, chunk, attn):
    """The engine's bursts through its two graphs (greedy, sampled; both
    captured when it is built) give the Python loop's streams bit for bit
    and the same launch counts, over an oversubscribed pool where requests
    are preempted and replayed."""
    model, params = _graph_model(cuda, kind, kv_bits)
    rng = np.random.default_rng(6)
    prompts = rng.integers(2, model.cfg.vocab_size, (6, 100)).tolist()
    budgets = [int(b) for b in rng.integers(8, 25, 6)]

    def serve(loop):
        reqs = [ServeRequest(tokens=prompts[i], max_new_tokens=budgets[i],
                             sampling=SamplingParams(
                                 temperature=0.8 if i == 5 else 0.0, seed=i,
                                 priority=int(i >= 4)))
                for i in range(6)]
        engine = Engine(model, params, max_slots=4, n_pages=4,
                        max_pages_per_request=2, burst_steps=4,
                        prefill_chunk=chunk, prefill_attn=attn, loop=loop)
        assert sum(r.captured for r in engine.graphs.values()) == (
            2 if loop == "graph" else 0)
        st = run_trace(engine, poisson_trace(reqs, rate=2.0, seed=0))
        assert st["n_requests"] == 6
        assert all(o.finished_ok for o in st["outputs"].values())
        return st

    graph, python, n_graph, n_python = _loops(serve)
    assert graph["n_preemptions"] >= 1
    assert graph["n_preemptions"] == python["n_preemptions"]
    for rid in range(6):
        assert graph["outputs"][rid].tokens == python["outputs"][rid].tokens
    assert n_graph == n_python


SOLVE_SPECS = [(bits, group, sym) for bits in (2, 3, 4, 8)
               for group in (32, 64, 128, -1) for sym in (True, False)]


def _solve_inputs(cuda, n, block, d_out, seed):
    """N blocks of rows and the diagonal U tiles of real Hessians."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    wb = torch.randn((n, block, d_out), generator=g, device=cuda)
    x = torch.randn((n, 4 * block, block), generator=g, device=cuda)
    x = x * torch.rand((n, 1, block), generator=g, device=cuda)
    ub = torch.stack([hinv_cholesky(prepare_hessian(2.0 * xi.T @ xi))
                      for xi in x])
    return wb, ub


@pytest.mark.parametrize("bits,group,sym", SOLVE_SPECS)
@pytest.mark.parametrize("n,block,d_out", [(1, 128, 48), (3, 64, 576),
                                           (1, 128, 1000), (3, 128, 576),
                                           (2, 96, 2050), (1, 24, 33),
                                           (1, 128, 32768)])
def test_solve_block_kernel_bitwise_plain(cuda, bits, group, sym, n, block,
                                          d_out):
    """Ragged d_out, blocks of 24, 64, 96 and 128, a wide one (one lane a
    column), every bit width, in-block groups (32 / 64 / 128 where they
    tile the block) and, where they do not, one global group."""
    spec = QuantSpec(bits=bits, group_size=group, sym=sym)
    wb, ub = _solve_inputs(cuda, n, block, d_out, bits + block + d_out)
    if group == -1 or block % group:  # one global group, fixed beforehand
        rows, fixed = block, solver_params(
            torch.randn((n, 4 * block, d_out), device=cuda), spec)
    else:
        rows, fixed = group, None
    before = solve_block.launches
    got = solve_block(wb, ub, spec, rows, fixed)
    torch.cuda.synchronize()
    assert solve_block.launches == before + 1
    want = solve_block_ref(wb, ub, spec, rows, fixed)
    for name, a, b in zip(("q", "deq", "err", "scale", "zero"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, _rel(a, b))


# a divisor of each block that is not a multiple of 4
ODD_GROUP = {24: 6, 64: 2, 96: 6, 128: 2}


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("groups", ["block", "8", "odd"])
@pytest.mark.parametrize("block", [24, 64, 96, 128])
@pytest.mark.parametrize("n,d_out,lanes", [(1, 300, 8), (1, 5000, 4),
                                           (2, 6000, 2), (1, 18000, 1)])
def test_solve_block_every_instance_bitwise_plain(cuda, sym, groups, block,
                                                  n, d_out, lanes):
    """Every instance of the kernel: R = 8, 4, 2 and 1 lanes a column
    (picked from N x d_out, and cut to what the groups allow: a group of 8
    rows starts on rounds of 8), groups checked once a round, and at every row
    (a group size that is not a multiple of 4: R = 1); blocks of 24, 64,
    96 and 128 rows; a U tile whose rows are not 16-byte aligned (the
    4-byte staging path) beside an aligned one."""
    rows = {"block": block, "8": 8, "odd": ODD_GROUP[block]}[groups]
    spec = QuantSpec(bits=3, group_size=rows, sym=sym)
    how = plan(n, block, d_out, rows, False)
    want_lanes = {"block": lanes, "8": min(lanes, 2), "odd": 1}[groups]
    assert (how["lanes"], how["every_row"]) == (want_lanes, groups == "odd")
    wb, ub = _solve_inputs(cuda, n, block, d_out, block + d_out + sym)
    for tile in (ub, torch.nn.functional.pad(ub, (0, 1))[..., :block]):
        assert (tile.stride(1) % 4 == 0) == (tile is ub)
        got = solve_block(wb, tile, spec, rows)
        want = solve_block_ref(wb, tile, spec, rows)
        for name, a, b in zip(("q", "deq", "err", "scale", "zero"), got,
                              want):
            assert a.shape == b.shape and torch.equal(a, b), (name,
                                                              _rel(a, b))


@pytest.mark.parametrize("sym,rows,fixed", [(True, 128, False),
                                            (False, 32, False),
                                            (True, 128, True)])
@pytest.mark.parametrize("d_out,lanes", [(256, 8), (18000, 1)])
def test_solve_block_subnormal_ties_bitwise_plain(cuda, sym, rows, fixed,
                                                  d_out, lanes):
    """Errors exactly halfway between two fp32 subnormals
    (``subnormal_tie_inputs``), where a division through the fp64
    reciprocal rounds the other way from IEEE division: the kernel's
    correctly rounded divisions round them to even as the plain loop does,
    at R = 8 and R = 1, with a group's own scale and a fixed one (1000,
    where x / s is subnormal too)."""
    wb, ub = (t.to(cuda) for t in subnormal_tie_inputs(128, d_out,
                                                       seed=d_out + rows))
    spec = QuantSpec(bits=3 if sym else 4, group_size=rows, sym=sym)
    pair = ((torch.full((1, d_out), 1000.0, device=cuda),
             torch.full((1, d_out), 4.0, device=cuda)) if fixed else None)
    assert plan(1, 128, d_out, rows, fixed)["lanes"] == lanes
    got = solve_block(wb, ub, spec, rows, pair)
    want = solve_block_ref(wb, ub, spec, rows, pair)
    assert bool((want[2] != 0).all())
    for name, a, b in zip(("q", "deq", "err", "scale", "zero"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), (name, _rel(a, b))


@pytest.mark.parametrize("bits,group,sym", [(3, 128, True), (2, 32, True),
                                            (4, -1, True), (3, 64, False),
                                            (8, 128, False)])
def test_gptq_batched_on_the_kernel_equals_the_plain_loop(cuda, monkeypatch,
                                                         bits, group, sym):
    """A whole batched solve (3 matrices, d_in 384, d_out 200): the kernel
    against the same solve with the in-block loop on its plain version."""
    spec = QuantSpec(bits=bits, group_size=group, sym=sym)
    g = torch.Generator(device=cuda).manual_seed(bits)
    ws = torch.randn((3, 384, 200), generator=g, device=cuda)
    x = torch.randn((3, 1024, 384), generator=g, device=cuda)
    hs = 2.0 * x.transpose(1, 2) @ x
    before = solve_block.launches
    got = gptq_quantize_batched(ws, hs, spec)
    torch.cuda.synchronize()
    assert solve_block.launches == before + 3  # one a block of 128 rows
    monkeypatch.setattr(gptq_mod, "solve_block", solve_block_ref)
    want = gptq_quantize_batched(ws, hs, spec)
    for name in ("q", "w_deq", "scale", "zero", "err"):
        assert torch.equal(got[name], want[name]), name


# ------------------------------------------- qwen1.5, command-r and mamba2


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("m", [1, 4, 64, 256])
@pytest.mark.parametrize("k,n", [(1536, 48), (1536, 256), (64, 48),
                                 (3072, 1536)])
def test_quant_matmul_at_mamba_widths_vs_plain(cuda, bits, m, k, n):
    """mamba2-780m's narrow projections: ``wdt`` (n 48, less than one
    column tile), ``wbc`` (n 256) and ``out_proj`` (3072 -> 1536), decode
    (m <= 4, ``qmm_decode``) and prefill (``qmm_tc``), bf16 and fp32 x."""
    pw, g = _packed(cuda, bits, k, n, 128 if k % 128 == 0 else -1, seed=31)
    for dtype, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
        want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                                bits=bits, group_size=pw.group_size)
        before = quant_matmul.launches
        got = quant_matmul(x, pw)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        assert _rel(got, want) < tol


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("grp", [1, 3])
def test_gqa_attention_kernels_at_one_and_three_query_heads(cuda, kv_bits,
                                                            grp):
    """qwen1.5's G 1 (20 query heads on 20 KV heads) and minitron's G 3
    (24 on 8), Dh 128: the flat decode, the paged decode through a shuffled
    table (bitwise the flat one) and the paged extend, each against its
    plain version."""
    b, s, kv, d, page = 3, 512, 4, 128, 64
    pos = [500, 37, 255]
    g = torch.Generator(device=cuda).manual_seed(32 + grp)
    kq, ks, vq, vs, chunk = _kv_cache(g, b, s, kv, d, kv_bits, cuda)
    q = torch.randn((b, kv, grp, d), generator=g, device=cuda) * d ** -0.5
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d)
    acc, _, l = flash_decode_ref(q, kq, ks, vq, vs, pos_t, tile=page, **kw)
    flat = flash_decode(q, kq, ks, vq, vs, pos_t, kv_bits=kv_bits,
                        chunk=chunk, dv=d, tile=page)
    torch.cuda.synchronize()
    assert flat.shape == (b, kv, grp, d)
    assert _rel(flat, _finalized(acc, l)) < 1e-5
    tbl, pools = _paged_pools(kq, ks, vq, vs, chunk, page, 1, seed=33)
    acc, _, l = paged_flash_decode_ref(tbl, pos_t, q, *pools, page=page, **kw)
    got = paged_flash_decode(tbl, pos_t, q, *pools, kv_bits=kv_bits,
                             chunk=chunk, dv=d, page=page)
    torch.cuda.synchronize()
    assert _rel(got, _finalized(acc, l)) < 1e-5
    assert torch.equal(got, flat)
    # the extend: a 100-token chunk over 3 past pages, bf16 as the model
    # passes it
    n_past, L = 3, 100
    xq, xks, xvq, xvs, _ = _kv_cache(g, 1, (n_past + 1) * page, kv, d,
                                     kv_bits, cuda)
    epools = [xq.reshape((n_past + 1, page) + xq.shape[2:]),
              xks.reshape((n_past + 1, page // chunk) + xks.shape[2:]),
              xvq.reshape((n_past + 1, page) + xvq.shape[2:]),
              xvs.reshape((n_past + 1, page // chunk) + xvs.shape[2:])]
    etbl = (torch.randperm(n_past, generator=torch.Generator().manual_seed(34))
            + 1).to(torch.int32).to(cuda)
    qe, k_new, v_new = (torch.randn(shp, generator=g, device=cuda).to(
        torch.bfloat16) for shp in ((1, L, kv * grp, d), (1, L, kv, d),
                                    (1, L, kv, d)))
    ekw = dict(kw, page=page)
    want = paged_flash_extend_ref(etbl, qe, k_new, v_new, *epools, **ekw)
    got = paged_flash_extend(etbl, qe, k_new, v_new, *epools, **ekw)
    torch.cuda.synchronize()
    assert got.shape == (1, L, kv * grp, d)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("h,kv", [(20, 20), (64, 8)])
def test_attn_colsum_at_qwen_and_command_r_heads(cuda, h, kv):
    """qwen1.5's G 1 (20 / 20) and command-r's G 8 (64 / 8), Dh 128, over a
    calibration batch of 2 x 512."""
    g = torch.Generator(device=cuda).manual_seed(35)
    q = torch.randn((2, 512, h, 128), generator=g, device=cuda)
    k = torch.randn((2, 512, kv, 128), generator=g, device=cuda)
    want = attn_colsum_ref(q, k)
    got = attn_colsum(q, k)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-4
    assert torch.equal(got, attn_colsum(q, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_gram_kernel_at_mamba_width(cuda, dtype):
    """d 3072 (mamba2-780m's ``out_proj`` input), n 2048: within 1e-5 of
    the plain version and bitwise symmetric."""
    g = torch.Generator(device=cuda).manual_seed(36)
    x = torch.randn((2048, 3072), generator=g, device=cuda).to(dtype)
    r = torch.rand((2048,), generator=g, device=cuda)
    got = weighted_gram(x, r)
    torch.cuda.synchronize()
    assert _rel(got, weighted_gram_ref(x, r)) < 1e-5
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba_generate_graph_equals_python_loop(cuda, dtype):
    """mamba2-780m-smoke with 16 SSD heads on the card, every projection
    (``wdt`` included) RTN-packed at 3 bits: ``generate`` through the
    captured decode gives the Python loop's tokens bit for bit, greedy and
    sampled, with the same launches; the conv and SSM state stay in the
    static cache, advanced in place at every replay, and the fp32 leaves
    and state keep their dtype in a bf16 model."""
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              ssm_head_dim=8, dtype=dtype)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    spec = QuantSpec(bits=3, group_size=32)
    for layer in params["layers"]:
        mixer = layer["mixer"]
        for name in ("wzx", "wbc", "wdt", "out_proj"):
            _, q, sc, zr = quantize_weight_rtn(mixer[name].float(), spec)
            mixer[name] = pack_weight(q, sc, zr, spec)
        assert mixer["A_log"].dtype == torch.float32
    prompts = torch.randint(2, cfg.vocab_size, (3, 64),
                            generator=torch.Generator(device=cuda)
                            .manual_seed(1), device=cuda)
    for temperature in (0.0, 1.3):
        graph, python, n_graph, n_python = _loops(
            lambda loop: generate(model, params, prompts, 9,
                                  temperature=temperature, seed=4,
                                  loop=loop))
        assert torch.equal(graph, python), (graph.tolist(), python.tolist())
        assert n_graph == n_python
    assert n_python["quant_matmul"][1]["qmm_decode"] > 0
    assert all(r.captured for r, _ in model.graphs.values())
    static = next(iter(model.graphs.values()))[1]["cache"][0]
    assert static["ssm"].dtype == torch.float32
    assert static["conv"].dtype == model.dtype


# ----------------------------------------------------- the jamba hybrid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [512, 1792])
def test_gram_kernel_batched_at_jamba_widths(cuda, d, dtype):
    """jamba's expert stacks: E 16 capacity buffers of n 320 (a 4 x 512
    calibration batch, top 2, capacity factor 1.25), d narrowed from 4096
    and 14336 by 8 (d 1792 is not a multiple of the 128-wide tile's
    square): one launch, each matrix within 1e-5 of its plain version and
    bitwise symmetric from zero."""
    g = torch.Generator(device=cuda).manual_seed(40 + d)
    x = torch.randn((16, 320, d), generator=g, device=cuda).to(dtype)
    r = torch.rand((16, 320), generator=g, device=cuda)
    before = weighted_gram.launches
    got = weighted_gram(x, r)
    torch.cuda.synchronize()
    assert weighted_gram.launches == before + 1
    for e in range(16):
        assert _rel(got[e], weighted_gram_ref(x[e], r[e])) < 1e-5, e
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("m", [1, 4, 64, 256])
@pytest.mark.parametrize("k,n", [(4096, 32), (4096, 128), (512, 32)])
def test_quant_matmul_at_jamba_mamba_widths_vs_plain(cuda, bits, m, k, n):
    """jamba's narrowest projections: ``wbc`` (n 32, the narrowest output
    the port quantizes) and ``wdt`` (n 128, 128 heads), decode (m <= 4,
    ``qmm_decode``) and prefill (``qmm_tc``), bf16 and fp32 x."""
    pw, g = _packed(cuda, bits, k, n, 128, seed=41)
    for dtype, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
        want = quant_matmul_ref(x.float(), pw.w_packed, pw.scale, pw.zero,
                                bits=bits, group_size=128)
        before = quant_matmul.launches
        got = quant_matmul(x, pw)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        assert _rel(got, want) < tol


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)])
def test_quant_matmul_expert_stack_at_jamba_widths(cuda, m, k, n):
    """jamba's expert stacks (E 16, 3-bit, group 128: wi / wu 4096 ->
    14336, wd 14336 -> 4096) at the decode capacity (m 8) and a 4 x 64
    prefill's (m 40): one launch, each expert's bf16 output within one
    bf16 rounding of its plain version."""
    g = torch.Generator(device=cuda).manual_seed(42)
    w = torch.randn((16, k, n), generator=g, device=cuda) * k ** -0.5
    pw = _packed_stack(w, QuantSpec(3, 128))
    del w
    x = torch.randn((16, m, k), generator=g, device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches
    got = quant_matmul(x, pw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert got.shape == (16, m, n) and got.dtype == torch.bfloat16
    for e in range(16):
        want = quant_matmul_ref(x[e].float(), pw.w_packed[e], pw.scale[e],
                                pw.zero[e], bits=3, group_size=128, d_in=k)
        assert _rel(got[e], want) < 8e-3, e
    del pw, got
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_hybrid_generate_graph_equals_python_loop(cuda, kv_bits):
    """jamba-v0.1-52b-smoke at 8 layers (two groups of Mamba and GQA
    blocks, dense and routed-expert FFNs) on the card in bf16, every
    projection at least 16 wide RTN-packed at 3 bits: ``generate``
    through the captured decode (the prefill's Mamba states and the GQA
    blocks' K/V or kv8 codes loaded into the static cache after the
    capture) gives the Python loop's tokens bit for bit, greedy and
    sampled, with the same launches."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              n_layers=8, dtype="bfloat16", kv_bits=kv_bits)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    spec = QuantSpec(bits=3, group_size=32)
    names = ("wzx", "wbc", "wdt", "out_proj", "wq", "wk", "wv", "wo", "wi",
             "wu", "wd")

    def pack(node):
        for name, w in node.items():
            if isinstance(w, dict):
                pack(w)
            elif name in names and min(w.shape[-2:]) >= 16:
                node[name] = (_packed_stack(w, spec) if w.ndim == 3 else
                              pack_weight(*quantize_weight_rtn(
                                  w.float(), spec)[1:], spec))

    for layer in params["layers"]:
        pack(layer)
    prompts = torch.randint(2, cfg.vocab_size, (3, 64),
                            generator=torch.Generator(device=cuda)
                            .manual_seed(1), device=cuda)
    for temperature in (0.0, 1.3):
        graph, python, n_graph, n_python = _loops(
            lambda loop: generate(model, params, prompts, 9,
                                  temperature=temperature, seed=4,
                                  loop=loop))
        assert torch.equal(graph, python), (graph.tolist(), python.tolist())
        assert n_graph == n_python
    assert n_python["quant_matmul"][1]["qmm_decode"] > 0
    assert n_python["quant_matmul"][1]["qmm_tc"] > 0  # the expert stacks
    if kv_bits:
        assert n_python["flash_decode"][0] > 0
    assert all(r.captured for r, _ in model.graphs.values())
    static = next(iter(model.graphs.values()))[1]["cache"]
    for kind, entry in zip(cfg.layer_kinds(), static):
        if kind == "mamba":
            assert entry["ssm"].dtype == torch.float32
        else:
            assert ("ks" in entry) == bool(kv_bits)


# ------------------------------------------ cross-attention and the encoder


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,kv,dh", [
    (4, 1500, 16, 16, 64),  # whisper-medium's encoder: 30 s of frames
    (2, 37, 8, 2, 40), (1, 129, 8, 8, 36), (2, 300, 128, 128, 192)])
def test_attn_colsum_noncausal_kernel_vs_plain(cuda, dtype, b, t, h, kv,
                                                dh):
    """The non-causal form (an encoder's AttnCon) at Whisper's encoder
    shape, ragged T and Dh, GQA groups and MLA's width: within 1e-4 of its
    plain version, the column mass T·H, two calls bitwise equal, counted
    as ``colsum_noncausal``, and not the causal form's result."""
    g = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, t, kv, dh), generator=g, device=cuda).to(dtype)
    want = attn_colsum_ref(q, k, causal=False)
    before = dict(attn_colsum.by_kernel)
    got = attn_colsum(q, k, causal=False)
    torch.cuda.synchronize()
    assert attn_colsum.by_kernel["colsum_noncausal"] == \
        before["colsum_noncausal"] + 1
    assert attn_colsum.by_kernel["colsum_causal"] == before["colsum_causal"]
    assert _rel(got, want) < 1e-4
    np.testing.assert_allclose(got.sum(-1).cpu().numpy(), t * h, rtol=1e-4)
    assert torch.equal(got, attn_colsum(q, k, causal=False))
    assert _rel(attn_colsum(q, k), want) > 1e-2


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_cross_generate_graph_equals_python_loop(cuda, arch, kv_bits):
    """The smoke enc-dec and vision models on the card in bf16, every
    projection RTN-packed at 3 bits: ``generate`` through the captured
    decode, whose static cache holds the cross layers' K/V (computed by
    the prefill outside the graph), gives the Python loop's tokens bit for
    bit, greedy and sampled, with the same launches."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16",
                              kv_bits=kv_bits)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    spec = QuantSpec(bits=3, group_size=32)

    def pack(node):
        for name, w in node.items():
            if isinstance(w, dict):
                pack(w)
            elif name in ("wq", "wk", "wv", "wo", "wi", "wu", "wd"):
                node[name] = pack_weight(*quantize_weight_rtn(
                    w.float(), spec)[1:], spec)

    for layer in params["layers"] + params.get("encoder", {}).get(
            "layers", []):
        pack(layer)
    g = torch.Generator(device=cuda).manual_seed(1)
    prompts = torch.randint(2, cfg.vocab_size, (3, 64), generator=g,
                            device=cuda)
    rows = 40 if cfg.family == "encdec" else cfg.n_media_tokens
    extra = torch.randn((3, rows, cfg.d_model), generator=g,
                        device=cuda).to(torch.bfloat16)
    kw = {"frames" if cfg.family == "encdec" else "media": extra}
    for temperature in (0.0, 1.3):
        graph, python, n_graph, n_python = _loops(
            lambda loop: generate(model, params, prompts, 9,
                                  temperature=temperature, seed=4,
                                  loop=loop, **kw))
        assert torch.equal(graph, python), (graph.tolist(), python.tolist())
        assert n_graph == n_python
    assert n_python["quant_matmul"][1]["qmm_decode"] > 0
    if kv_bits:
        assert n_python["flash_decode"][0] > 0
    assert all(r.captured for r, _ in model.graphs.values())
    static = next(iter(model.graphs.values()))[1]["cache"]
    for kind, entry in zip(cfg.layer_kinds(), static):
        if kind == "cross" or cfg.family == "encdec":
            assert entry["xk"].shape == (3, rows, cfg.n_kv_heads,
                                         cfg.head_dim)
            assert entry["xk"].dtype == torch.bfloat16


def _ldlq_inputs(cuda, n, block, d_out, seed):
    """N blocks of rows, the diagonal U tiles of real Hessians and each
    row's E8 scale (its RMS / 2), on the card."""
    wb, ub = _solve_inputs(cuda, n, block, d_out, seed)
    scales = (wb.square().mean(-1).sqrt() * 0.5).clamp_min(1e-8)
    return wb, ub, scales


@pytest.mark.parametrize("n,block,d_out", [
    (1, 128, 8), (2, 24, 40), (3, 64, 576), (4, 96, 1000), (1, 128, 4096),
    (2, 128, 1024), (4, 33, 64), (1, 128, 32768), (3, 1, 16),
    (3, 127, 14336), (3, 33, 14336)])
def test_ldlq_block_kernel_bitwise_plain(cuda, n, block, d_out):
    """N 1-4, blocks of 1-128 rows, d_out 8-32768 (a multiple of 8; not
    of a block's 32-128 columns), N 3 at 14336 (the widest grid): deq and
    err bitwise the plain loop's, one launch a call."""
    wb, ub, scales = _ldlq_inputs(cuda, n, block, d_out, block + d_out)
    before = ldlq_block.launches
    got = ldlq_block(wb, ub, scales)
    torch.cuda.synchronize()
    assert ldlq_block.launches == before + 1
    want = ldlq_block_ref(wb, ub, scales)
    for name, a, b in zip(("deq", "err"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, _rel(a, b))


def _ldlq_lanes_n(cuda, lanes, d_out):
    """N matrices of d_out columns whose launch takes R = ``lanes`` on this
    card (the plan: R 4 up to 32 columns an SM, R 2 up to 64, R 1
    above)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = {4: 1, 2: 64 * sms // d_out, 1: 64 * sms // d_out + 1}[lanes]
    assert ldlq_plan(n, d_out)["lanes"] == lanes
    return n


@pytest.mark.parametrize("block", [1, 7, 33, 127])
@pytest.mark.parametrize("d_out", [8, 24, 1000, 4104])
@pytest.mark.parametrize("lanes", [4, 2, 1])
def test_ldlq_block_every_instance_bitwise_plain(cuda, lanes, d_out, block):
    """Every instance of the kernel, R = 4, 2 and 1 lanes a column, on
    blocks that are not a whole number of its rounds (4 R rows) and at
    d_out that leave a warp part-filled: deq and err bitwise the plain
    loop's (the U tiles of three Hessians, repeated over the N
    matrices)."""
    n = _ldlq_lanes_n(cuda, lanes, d_out)
    g = torch.Generator(device=cuda).manual_seed(block * d_out + lanes)
    wb = torch.randn((n, block, d_out), generator=g, device=cuda)
    ub = _solve_inputs(cuda, min(n, 3), block, 8, block)[1]
    ub = ub.repeat(-(-n // ub.shape[0]), 1, 1)[:n].contiguous()
    scales = (wb.square().mean(-1).sqrt() * 0.5).clamp_min(1e-8)
    got = ldlq_block(wb, ub, scales)
    want = ldlq_block_ref(wb, ub, scales)
    for name, a, b in zip(("deq", "err"), got, want):
        assert torch.equal(a, b), (name, _rel(a, b))


@pytest.mark.parametrize("lanes", [4, 2, 1])
def test_ldlq_block_subnormal_ties_bitwise_plain(cuda, lanes):
    """Rows whose two divisions, x / s_i and (x - deq) / U_ii, land exactly
    halfway between two fp32 subnormals (``subnormal_tie_inputs``), where
    a product by the fp64 reciprocal rounds the other way: the kernel's
    divisions round them to even as the plain loop's do, at R = 4, 2 and
    1."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    d_out = {4: 256, 2: 64 * sms, 1: 128 * sms}[lanes]
    assert ldlq_plan(1, d_out)["lanes"] == lanes
    wb, ub, scales = (t.to(cuda) for t in ldlq_subnormal_tie_inputs(
        128, d_out, seed=lanes))
    got = ldlq_block(wb, ub, scales)
    want = ldlq_block_ref(wb, ub, scales)
    assert bool((want[1] != 0).all())
    for name, a, b in zip(("deq", "err"), got, want):
        assert torch.equal(a, b), (name, _rel(a, b))
        assert torch.equal(torch.signbit(a), torch.signbit(b)), name


@pytest.mark.parametrize("step", [0.5, 0.25])
@pytest.mark.parametrize("d_out", [8, 256, 4104])
def test_ldlq_block_tie_octets_bitwise_plain(cuda, step, d_out):
    """Rows on a 1/2 or 1/4 grid at scale 1 and a diagonal U (no
    compensation moves them off the grid): every octet sits on the
    rounder's ties (half to even, the first of equal |δ|, δ = 0, da ==
    db), and the kernel breaks each as the plain loop does."""
    block = 64
    wb = tie_octets(block * d_out // 8, step, seed=d_out).reshape(
        1, block, d_out).to(cuda)
    ub = torch.diag_embed(torch.rand((1, block), device=cuda) + 0.5)
    scales = torch.ones((1, block), device=cuda)
    got = ldlq_block(wb, ub, scales)
    want = ldlq_block_ref(wb, ub, scales)
    for name, a, b in zip(("deq", "err"), got, want):
        assert torch.equal(a, b), (name, _rel(a, b))
        assert torch.equal(torch.signbit(a), torch.signbit(b)), name


@pytest.mark.parametrize("method", ["gptq", "ldlq"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_schedulers_bitwise_on_the_card(cuda, arch, method):
    """The overlapped schedule (the default on CUDA: no host sync until the
    end of the stack) against the sequential one on the card: the same
    params, reports and artifact entries bit for bit, through the
    ``gram``, ``attn_colsum`` and ``solve_block`` / ``ldlq_block``
    kernels."""
    from repro_torch.core.pipeline import RSQConfig, RSQPipeline

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    calib = torch.randint(2, cfg.vocab_size, (8, 64),
                          generator=torch.Generator().manual_seed(1))
    outs = {}
    for sched in ("sequential", None):
        pipe = RSQPipeline(model, RSQConfig(
            bits=4, group_size=32, method=method, scheduler=sched,
            pack_output=method == "gptq"))
        before = (ldlq_block if method == "ldlq" else solve_block).launches
        q, rep = pipe.run(params, calib, batch_size=4)
        torch.cuda.synchronize()
        assert (ldlq_block if method == "ldlq" else solve_block).launches \
            > before
        outs[rep["scheduler"]] = (q, rep, pipe.artifact)
    (q_s, rep_s, art_s), (q_o, rep_o, art_o) = (outs["sequential"],
                                                outs["overlapped"])

    def same(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b

    same(q_s, q_o)
    for tag, r in rep_s["layers"].items():
        assert r["weights"] == rep_o["layers"][tag]["weights"], tag
    if method == "gptq":
        same(art_s["entries"], art_o["entries"])
