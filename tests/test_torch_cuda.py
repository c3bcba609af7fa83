"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: CUDA kernels have no CPU mode, so these skip on a machine
without an NVIDIA GPU.  They import neither JAX nor the reference, so on the
card they run without the JAX-based ``tests/conftest.py``:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances are relative to the largest reference magnitude:
  * fp32 products: 1e-5 — the kernel and the plain version sum the same
    fp32 terms in different orders;
  * attn_colsum: 1e-4 — two passes of exp and the column sums added with
    fp32 atomics in a run-dependent order;
  * bf16 outputs: 8e-3 — one rounding of the fp32 result to bf16
    (2^-8 relative) at a different point.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import QuantSpec, quantize_weight_rtn
from repro_torch.kernels.attn_colsum.ops import attn_colsum
from repro_torch.kernels.attn_colsum.ref import attn_colsum_ref
from repro_torch.kernels.gram.ops import weighted_gram
from repro_torch.kernels.gram.ref import weighted_gram_ref
from repro_torch.kernels.quant_matmul.ops import pack_weight, quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

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

