"""The extend kernel's tensor-core arithmetic, emulated on the CPU.

``fe_extend_kernel`` (``csrc/flash_decode.cu``) runs Q.K^T and P.V on the
tensor cores in TF32 and is held to its fp32 plain version at TOL_KV = 1e-5.
It keeps that by feeding exact operands (int8 codes, 2-bit levels, bf16
values), splitting fp32 ones (P, and fp32 q / k / v) into TF32 hi + lo, and
applying every scale in fp32 after the product.  ``ref.tf32_round`` rounds
as ``cvt.rna.tf32.f32`` does and ``ref.paged_flash_extend_emulated`` repeats
the kernel's operand handling tile by tile; here it is held within TOL_KV
of ``paged_flash_extend_ref`` for both codecs, bf16 and fp32 inputs, with
and without past pages and at the phase-2 shape of ``chip_smoke.py``, and
the same emulation with P left unsplit (TF32 hi only) is shown to miss
TOL_KV, which is why the kernel splits it.  Inputs are drawn with numpy.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode.ref import (paged_flash_extend_emulated,
                                                  paged_flash_extend_ref,
                                                  tf32_round, tf32_split)
from repro_torch.models.attention import kv_codec

TOL_KV = 1e-5  # chip_smoke.py and tests/test_torch_cuda.py hold the kernel


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(seed, kv_bits, n_past, L, h, kv, d, dtype, page=64):
    """Random K/V pages through the port's codec, a shuffled table of
    ``n_past`` of them and the chunk's q / k_new / v_new in ``dtype``."""
    rng = np.random.default_rng(seed)
    codec = kv_codec(kv_bits, page)
    n_pages = n_past + 1
    k, v = (torch.from_numpy(rng.normal(size=(1, n_pages * page, kv, d))
                             .astype(np.float32)) for _ in range(2))
    kq, ks = codec.encode(k)
    vq, vs = codec.encode(v)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape(n_pages, page // codec.chunk, kv),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape(n_pages, page // codec.chunk, kv)]
    tbl = torch.from_numpy((rng.permutation(n_pages - 1)[:n_past] + 1)
                           .astype(np.int32))
    q, k_new, v_new = (torch.from_numpy(rng.normal(size=shape)
                                        .astype(np.float32)).to(dtype)
                       for shape in ((1, L, h, d), (1, L, kv, d),
                                     (1, L, kv, d)))
    kw = dict(kv_bits=kv_bits, chunk=codec.chunk, dh=d, dv=d, page=page)
    return (tbl, q, k_new, v_new, *pools), kw


def test_tf32_round_is_cvt_rna():
    """10 explicit mantissa bits, ties away from zero; exact operands (int8
    codes, 2-bit levels, bf16 values) pass unchanged; hi + lo of a split
    is within 2^-22 of the value."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3 * 2 ** -13, 65519.0, 65520.0])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         3 * 2 ** -13, 65504.0, 65536.0])
    assert torch.equal(tf32_round(x), want)
    exact = torch.cat([torch.arange(-128, 128, dtype=torch.float32),
                       torch.tensor([-1.0, -0.25, 0.25, 1.0]),
                       torch.randn(1000).to(torch.bfloat16).float()])
    assert torch.equal(tf32_round(exact), exact)
    y = torch.randn(10000) * 10.0 ** torch.randint(-6, 6, (10000,))
    hi, lo = tf32_split(y)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo),
                                                           lo)
    assert bool(((hi + lo - y).abs() <= y.abs() * 2.0 ** -22).all())


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("n_past,L,h,kv,d", [(0, 70, 8, 2, 40),
                                             (3, 100, 8, 2, 128),
                                             (2, 33, 16, 1, 16)])
def test_emulated_extend_within_tol_kv(kv_bits, dtype, n_past, L, h, kv, d):
    args, kw = _inputs(1, kv_bits, n_past, L, h, kv, d, dtype)
    want = paged_flash_extend_ref(*args, **kw)
    got = paged_flash_extend_emulated(*args, **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_emulated_extend_at_the_phase2_shape(kv_bits):
    """chip_smoke.py's phase-2 extend: L 256 over 16 past pages, H 32 / 8,
    Dh 128, bf16 inputs as the model passes them."""
    args, kw = _inputs(2, kv_bits, 16, 256, 32, 8, 128, torch.bfloat16)
    want = paged_flash_extend_ref(*args, **kw)
    assert _rel(paged_flash_extend_emulated(*args, **kw), want) < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L", [(16, 256), (0, 70)])
def test_unsplit_p_misses_tol_kv(kv_bits, n_past, L):
    """P rounded once to TF32 (about 11 bits) moves the output by ~1e-4 of
    its largest magnitude, above TOL_KV; its hi + lo split (about 22 bits)
    stays within it."""
    args, kw = _inputs(3, kv_bits, n_past, L, 32, 8, 128, torch.bfloat16)
    want = paged_flash_extend_ref(*args, **kw)
    split = _rel(paged_flash_extend_emulated(*args, **kw), want)
    unsplit = _rel(paged_flash_extend_emulated(*args, split_p=False, **kw),
                   want)
    assert unsplit > TOL_KV
    assert split < TOL_KV
