"""The plain PyTorch versions of the port's kernels (what a CPU tensor
runs) against the reference: its jnp oracles, its Pallas kernels in
interpret mode (as the reference's own tests run them off-TPU), and, for
AttnCon, ``flash_attention(colsum=True)``.  Plus the dispatch rule: a
tensor on neither the CPU nor a CUDA card raises.

Tolerances (fp32): 1e-5 relative to the largest magnitude for products and
grams — XLA and PyTorch sum the same fp32 terms in different orders; 1e-5
for the AttnCon scores (exp and normalization in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hessian as ref_hess
from repro.core.quantizer import QuantSpec as RefSpec
from repro.core.quantizer import pack_codes as ref_pack
from repro.core.quantizer import quantize_weight_rtn as ref_rtn
from repro.kernels.attn_colsum.kernel import attn_colsum_pallas
from repro.kernels.attn_colsum.ops import attn_colsum as ref_colsum_ops
from repro.kernels.attn_colsum.ref import attn_colsum_ref as ref_colsum
from repro.kernels.quant_matmul.kernel import quant_matmul_pallas
from repro.kernels.quant_matmul.ref import quant_matmul_ref as ref_qmm
from repro.models.attention import flash_attention as ref_flash
from repro_torch.core import hessian
from repro_torch.core.quantizer import words_from_numpy
from repro_torch.kernels.attn_colsum.ops import attn_colsum
from repro_torch.kernels.gram.ops import weighted_gram
from repro_torch.kernels.hadamard.ops import fwht
from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels.quant_matmul.kernel import qmm_kernel, qmm_t_kernel
from repro_torch.kernels.quant_matmul.ops import (PackedWeight, pack_weight,
                                                  packed_weight_from_artifact,
                                                  quant_matmul, quant_matmul_t)

RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _packed(bits, k, n, gs, seed=0):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    _, q, s, z = ref_rtn(jnp.asarray(w), RefSpec(bits, gs))
    words = np.asarray(ref_pack(q, bits))
    pw = PackedWeight(w_packed=words_from_numpy(words), scale=_t(s),
                      zero=_t(z), bits=bits, group_size=gs, d_in=k)
    return pw, (jnp.asarray(words), s, z)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_quant_matmul_plain_vs_reference(bits, m):
    k, n, gs = 256, 128, 128
    pw, (words, s, z) = _packed(bits, k, n, gs, seed=bits)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    got = quant_matmul(_t(x), pw).numpy()
    _close(got, ref_qmm(jnp.asarray(x), words, s, z, bits=bits,
                        group_size=gs))
    if bits != 3:  # the Pallas kernel tiles k in whole words: no 3-bit
        m_pad = -(-m // 8) * 8  # its row tile needs m % 8 == 0
        xp = np.zeros((m_pad, k), np.float32)
        xp[:m] = x
        want = quant_matmul_pallas(jnp.asarray(xp), words, s, z, bits=bits,
                                   group_size=gs, m_blk=m_pad, n_blk=128,
                                   k_blk=256, interpret=True)
        _close(got, np.asarray(want)[:m])


def test_quant_matmul_ragged_3bit_word_and_groups():
    """d_in that leaves the last 3-bit word part-filled, per-tensor group."""
    k, n = 37, 16
    pw, (words, s, z) = _packed(3, k, n, k, seed=5)
    x = np.random.default_rng(6).standard_normal((5, k)).astype(np.float32)
    _close(quant_matmul(_t(x), pw).numpy(),
           ref_qmm(jnp.asarray(x), words, s, z, bits=3, group_size=k))


@pytest.mark.parametrize("n,d,use_kernel", [(64, 128, True), (64, 128, False),
                                            (50, 64, False)])
def test_gram_accumulate_vs_reference(n, d, use_kernel):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    r = rng.uniform(0.01, 1.0, (n,)).astype(np.float32)
    h0 = rng.standard_normal((d, d)).astype(np.float32)
    want = ref_hess.accumulate(jnp.asarray(h0), jnp.asarray(x),
                               jnp.asarray(r), use_kernel=use_kernel)
    got = hessian.accumulate(_t(h0), _t(x), _t(r))
    _close(got.numpy(), want)
    fresh = hessian.accumulate(None, _t(x), _t(r))
    _close(fresh.numpy(), ref_hess.accumulate(None, jnp.asarray(x),
                                              jnp.asarray(r)))
    _close(weighted_gram(_t(x)).numpy(), np.asarray(x).T @ np.asarray(x))


@pytest.mark.parametrize("b,t,h,kv,dh", [(2, 64, 4, 2, 16), (1, 48, 4, 4, 8)])
def test_attn_colsum_plain_vs_reference(b, t, h, kv, dh):
    rng = np.random.default_rng(t)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    got = attn_colsum(_t(q), _t(k)).numpy()
    # the jnp oracle on per-head (BH, T, d), keys repeated to the q heads
    kr = np.repeat(k, h // kv, axis=2)
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, t, dh)
    kf = kr.transpose(0, 2, 1, 3).reshape(b * h, t, dh)
    oracle = np.asarray(ref_colsum(jnp.asarray(qf), jnp.asarray(kf)))
    _close(got, oracle.reshape(b, h, t).sum(1))
    # the Pallas kernel, interpret mode, one block and two blocks
    for blk in (t, t // 2):
        pallas = attn_colsum_pallas(jnp.asarray(qf), jnp.asarray(kf),
                                    blk=blk, interpret=True)
        _close(got, np.asarray(pallas).reshape(b, h, t).sum(1))
    _close(got, ref_colsum_ops(jnp.asarray(q), jnp.asarray(k)))
    # the reference's calibration path: the streaming flash scan
    _, col = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       kv_chunk=16, colsum=True)
    _close(got, col)


@pytest.mark.parametrize("b,t,h,kv,dh,blk", [(2, 64, 4, 2, 16, 32),
                                             (1, 50, 4, 4, 8, 50)])
def test_attn_colsum_noncausal_plain_vs_reference(b, t, h, kv, dh, blk):
    """``causal=False`` (an encoder's AttnCon): the plain version against
    the reference's plain version and its Pallas kernel in interpret mode
    (per head, keys repeated), and against the reference's streaming
    ``flash_attention(colsum=True, causal=False)`` on a key length that is
    no multiple of its 16-key chunks (T 50: padded and masked there)."""
    rng = np.random.default_rng(t + 1)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    got = attn_colsum(_t(q), _t(k), causal=False).numpy()
    kr = np.repeat(k, h // kv, axis=2)
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, t, dh)
    kf = kr.transpose(0, 2, 1, 3).reshape(b * h, t, dh)
    oracle = np.asarray(ref_colsum(jnp.asarray(qf), jnp.asarray(kf),
                                   causal=False))
    _close(got, oracle.reshape(b, h, t).sum(1))
    pallas = attn_colsum_pallas(jnp.asarray(qf), jnp.asarray(kf),
                                causal=False, blk=blk, interpret=True)
    _close(got, np.asarray(pallas).reshape(b, h, t).sum(1))
    _, col = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=False, kv_chunk=16, colsum=True)
    _close(got, col)
    # every query's row sums to 1: the columns hold T x H in all
    np.testing.assert_allclose(got.sum(-1), t * h, rtol=1e-5)
    assert not np.allclose(got, attn_colsum(_t(q), _t(k)).numpy())


@pytest.mark.parametrize("kernel", ["gram", "attn_colsum", "quant_matmul",
                                    "fwht"])
def test_wrappers_raise_off_cpu_and_cuda(kernel):
    """Dispatch is by device only: a meta tensor neither runs the plain
    version nor reaches a kernel."""
    x = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError):
        if kernel == "gram":
            weighted_gram(x)
        elif kernel == "attn_colsum":
            attn_colsum(x.reshape(1, 4, 4, 32), x.reshape(1, 4, 4, 32))
        elif kernel == "fwht":
            fwht(x)
        else:
            quant_matmul(x, _packed(4, 128, 16, 128)[0])


@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("load", ["pack_weight", "artifact"])
@pytest.mark.parametrize("zero", ["reference", "fractional", "negative",
                                  "above_maxq", "nan"])
def test_packed_zeros_are_integers_in_range(zero, load, bits):
    """The kernels take code - zero as an exact integer: a weight whose
    zeros are not integers in [0, 2^bits - 1] is refused where it is packed
    or loaded; the reference's RTN zeros pass."""
    k, n, gs = 256, 16, 128
    w = np.random.default_rng(bits).standard_normal((k, n)).astype(np.float32)
    _, q, s, z = ref_rtn(jnp.asarray(w), RefSpec(bits, gs))
    z = np.array(z, np.float32)
    bad = {"reference": None, "fractional": 1.5, "negative": -1.0,
           "above_maxq": 2.0 ** bits, "nan": np.nan}[zero]
    if bad is not None:
        z[1, 3] = bad
    if load == "pack_weight":
        def build():
            return pack_weight(torch.from_numpy(np.array(q, np.int32)),
                               _t(s), torch.from_numpy(z),
                               QuantSpec(bits=bits, group_size=gs))
    else:
        def build():
            entry = {"codes": np.asarray(ref_pack(q, bits)),
                     "scale": np.asarray(s), "zero": z}
            return packed_weight_from_artifact(
                entry, {"group_size": gs, "d_in": k}, {"bits": bits},
                device="cpu")
    if bad is None:
        pw = build()
        np.testing.assert_array_equal(pw.zero.numpy(), z)
    else:
        with pytest.raises(ValueError, match="integers in"):
            build()


@pytest.mark.parametrize("m,dtype,kernel", [
    (1, torch.bfloat16, "qmm_decode"), (4, torch.float32, "qmm_decode"),
    (5, torch.bfloat16, "qmm_tc"), (512, torch.bfloat16, "qmm_tc"),
    (5, torch.float32, "qmm_tc_f32"), (128, torch.float32, "qmm_tc_f32"),
    (65, torch.float32, "qmm_tc_f32")])
def test_quant_matmul_counts_launches_by_kernel(m, dtype, kernel):
    """Each CUDA launch of quant_matmul is also counted under the kernel
    that ran: split-k decode for m <= 4, else the tensor-core tile in its
    bf16 form for bf16 x and its three-term fp32 form for fp32 x."""
    assert qmm_kernel(m, dtype) == kernel
    assert kernel in quant_matmul.by_kernel


@pytest.mark.parametrize("m,bits,gs,kernel", [
    (1, 3, 128, "qmm_t_decode"), (4, 2, 16, "qmm_t_decode"),
    (4, 2, 8, "qmm_t_tile"), (5, 3, 128, "qmm_t_tile"),
    (128, 8, 4, "qmm_t_tile")])
def test_quant_matmul_t_counts_launches_by_kernel(m, bits, gs, kernel):
    """Each CUDA launch of quant_matmul_t is also counted under the kernel
    that ran: the decode shape for m <= 4 where a packed word spans at most
    two quant groups (gs >= 32 / bits), else the fp32 tile."""
    assert qmm_t_kernel(m, bits, gs) == kernel
    assert kernel in quant_matmul_t.by_kernel


@pytest.mark.parametrize("edit", ["none", "source", "header"])
def test_kernel_library_rebuilt_when_its_source_or_a_shared_header_changes(
        tmp_path, monkeypatch, edit):
    """A built library is named by its source and the shared csrc/*.cuh
    headers: editing either names a new library (built anew), editing
    neither reuses the old one."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._target("k")
    if edit == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\n// two\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("// two\n")
    assert (build._target("k") == before) == (edit == "none")
