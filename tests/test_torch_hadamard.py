"""The port's fast Walsh-Hadamard transform (``repro_torch.kernels.hadamard``)
against the reference on the CPU: its Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it), its jnp oracle, and its
``hadamard_transform`` with the same numpy Q_m.

Tolerances are the reference test's: fp32 1e-5 (the butterfly here, the
H_128 product and butterflies there, the dense product in the oracle: the
same fp32 terms summed in other orders); bf16 5e-2 (one bf16 rounding of
values of magnitude up to ~4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hadamard.ops import fwht as ref_fwht
from repro.kernels.hadamard.ops import hadamard_transform as ref_transform
from repro.kernels.hadamard.ref import fwht_ref as ref_oracle
from repro.kernels.hadamard.ref import hadamard_matrix as ref_matrix
from repro_torch.kernels.hadamard import ref
from repro_torch.kernels.hadamard.ops import fwht, hadamard_transform

SHAPES = [(8, 64), (16, 128), (4, 512), (3, 256), (2, 4096), (5, 1), (7, 2)]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fwht_vs_reference(shape, dtype):
    """Against the reference's Pallas kernel (interpret mode) and its
    dense-product oracle on the same inputs."""
    t_dtype, j_dtype, tol = DTYPES[dtype]
    x = _x(shape, sum(shape))
    got = fwht(torch.from_numpy(x).to(t_dtype))
    assert got.dtype == t_dtype and got.shape == shape
    xj = jnp.asarray(x).astype(j_dtype)
    for want in (ref_fwht(xj), ref_oracle(xj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("n", [1, 8, 256, 4096])
def test_hadamard_matrix_matches_reference(n):
    np.testing.assert_allclose(ref.hadamard_matrix(n).numpy(),
                               np.asarray(ref_matrix(n)), atol=1e-7)


@pytest.mark.parametrize("shape", [(6, 256), (3, 1), (2, 4096), (4, 5, 64)],
                         ids=str)
def test_fwht_involution(shape):
    x = torch.from_numpy(_x(shape, 0))
    np.testing.assert_allclose(fwht(fwht(x)).numpy(), x.numpy(), atol=1e-5)


@pytest.mark.parametrize("d,m", [(384, 3), (896, 7), (576, 9)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hadamard_transform_vs_reference(d, m, dtype):
    """(H_{2^k} ⊗ Q_m) with the same numpy Q_m: against the reference's
    ``hadamard_transform`` and the dense Kronecker product."""
    t_dtype, j_dtype, tol = DTYPES[dtype]
    x = _x((5, d), d)
    q_m, _ = np.linalg.qr(np.random.default_rng(m).standard_normal((m, m)))
    q_m = q_m.astype(np.float32)
    got = hadamard_transform(torch.from_numpy(x).to(t_dtype),
                             torch.from_numpy(q_m))
    assert got.dtype == t_dtype and got.shape == (5, d)
    want = ref_transform(jnp.asarray(x).astype(j_dtype), jnp.asarray(q_m))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    if dtype == "float32":
        dense = x @ np.kron(np.asarray(ref_matrix(d // m)), q_m)
        np.testing.assert_allclose(got.numpy(), dense, atol=1e-4)


def test_hadamard_transform_power_of_two_is_fwht():
    x = torch.from_numpy(_x((3, 512), 1))
    assert torch.equal(hadamard_transform(x), fwht(x))


def test_wrong_widths_raise():
    with pytest.raises(ValueError):
        fwht(torch.zeros((2, 12)))
    with pytest.raises(ValueError):  # 384 = 128 · 3 needs a (3, 3) Q_m
        hadamard_transform(torch.zeros((2, 384)))
    with pytest.raises(ValueError):
        hadamard_transform(torch.zeros((2, 384)), torch.eye(5))
