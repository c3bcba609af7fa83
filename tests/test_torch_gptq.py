"""Port GPTQ (``repro_torch.core.gptq``) against the reference on the same
(W, H): at least 99% of the codes equal and the proxy loss within 1%.
(The group scales follow the reference's compiled solver,
``gptq.solver_params``; with them the codes agree bit for bit in these
cases.)

Codes are not required to be bitwise equal: the fp32 Cholesky and the
triangular inverse of H run in different orders in the two frameworks, and
a last-bit difference in U can move a weight that sits on a rounding
boundary to the neighbouring code, after which the error compensation of
the following rows differs slightly too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gptq import gptq_quantize as ref_gptq
from repro.core.gptq import hinv_cholesky as ref_hinv
from repro.core.gptq import prepare_hessian as ref_prepare
from repro.core.quantizer import QuantSpec as RefSpec
from repro_torch.core.gptq import gptq_quantize, hinv_cholesky, prepare_hessian
from repro_torch.core.quantizer import QuantSpec


def _problem(d_in, d_out, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    x = (rng.standard_normal((n, d_in))
         * rng.uniform(0.1, 2.0, (1, d_in))).astype(np.float32)
    x[:, 3] = 0.0  # a dead input row: prepare_hessian's fix-up
    return w, (2.0 * x.T @ x).astype(np.float32)


def test_prepare_hessian_and_cholesky_match():
    _, h = _problem(128, 8, 512, 0)
    hp = prepare_hessian(torch.from_numpy(h))
    np.testing.assert_allclose(hp.numpy(), ref_prepare(jnp.asarray(h)),
                               rtol=1e-6, atol=1e-6)
    u_r = np.asarray(ref_hinv(ref_prepare(jnp.asarray(h))))
    u_p = hinv_cholesky(hp).numpy()
    assert np.abs(u_p - u_r).max() < 1e-4 * np.abs(u_r).max()


@pytest.mark.parametrize("bits,group,d_in", [(3, 128, 256), (4, 64, 128),
                                             (2, -1, 64), (3, 128, 384)])
def test_gptq_codes_and_loss_match(bits, group, d_in):
    w, h = _problem(d_in, 48, 4 * d_in, bits + d_in)
    out_r = ref_gptq(jnp.asarray(w), jnp.asarray(h),
                     RefSpec(bits=bits, group_size=group))
    out_p = gptq_quantize(torch.from_numpy(w), torch.from_numpy(h),
                          QuantSpec(bits=bits, group_size=group))
    same = (out_p["q"].numpy() == np.asarray(out_r["q"])).mean()
    assert same >= 0.99, same
    loss_r, loss_p = float(out_r["err"]), float(out_p["err"])
    assert abs(loss_p - loss_r) <= 0.01 * loss_r, (loss_p, loss_r)
    assert out_p["scale"].shape == out_r["scale"].shape
    np.testing.assert_allclose(out_p["scale"].numpy(), out_r["scale"],
                               rtol=1e-3)
