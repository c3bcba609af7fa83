"""The port's batched, shape-grouped GPTQ solves against the reference's.

  * ``gptq_quantize_batched`` (N independent solves, one ``solve_block``
    call a block of rows for all N) against the reference's vmapped
    ``repro.core.distributed.gptq_quantize_batched`` on the same numpy
    stacks: at least 99% of the codes equal, the proxy loss within 1% and
    the scales within 1e-3 relative, as ``tests/test_torch_gptq.py`` holds
    one solve (the two frameworks' Cholesky factors differ in the last
    bits, which can move a code on a rounding boundary).  A moved code
    changes the error fed to every later row of its column, so with groups
    inside a block (2-bit, group 32) the later groups' scales of that column
    move with it: the scales are held in every column whose codes all agree
    (here they agree within 1e-6), the others by their codes and loss;
  * the port's grouped ``quantize_layer_weights`` against the same weights
    solved one at a time with ``gptq_quantize``: bitwise on the CPU;
  * the port's and the reference's ``quantize_layer_weights`` on the same
    Hessians of a ``llama3-8b-smoke`` block: codes >= 99%, losses within 1%;
  * the plain in-block loop on errors that lie exactly halfway between two
    fp32 subnormals (``subnormal_tie_inputs``, which the kernel is held to
    on the card): IEEE division's quotient, rounded to even, where a product
    with the fp64 reciprocal rounds the other way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.distributed import gptq_quantize_batched as ref_batched
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import quantize_layer_weights as ref_layer_weights
from repro.core.quantizer import QuantSpec as RefSpec
from repro.models import build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.gptq import gptq_quantize, gptq_quantize_batched
from repro_torch.core.pipeline import (RSQConfig, _solve_spec,
                                       finalize_layer_report,
                                       quantize_layer_weights)
from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels.gptq_block.ops import solve_block
from repro_torch.kernels.gptq_block.ref import subnormal_tie_inputs

ARCH = "llama3-8b-smoke"  # d_model 64, 4 heads / 2 KV, d_ff 128


def _stack(n, d_in, d_out, seed):
    """N weights and their Hessians 2·XᵀX from features of uneven scale,
    one input dead (``prepare_hessian``'s fix-up)."""
    rng = np.random.default_rng(seed)
    ws = rng.standard_normal((n, d_in, d_out)).astype(np.float32)
    x = (rng.standard_normal((n, 4 * d_in, d_in))
         * rng.uniform(0.1, 2.0, (n, 1, d_in))).astype(np.float32)
    x[:, :, 3] = 0.0
    return ws, (2.0 * np.einsum("nti,ntj->nij", x, x)).astype(np.float32)


def _case(n, bits, group, sym, d_in=256, block=128):
    """Cases at d_in 256, block 128 keep the ids they had before the d_in
    and block parameters."""
    parts = (n, bits, group, sym) + ((d_in, block) if (d_in, block) != (
        256, 128) else ())
    return pytest.param(n, bits, group, sym, d_in, block,
                        id="-".join(map(str, parts)))


@pytest.mark.parametrize("n,bits,group,sym,d_in,block", [
    _case(3, 2, 32, True), _case(3, 3, 128, True), _case(3, 4, -1, True),
    _case(3, 3, 64, True), _case(4, 2, 128, True), _case(4, 4, 32, True),
    _case(4, 3, -1, True), _case(3, 3, 64, False),
    _case(3, 3, 32, True, 192, 96)])
def test_batched_matches_reference(n, bits, group, sym, d_in, block):
    """N 3 (q/k/v-like) and 4 (an expert-like (E, d_in, d_out) stack);
    d_in 256 at the reference's default block of 128, and d_in 192 at a
    block of 96 rows."""
    ws, hs = _stack(n, d_in, 48, 10 * bits + n)
    out_r = ref_batched(jnp.asarray(ws), jnp.asarray(hs),
                        RefSpec(bits=bits, group_size=group, sym=sym),
                        block=block)
    out_p = gptq_quantize_batched(torch.from_numpy(ws), torch.from_numpy(hs),
                                  QuantSpec(bits=bits, group_size=group,
                                            sym=sym), block=block)
    assert out_p["q"].shape == out_r["q"].shape
    assert out_p["scale"].shape == out_r["scale"].shape
    equal = out_p["q"].numpy() == np.asarray(out_r["q"])  # (N, d_in, d_out)
    for i in range(n):
        assert equal[i].mean() >= 0.99, (i, equal[i].mean())
        loss_r, loss_p = float(out_r["err"][i]), float(out_p["err"][i])
        assert abs(loss_p - loss_r) <= 0.01 * loss_r, (i, loss_p, loss_r)
    cols = equal.all(axis=1)  # (N, d_out): no code of the column moved
    assert cols.mean() >= 0.9, cols.mean()
    np.testing.assert_allclose(out_p["scale"].numpy().transpose(0, 2, 1)[cols],
                               np.asarray(out_r["scale"]).transpose(0, 2, 1)
                               [cols], rtol=1e-3)


@pytest.mark.parametrize("bits,group", [(3, 128), (2, 32), (4, -1)])
def test_batched_is_each_single_solve_bitwise(bits, group):
    """On the CPU a stack's solve gives each matrix the bits of its own
    ``gptq_quantize``."""
    ws, hs = _stack(3, 256, 40, bits)
    spec = QuantSpec(bits=bits, group_size=group)
    bat = gptq_quantize_batched(torch.from_numpy(ws), torch.from_numpy(hs),
                                spec)
    for i in range(3):
        one = gptq_quantize(torch.from_numpy(ws[i]), torch.from_numpy(hs[i]),
                            spec)
        for key in ("q", "w_deq", "scale", "zero", "err"):
            assert torch.equal(bat[key][i], one[key]), (i, key)


def _smoke_block():
    """Layer 0 of the reference's ``llama3-8b-smoke`` init, as the
    reference's block tree and the port's, and Hessians for each of its
    weights (2·XᵀX of uneven features, as the pipeline accumulates)."""
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    params = jax.tree.map(np.asarray,
                          jax.jit(build_model(cfg).init)(jax.random.key(0)))
    ref_blk = jax.tree.map(lambda a: a[0], params["groups"]["b0"])
    port_blk = params_from_jax(params, ModelConfig(**dataclasses.asdict(cfg)),
                               device="cpu")["layers"][0]
    rng = np.random.default_rng(5)
    hessians = {}
    for sub in ("mixer", "ffn"):
        for name, w in ref_blk[sub].items():
            d_in = w.shape[0]
            x = (rng.standard_normal((256, d_in))
                 * rng.uniform(0.1, 2.0, (1, d_in))).astype(np.float32)
            hessians[f"{sub}/{name}"] = (2.0 * x.T @ x).astype(np.float32)
    return ref_blk, port_blk, hessians


@pytest.mark.parametrize("bits,group", [(3, 128), (2, 32)])
def test_grouped_layer_solve_is_one_at_a_time_bitwise(bits, group):
    """Grouped by shape (wq/wo, wk/wv, wi/wu, wd in the smoke block) the
    layer's solves give each weight the bits of its own solve, and the
    report its own loss."""
    _, blk, hessians = _smoke_block()
    hs = {p: torch.from_numpy(h) for p, h in hessians.items()}
    rsq = RSQConfig(bits=bits, group_size=group)
    collect = {}
    new_p, report = quantize_layer_weights(blk, hs, rsq, collect=collect)
    shapes = {tuple(blk[p.split("/")[0]][p.split("/")[1]].shape)
              for p in hs}
    assert len(shapes) < len(hs)  # some weights did share a solve
    for path, h in hs.items():
        sub, name = path.split("/")
        w = blk[sub][name]
        spec, block = _solve_spec(rsq, w.shape[0])  # the pipeline's own
        one = gptq_quantize(w, h, spec, damp=rsq.damp, block=block)
        assert torch.equal(new_p[sub][name], one["w_deq"]), path
        for key in ("q", "scale", "zero"):
            assert torch.equal(collect[path][key], one[key]), (path, key)
        assert report[path] == float(one["err"]), path


def test_stacked_weight_reports_the_mean_loss():
    """A stacked (E, d_in, d_out) weight with its (E, d_in, d_in) Hessians
    is E solves of the group, and its report the mean of their losses; a
    2-D weight of the same shape solves in the same call."""
    ws, hs = _stack(4, 128, 32, 3)
    blk = {"ffn": {"experts": torch.from_numpy(ws[:3]),
                   "shared": torch.from_numpy(ws[3])}}
    hess = {"ffn/experts": torch.from_numpy(hs[:3]),
            "ffn/shared": torch.from_numpy(hs[3])}
    rsq = RSQConfig(bits=3, group_size=64)
    new_p, report = quantize_layer_weights(blk, hess, rsq)
    one = [gptq_quantize(torch.from_numpy(ws[i]), torch.from_numpy(hs[i]),
                         rsq.spec()) for i in range(4)]
    assert torch.equal(new_p["ffn"]["experts"],
                       torch.stack([o["w_deq"] for o in one[:3]]))
    assert torch.equal(new_p["ffn"]["shared"], one[3]["w_deq"])
    assert report["ffn/experts"] == float(
        torch.stack([o["err"] for o in one[:3]]).mean())
    assert report["ffn/shared"] == float(one[3]["err"])


def test_finalize_layer_report_reads_floats_back():
    report = {"a/x": torch.tensor(1.5), "a/y": torch.tensor(2.25)}
    assert finalize_layer_report(report) == {"a/x": 1.5, "a/y": 2.25}
    assert finalize_layer_report({}) == {}


@pytest.mark.parametrize("bits,group", [(3, 128), (4, 32)])
def test_layer_solve_matches_reference(bits, group):
    """The port's grouped layer solve against the reference's (its
    vmapped ``gptq_quantize_batched`` per shape group) on the same block
    and Hessians."""
    ref_blk, blk, hessians = _smoke_block()
    ref_collect, collect = {}, {}
    _, ref_rep = ref_layer_weights(
        ref_blk, {p: jnp.asarray(h) for p, h in hessians.items()},
        RefRSQConfig(bits=bits, group_size=group), collect=ref_collect)
    _, rep = quantize_layer_weights(
        blk, {p: torch.from_numpy(h) for p, h in hessians.items()},
        RSQConfig(bits=bits, group_size=group), collect=collect)
    assert set(rep) == set(ref_rep) == set(hessians)
    for path in hessians:
        same = (collect[path]["q"].numpy()
                == np.asarray(ref_collect[path]["q"])).mean()
        assert same >= 0.99, (path, same)
        assert abs(rep[path] - ref_rep[path]) <= 0.01 * ref_rep[path], path


def test_solve_block_refuses_other_devices():
    """Dispatch is by device: neither cpu nor cuda raises."""
    wb = torch.empty((1, 8, 4), device="meta")
    ub = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        solve_block(wb, ub, QuantSpec(bits=3, group_size=8), 8)


@pytest.mark.parametrize("sym,rows,fixed", [(True, 128, False),
                                            (False, 32, False),
                                            (True, 128, True)])
def test_plain_loop_rounds_subnormal_ties_as_ieee_division(sym, rows, fixed):
    """Every error of ``subnormal_tie_inputs`` is the fp32 quotient x / U_ii
    (a subnormal, tie rounded to even), not the fp64 reciprocal's product;
    q is the zero point and deq 0, with a group's own scale (1e-9, sym and
    asym) or a fixed one (1000, where x / s is subnormal too)."""
    wb, ub = subnormal_tie_inputs(128, 96, seed=rows)
    spec = QuantSpec(bits=3 if sym else 4, group_size=rows, sym=sym)
    pair = ((torch.full((1, 96), 1000.0), torch.full((1, 96), 4.0))
            if fixed else None)
    q, deq, err, scale, zero = solve_block(wb, ub, spec, rows, pair)
    u = torch.diagonal(ub[0])[:, None]
    assert torch.equal(err[0], wb[0] / u)
    assert bool((err != 0).all())
    assert bool((err.abs() < torch.finfo(torch.float32).tiny).all())
    recip = (wb[0].double() * (1.0 / u.double())).float()
    assert bool((recip != err[0]).all())
    assert torch.equal(deq.abs(), torch.zeros_like(deq))
    assert torch.equal(q, zero.repeat_interleave(128 // scale.shape[1], 1)
                       .int())
