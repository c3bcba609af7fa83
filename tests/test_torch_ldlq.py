"""LDLQ with the E8 rounder (``core/ldlq``, ``kernels/ldlq_block``) against
the reference's (``repro.core.ldlq``, ``ldlq_quantize_batched``).

Tolerances:
  * ``e8_nearest``: equal values on every octet (normal draws, and points
    on a 1/2- and a 1/4-grid, which sit on the rounder's ties).  The sign
    of a zero coordinate is not compared: XLA folds the flip's zero
    products;
  * ``ldlq_quantize`` on one H: the scales within 2 ulps (the reference
    sums a row's squares in fp32 in XLA's order, the port in fp64 and
    rounds once: no fp32 order of the port's is nearer the reference,
    ``test_row_scales_no_further_from_the_reference_than_fp32``), so the
    dequantized rows
    are compared as lattice points (w_deq / scale, on the 1/2-grid): at
    least 99% of the octets equal (all of them here), and the proxy loss
    within 1e-4 relative.  The two frameworks' factors differ in the last
    bits: the port factors H in fp64 and rounds U once, the reference in
    fp32;
  * the plain row loop on the reference's own U and scales: the
    dequantized rows bitwise, the loss (summed in another order) within
    1e-4;
  * the pipeline (``method="ldlq"``) on the same params and calibration
    tokens: each weight's dequantized values within 1e-5 relative in at
    least 99% of its octets, its proxy loss within 1%;
  * batched against one at a time, and the grouped layer solve against
    each weight's own solve: bitwise on the CPU;
  * ``subnormal_tie_inputs``: both divisions of every row checked to be
    ties between two fp32 subnormals, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.distributed import ldlq_quantize_batched as ref_batched
from repro.core.gptq import hinv_cholesky as ref_hinv_cholesky
from repro.core.gptq import prepare_hessian as ref_prepare_hessian
from repro.core.ldlq import e8_nearest as ref_e8_nearest
from repro.core.ldlq import ldlq_quantize as ref_ldlq_quantize
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.models import build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.ldlq import (e8_nearest, ldlq_quantize,
                                   ldlq_quantize_batched, row_scales)
from repro_torch.core.pipeline import (RSQConfig, RSQPipeline,
                                       quantize_layer_weights)
from repro_torch.kernels.ldlq_block.ops import ldlq_block
from repro_torch.kernels.ldlq_block.ref import (ldlq_block_ref,
                                                subnormal_tie_inputs,
                                                tie_octets)
from repro_torch.launch.quantize import main as quantize_main
from repro_torch.models.lm import Model

N_OCTETS = 200_000


def _octets(kind: str) -> np.ndarray:
    if kind == "normal":
        return (np.random.default_rng(0).standard_normal((N_OCTETS, 8))
                * 2.0).astype(np.float32)
    step = 0.5 if kind == "half" else 0.25
    return tie_octets(N_OCTETS, step, seed=int(8 * step)).numpy()


@pytest.mark.parametrize("kind", ["normal", "half", "quarter"])
def test_e8_nearest_matches_reference(kind):
    y = _octets(kind)
    want = np.asarray(jax.jit(ref_e8_nearest)(jnp.asarray(y)))
    got = e8_nearest(torch.from_numpy(y)).numpy()
    assert np.array_equal(got, want)
    # a lattice point: integers or integers + 1/2, with an even sum
    frac = got - np.floor(got)
    assert np.all((frac == 0) | (frac == 0.5))
    assert np.all(np.remainder(got.sum(-1), 2.0) == 0)


def _stack(n, d_in, d_out, seed):
    """N weights and their Hessians 2·XᵀX from features of uneven scale,
    one input dead (``prepare_hessian``'s fix-up)."""
    rng = np.random.default_rng(seed)
    ws = rng.standard_normal((n, d_in, d_out)).astype(np.float32)
    x = (rng.standard_normal((n, 4 * d_in, d_in))
         * rng.uniform(0.1, 2.0, (n, 1, d_in))).astype(np.float32)
    x[:, :, 3] = 0.0
    return ws, (2.0 * np.einsum("nti,ntj->nij", x, x)).astype(np.float32)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _points(w_deq, scales) -> np.ndarray:
    """(rows, d_out / 8, 8) lattice points (x2: integers) of dequantized
    rows."""
    p = np.round(2.0 * np.asarray(w_deq, np.float64)
                 / np.asarray(scales, np.float64))
    return p.reshape(p.shape[0], -1, 8)


@pytest.mark.parametrize("d_in,d_out,block", [(64, 32, 32),
                                               (256, 128, 128)])
def test_ldlq_quantize_matches_reference(d_in, d_out, block):
    ws, hs = _stack(1, d_in, d_out, d_in + d_out)
    ref = ref_ldlq_quantize(jnp.asarray(ws[0]), jnp.asarray(hs[0]),
                            block=block)
    out = ldlq_quantize(torch.from_numpy(ws[0]), torch.from_numpy(hs[0]),
                        block=block)
    assert out["scales"].shape == (d_in, 1)
    assert _ulps(out["scales"].numpy(), ref["scales"]) <= 2
    same = (_points(out["w_deq"], ref["scales"])
            == _points(ref["w_deq"], ref["scales"])).all(-1)
    assert same.mean() >= 0.99, same.mean()
    err_r, err_p = float(ref["err"]), float(out["err"])
    assert abs(err_p - err_r) <= 1e-4 * err_r, (err_p, err_r)


@pytest.mark.parametrize("d_in,d_out", [(64, 32), (256, 128), (128, 48),
                                         (256, 8), (64, 1024), (32, 4096)])
def test_row_scales_no_further_from_the_reference_than_fp32(d_in, d_out):
    """The port's scales (the mean and the root in fp64, rounded once)
    against the reference's fp32 ones: within 2 ulps, and no further than
    the same formula in fp32 (the port's own summation order) lands."""
    w = np.random.default_rng(d_in + d_out).standard_normal(
        (d_in, d_out)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda w: jnp.maximum(jnp.sqrt(jnp.mean(
        w * w, axis=1, keepdims=True)) * 0.5, 1e-8))(jnp.asarray(w)))
    wt = torch.from_numpy(w)
    fp32 = torch.clamp_min(torch.sqrt(torch.mean(
        wt * wt, dim=-1, keepdim=True)) * 0.5, 1e-8).numpy()
    port = row_scales(wt).numpy()
    exact = np.sqrt(np.mean(w.astype(np.float64) ** 2, axis=1,
                            keepdims=True)) * 0.5
    assert np.array_equal(port, exact.astype(np.float32))
    assert _ulps(port, ref) <= min(_ulps(fp32, ref), 2)


def test_batched_matches_reference_and_is_each_solve_bitwise():
    """A stack of 3 against the reference's vmapped solve, and each of its
    matrices bitwise its own ``ldlq_quantize``."""
    ws, hs = _stack(3, 128, 48, 9)
    ref = ref_batched(jnp.asarray(ws), jnp.asarray(hs), block=64)
    bat = ldlq_quantize_batched(torch.from_numpy(ws), torch.from_numpy(hs),
                                block=64)
    for i in range(3):
        same = (_points(bat["w_deq"][i], ref["scales"][i])
                == _points(ref["w_deq"][i], ref["scales"][i])).all(-1)
        assert same.mean() >= 0.99, (i, same.mean())
        assert abs(float(bat["err"][i]) - float(ref["err"][i])) <= \
            1e-4 * float(ref["err"][i])
        one = ldlq_quantize(torch.from_numpy(ws[i]), torch.from_numpy(hs[i]),
                            block=64)
        for key in ("w_deq", "err", "scales"):
            assert torch.equal(bat[key][i], one[key]), (i, key)


@pytest.mark.parametrize("d_in,d_out", [(96, 64), (128, 256)])
def test_plain_row_loop_matches_reference_row_loop(d_in, d_out):
    """One block: the reference's whole solve (its row loop on its own U
    and scales) against the port's plain loop on that U and those scales:
    the same compensated rows and rounder, bit for bit."""
    ws, hs = _stack(1, d_in, d_out, 4)
    ref = ref_ldlq_quantize(jnp.asarray(ws[0]), jnp.asarray(hs[0]),
                            block=d_in)
    u = np.array(ref_hinv_cholesky(ref_prepare_hessian(
        jnp.asarray(hs[0]), 0.01)))
    deq, err = ldlq_block_ref(torch.from_numpy(ws), torch.from_numpy(u)[None],
                              torch.from_numpy(np.array(ref["scales"]))
                              .reshape(1, d_in))
    assert np.array_equal(deq[0].numpy(), np.asarray(ref["w_deq"]))
    loss = float((err * err).sum())
    assert abs(loss - float(ref["err"])) <= 1e-4 * float(ref["err"])


def test_ldlq_block_refuses_bad_inputs():
    wb, ub, s = torch.zeros((1, 4, 12)), torch.eye(4)[None], torch.ones(1, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        ldlq_block(wb, ub, s)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ldlq_block(torch.empty((1, 4, 8), device="meta"),
                   torch.empty((1, 4, 4), device="meta"),
                   torch.empty((1, 4), device="meta"))
    with pytest.raises(TypeError, match="fp32"):
        ldlq_block(wb[..., :8].double(), ub, s)


def test_grouped_layer_solve_is_one_at_a_time_bitwise():
    """Shape groups (a stack of 3 experts and a 2-D weight of the same
    shape in one call, another shape alone): each weight bitwise its own
    solve, a stack reporting the mean of its losses; nothing collected."""
    ws, hs = _stack(5, 128, 32, 3)
    blk = {"ffn": {"experts": torch.from_numpy(ws[:3]),
                   "shared": torch.from_numpy(ws[3])},
           "mixer": {"wq": torch.from_numpy(ws[4][:, :24])}}
    hess = {"ffn/experts": torch.from_numpy(hs[:3]),
            "ffn/shared": torch.from_numpy(hs[3]),
            "mixer/wq": torch.from_numpy(hs[4])}
    collect = {}
    rsq = RSQConfig(method="ldlq", gptq_block=64)
    new_p, report = quantize_layer_weights(blk, hess, rsq, collect=collect)
    assert collect == {}
    one = [ldlq_quantize(torch.from_numpy(ws[i]), torch.from_numpy(hs[i]),
                         block=64) for i in range(4)]
    wq = ldlq_quantize(blk["mixer"]["wq"], hess["mixer/wq"], block=64)
    assert torch.equal(new_p["ffn"]["experts"],
                       torch.stack([o["w_deq"] for o in one[:3]]))
    assert torch.equal(new_p["ffn"]["shared"], one[3]["w_deq"])
    assert torch.equal(new_p["mixer"]["wq"], wq["w_deq"])
    assert report["ffn/experts"] == float(
        torch.stack([o["err"] for o in one[:3]]).mean())
    assert report["ffn/shared"] == float(one[3]["err"])


@pytest.fixture(scope="module", params=["llama3-8b", "deepseek-v2-236b"])
def pipelines(request):
    """Both pipelines with ``method="ldlq"`` on the same smoke params and
    8 x 32 calibration tokens (no rotation, AttnCon): the reference's
    quantized params in the port's layout, the port's, and both
    reports."""
    cfg = dataclasses.replace(ref_get_config(request.param).reduced(),
                              dtype="float32")
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    calib = np.random.default_rng(2).integers(2, cfg.vocab_size, (8, 32))
    ref_q, ref_rep = RefPipeline(model, RefRSQConfig(
        method="ldlq", rotate=False, scheduler="sequential")).run(
        params, jnp.asarray(calib, jnp.int32), batch_size=4)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    port_q, rep = RSQPipeline(Model(pcfg, "cpu"), RSQConfig(
        method="ldlq", rotate=False)).run(pparams, torch.from_numpy(calib),
                                          batch_size=4)
    ref_port = params_from_jax(jax.tree.map(np.asarray, ref_q), pcfg,
                               device="cpu")
    return ref_port, port_q, ref_rep, rep


def test_pipeline_ldlq_matches_reference(pipelines):
    ref_q, port_q, ref_rep, rep = pipelines
    assert rep["rsq"]["method"] == "ldlq" and rep["scheduler"] == "sequential"
    assert set(rep["layers"]) == set(ref_rep["layers"])
    for li, (a, b) in enumerate(zip(port_q["layers"], ref_q["layers"])):
        weights = ref_rep["layers"][f"layer{li}"]["weights"]
        assert set(rep["layers"][f"layer{li}"]["weights"]) == set(weights)
        for path, loss in weights.items():
            node_a, node_b = a, b
            for key in path.split("/"):
                node_a, node_b = node_a[key], node_b[key]
            wa, wb = node_a.numpy(), node_b.numpy()
            close = np.isclose(wa, wb, rtol=1e-5, atol=1e-7)
            octets = close.reshape(close.shape[:-1] + (-1, 8)).all(-1)
            assert octets.mean() >= 0.99, (li, path, octets.mean())
            got = rep["layers"][f"layer{li}"]["weights"][path]
            assert abs(got - loss) <= 0.01 * loss, (li, path, got, loss)


def test_pipeline_ldlq_quantizes_expert_stacks(pipelines):
    """The MoE smoke model's expert stacks are solved (E matrices each)."""
    ref_q, port_q, ref_rep, rep = pipelines
    stacks = [p for layer in rep["layers"].values() for p in layer["weights"]
              if "experts" in p]
    is_moe = any("experts" in p for layer in ref_rep["layers"].values()
                 for p in layer["weights"])
    assert bool(stacks) == is_moe


def test_pack_output_refused_for_ldlq(tmp_path):
    """``pack_output`` needs integer codes: the pipeline refuses LDLQ, as
    the reference's does, and the CLI's ``--pack-out`` with it fails
    without falling back to GPTQ or writing an artifact."""
    cfg = ref_get_config("llama3-8b").reduced()
    with pytest.raises(ValueError, match="integer codes"):
        RefPipeline(build_model(cfg), RefRSQConfig(method="ldlq",
                                                   pack_output=True))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match="integer codes"):
        RSQPipeline(Model(pcfg, "cpu"), RSQConfig(method="ldlq",
                                                  pack_output=True))
    out = tmp_path / "art"
    with pytest.raises(ValueError, match="integer codes"):
        quantize_main(["--device", "cpu", "--arch", "llama3-8b-smoke",
                       "--n-calib", "4", "--calib-seq", "16", "--batch", "4",
                       "--method", "ldlq", "--pack-out", str(out)])
    assert not out.exists()
    with pytest.raises(ValueError, match="unknown method"):
        RSQPipeline(Model(pcfg, "cpu"), RSQConfig(method="e8p"))


@pytest.mark.parametrize("block,d_out", [(128, 96), (7, 8), (33, 1000),
                                         (1, 8), (127, 24)])
def test_subnormal_tie_inputs_land_halfway_between_subnormals(block, d_out):
    """Both divisions of every row of ``subnormal_tie_inputs``, x / s_i and
    the plain loop's err = (x - deq) / U_ii, are exact odd multiples of
    2^-150: IEEE division rounds each to its even neighbour (a subnormal),
    the product of x with the divisor's fp64 reciprocal rounds each the
    other way, and deq is 0."""
    wb, ub, scales = subnormal_tie_inputs(block, d_out, seed=block)
    deq, err = ldlq_block_ref(wb, ub, scales)
    assert torch.equal(deq.abs(), torch.zeros_like(deq))
    x = wb[0].double()
    for v, q in ((scales[0, :, None], wb[0] / scales[0, :, None]),
                 (torch.diagonal(ub[0])[:, None], err[0])):
        exact = x / v.double() * 2.0 ** 150  # exact in fp64
        assert bool((exact.abs().remainder(2.0) == 1.0).all())
        got = q.double() * 2.0 ** 150
        assert bool(((got - exact).abs() == 1.0).all())
        assert bool((got.remainder(2.0) == 0.0).all())  # to even
        assert bool((q.abs() < torch.finfo(torch.float32).tiny).all())
        recip = (x * (1.0 / v.double())).float()
        assert bool((recip != q).all())

