"""The port's routed-expert (MoE) slice against the reference, on
``deepseek-v2-236b-smoke`` (layer 0 MLA + dense SwiGLU in the reference's
``prefix``, layer 1 MLA + 4 routed experts, top-2, one shared expert, in
its stacked ``groups``) and ``deepseek-v3-671b-smoke`` (the same shape with
deepseek-v3's settings).  The same weights (``convert.params_from_jax``),
rotation Q and calibration tokens go through both packages, in fp32.

Tolerances, relative to the largest reference magnitude:
  * routing: expert indices, slot tables and capacity buffers equal
    (bitwise).  The routing weights are not: the router product x @ W
    (fp32, E columns) sums in another order in XLA's dot than in torch's
    BLAS, so gates and top-k weights differ in the last bits (held to
    1e-6); ``_expert_buffers`` given the reference's indices and weights
    gives its slot weights bitwise;
  * MoE outputs, captures, rotated weights, prefill logits, fp and kv2
    decode logits: 1e-5 (the dense FFN tests' tolerance) — fp32 products
    summed in another order;
  * kv8 decode logits: 1e-4 — a latent row reaches the int8 codec from two
    fp32 forwards that differ in the last bit, and a code on a rounding
    boundary then flips by one step (as ``tests/test_torch_mla.py``);
  * greedy tokens, quantized codes and packed entries: equal (bitwise).
Within the port the engine is held to its own solo ``generate`` bitwise
(whole-prompt admission), and its graph loop to its Python loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import dequantize_entry as ref_dequantize_entry
from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import load_packed_forward_params as ref_load_fwd
from repro.checkpoint.packed import save_packed_artifact as ref_save_artifact
from repro.configs import get_config as ref_get_config
from repro.core import hessian as ref_hess
from repro.core import rotation as ref_rot
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.kernels.gram.ops import weighted_gram as ref_weighted_gram
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro.models import moe as ref_moe
from repro.serving import PagedPools as RefPagedPools
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           resident_weight_bytes,
                                           save_packed_artifact)
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import hessian
from repro_torch.core import rotation
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.quantizer import words_to_numpy
from repro_torch.kernels.gram.ops import weighted_gram
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch.serve import generate
from repro_torch.models import moe
from repro_torch.models.lm import Model, capture_block
from repro_torch.serving import (Engine, PagedPools, SamplingParams,
                                 ServeRequest)

RTOL = {0: 1e-5, 2: 1e-5, 8: 1e-4}  # by kv_bits, see above
ARCHES = ("deepseek-v2-236b", "deepseek-v3-671b")


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _setup(arch: str, kv_bits: int = 0):
    """Reference params of ``arch``-smoke in fp32 (norm scales drawn away
    from 1 so that every fold is exercised) and the port's copy."""
    cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                              dtype="float32", kv_bits=kv_bits)
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    rng = np.random.default_rng(1)

    def jitter(tree):
        return {k: (jitter(v) if isinstance(v, dict) else
                    (v * jnp.asarray(rng.uniform(0.5, 1.5, v.shape),
                                     v.dtype) if k.endswith("norm") else v))
                for k, v in tree.items()}

    params = dict(params, prefix=[jitter(b) for b in params["prefix"]],
                  groups=jitter(params["groups"]))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    return cfg, params, pcfg, pparams


@pytest.fixture(scope="module", params=ARCHES)
def pair(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def shared():
    return _setup("deepseek-v2-236b")


def _models(cfg, pcfg, kv_bits):
    return (build_model(dataclasses.replace(cfg, kv_bits=kv_bits)),
            Model(dataclasses.replace(pcfg, kv_bits=kv_bits), "cpu"))


def _group_block(params):
    return jax.tree.map(lambda a: a[0], params["groups"]["b0"])


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("t", [64, 300])
def test_route_matches_reference(pair, t):
    """Expert indices bitwise (a tie goes to the lower expert, as
    ``jax.lax.top_k``), gates and weights within 1e-6 (the router product's
    sum order, see the module docstring)."""
    cfg = pair[0]
    router = np.asarray(_group_block(pair[1])["ffn"]["router"])
    x = np.random.default_rng(t).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    ri, rw, rg = ref_moe.route(jnp.asarray(router), jnp.asarray(x),
                               cfg.moe_top_k)
    pi, pw, pg = moe.route(_t(router), _t(x), cfg.moe_top_k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(pw, rw, 1e-6)
    _close(pg, rg, 1e-6)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal gates (a zero router) go to experts 0, 1, ... in order, as
    ``jax.lax.top_k`` gives them."""
    x = np.ones((3, 8), np.float32)
    w = np.zeros((8, 6), np.float32)
    ri, _, _ = ref_moe.route(jnp.asarray(w), jnp.asarray(x), 4)
    pi, pw, _ = moe.route(_t(w), _t(x), 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pi.numpy(), np.tile(np.arange(4), (3, 1)))
    assert torch.equal(pw, torch.full((3, 4), 0.25))


@pytest.mark.parametrize("capacity", [8, 48, 200], ids=lambda c: f"cap{c}")
def test_expert_buffers_bitwise(pair, capacity):
    """Slot tables, slot weights and buffers of the reference's routing,
    bitwise: at capacity 8 and 48 (128 tokens, top-2 of 4 experts: 64 a
    expert on average) slots overflow and drop, at 200 none does."""
    cfg = pair[0]
    router = np.asarray(_group_block(pair[1])["ffn"]["router"])
    x = np.random.default_rng(7).standard_normal(
        (128, cfg.d_model)).astype(np.float32)
    ri, rw, _ = ref_moe.route(jnp.asarray(router), jnp.asarray(x),
                              cfg.moe_top_k)
    e = cfg.n_routed_experts
    buf_r, st_r, sw_r = ref_moe._expert_buffers(jnp.asarray(x), ri, rw, 0, e,
                                                capacity)
    buf_p, st_p, sw_p, dest = moe._expert_buffers(
        _t(x), _t(ri).long(), _t(rw), e, capacity)
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))
    np.testing.assert_array_equal(sw_p.numpy(), np.asarray(sw_r))
    np.testing.assert_array_equal(buf_p.numpy(), np.asarray(buf_r))
    dropped = int((dest == e * capacity).sum())
    kept = int((st_p < 128).sum())
    assert dropped + kept == 128 * cfg.moe_top_k
    assert (dropped > 0) == (capacity < 200)


@pytest.mark.parametrize("n_tokens,want", [(4, 8), (2048, 96), (4096, 192),
                                           (64, 8)])
def test_moe_capacity_at_deepseek_v2_widths(n_tokens, want):
    """Capacity from the static token count, as the reference's: the serve
    batch of 4 (8), a calibration batch of 4 x 512 (96), batch 4 at prompt
    1024 (192), a prefill chunk of 64 (8)."""
    cfg = ref_get_config("deepseek-v2-236b")
    assert moe.moe_capacity(cfg, n_tokens) == want
    assert ref_moe.moe_capacity(cfg, n_tokens) == want


def test_load_balance_loss_matches_reference(pair):
    cfg = pair[0]
    router = np.asarray(_group_block(pair[1])["ffn"]["router"])
    x = np.random.default_rng(3).standard_normal(
        (96, cfg.d_model)).astype(np.float32)
    ri, _, rg = ref_moe.route(jnp.asarray(router), jnp.asarray(x),
                              cfg.moe_top_k)
    got = moe.load_balance_loss(_t(rg), _t(ri).long(), cfg.n_routed_experts)
    want = ref_moe.load_balance_loss(rg, ri, cfg.n_routed_experts)
    _close(got, np.asarray(want))


# ----------------------------------------------------------- the MoE block


def test_apply_and_capture_moe_match_reference(pair):
    """The MoE FFN's output, and its capture: the shared FFN's inputs, the
    experts' (E, C, d) buffers (one tensor for wi and wu), their hidden
    (E, C, f) and the slot table."""
    cfg, params, pcfg, pparams = pair
    ffn_r = _group_block(params)["ffn"]
    ffn_p = pparams["layers"][1]["ffn"]
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    y_r, aux_r = ref_moe.apply_moe(ffn_r, cfg, jnp.asarray(x))
    y_p, aux_p = moe.apply_moe(ffn_p, pcfg, _t(x))
    _close(y_p, y_r)
    _close(aux_p, np.asarray(aux_r))
    yc_r, _, caps_r = ref_moe.capture_moe(ffn_r, cfg, jnp.asarray(x))
    yc_p, _, caps_p = moe.capture_moe(ffn_p, pcfg, _t(x))
    _close(yc_p, yc_r)
    assert set(caps_p) == set(caps_r)
    assert caps_p["experts/wi"] is caps_p["experts/wu"]
    np.testing.assert_array_equal(caps_p["__slot_token"].numpy(),
                                  np.asarray(caps_r["__slot_token"]))
    for name, v in caps_r.items():
        if name != "__slot_token":
            _close(caps_p[name], v)


def test_capture_block_domains_match_reference(shared):
    """``capture_block`` of the MoE layer: the reference's weight paths,
    domains ("expert" for the stacks) and the slot table entry."""
    cfg, params, pcfg, pparams = shared
    from repro.models.lm import capture_block as ref_capture_block

    model = build_model(cfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    y_r, caps_r, dom_r, col_r = ref_capture_block(
        _group_block(params), cfg, model.group_metas[0], jnp.asarray(x))
    y_p, caps_p, dom_p, col_p = capture_block(pparams["layers"][1], pcfg,
                                              _t(x))
    assert dom_p == dom_r
    assert set(caps_p) == set(caps_r)
    assert dom_p["ffn/experts/wd"] == "expert"
    assert dom_p["ffn/shared/wd"] == "hidden"
    _close(y_p, y_r)
    _close(col_p, col_r)
    for path, v in caps_r.items():
        if path.endswith("__moe_slot_token"):
            np.testing.assert_array_equal(caps_p[path].numpy(),
                                          np.asarray(v))
        else:
            _close(caps_p[path], v)


def test_rotated_norm_fused_moe_block_matches_reference(shared):
    """Norms fused into the router, every expert's wi / wu and the shared
    FFN, then the rotation (router Qᵀ W, experts Qᵀ W_e and W_e Q, the
    shared FFN as a dense one), on the dense prefix block and the MoE
    group block."""
    cfg, params, pcfg, pparams = shared
    model = build_model(cfg)
    q = np.array(ref_rot.random_hadamard(jax.random.key(3), cfg.d_model))
    for li, (blk, meta) in enumerate(
            ((params["prefix"][0], model.prefix_metas[0]),
             (_group_block(params), model.group_metas[0]))):
        want = ref_rot.rotate_block(ref_rot.fuse_norms_block(blk, cfg), cfg,
                                    meta, jnp.asarray(q))
        got = rotation.rotate_block(rotation.fuse_norms_block(
            pparams["layers"][li], pcfg), pcfg, torch.from_numpy(q))
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == len(jax.tree.leaves(
            {k: v for k, v in got.items()}))
        for path, w in flat_w:
            node = got
            for key in path:
                node = node[key.key]
            if path[-1].key.endswith("norm"):
                np.testing.assert_array_equal(node.numpy(), np.asarray(w))
            else:
                _close(node, w)
        if li == 1:
            assert got["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_prefill_decode_and_generate_match_reference(shared, kv_bits):
    """Prefill logits of 2 x 70 tokens, 3 teacher-forced decode steps, and
    greedy ``generate`` tokens through the routed experts."""
    cfg, params, pcfg, pparams = shared
    model, pmodel = _models(cfg, pcfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 2, 70, 2)
    forced = _tokens(cfg.vocab_size, 3, 2, 3)
    logits_r, cache_r = model.prefill(params, jnp.asarray(toks),
                                      cache_len=73)
    logits_p, cache_p = pmodel.prefill(pparams,
                                       torch.from_numpy(toks).long(),
                                       cache_len=73)
    _close(logits_p, logits_r)
    for i in range(3):
        tok = forced[i][:, None]
        logits_r, cache_r = model.decode_step(
            params, cache_r, jnp.asarray(tok), jnp.int32(70 + i))
        logits_p = pmodel.decode_step(pparams, cache_p,
                                      torch.from_numpy(tok).long(), 70 + i)
        _close(logits_p, logits_r, RTOL[kv_bits])
    want = ref_generate(model, params, jnp.asarray(toks[:, :40]), 8)
    got = generate(pmodel, pparams, torch.from_numpy(toks[:, :40]).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_steps_match_reference(shared, kv_bits):
    """The engine's model steps: a 100-token prompt ingested in chunks of
    64 through the paged extend, then 2 teacher-forced paged decode steps
    of two slots (the second inactive)."""
    cfg, params, pcfg, pparams = shared
    model, pmodel = _models(cfg, pcfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 1, 100, 4)
    ids, t = [3, 1], 100
    ref_pools, pools = RefPagedPools(model, 4), PagedPools(pmodel, 4)
    for start in range(0, t, 64):
        n = min(64, t - start)
        past = ids[:start // 64]
        logits_r, _, cc_r = model.paged_extend_step(
            params, jnp.asarray(toks[:, start:start + n]), jnp.int32(start),
            None, t_total=t, last=start + n >= t, pools=ref_pools.pools,
            page_tbl=jnp.asarray(past, jnp.int32))
        logits_p, cc_p = pmodel.paged_extend_step(
            pparams, torch.from_numpy(toks[:, start:start + n]).long(),
            start, None, t_total=t, last=start + n >= t, pools=pools.pools,
            page_tbl=torch.tensor(past, dtype=torch.int32))
        page_ids = ids[start // 64:start // 64 + 1]
        ref_pools.write_prefill(cc_r, jnp.asarray(page_ids, jnp.int32))
        pools.write_prefill(cc_p, page_ids)
    _close(logits_p, logits_r, RTOL[kv_bits])
    tbl = np.array([[3, 1, 0], [0, 0, 0]], np.int32)
    pos = np.array([100, 0], np.int32)
    act = np.array([True, False])
    forced = _tokens(cfg.vocab_size, 2, 2, 5)
    pp = ref_pools.pools
    for i in range(2):
        tok = forced[i][:, None]
        logits_r, pp = model.paged_decode_step(
            params, pp, jnp.asarray(tbl), jnp.asarray(tok),
            jnp.asarray(pos + i * act), jnp.asarray(act))
        logits_p = pmodel.paged_decode_step(
            pparams, pools.pools, torch.from_numpy(tbl),
            torch.from_numpy(tok).long(),
            torch.from_numpy(pos + i * act).long(), torch.from_numpy(act))
        _close(logits_p[0], logits_r[0], RTOL[kv_bits])


# ------------------------------------------------------- Hessians and gram


def test_accumulate_expert_stack_matches_reference(shared):
    """Two batches into (E, d, d) expert Hessians: the buffers of a
    capture with r scattered into the slots (0 on an empty slot), as the
    reference's pipeline does, against its ``hessian.accumulate``."""
    cfg, params, pcfg, pparams = shared
    ffn_r = _group_block(params)["ffn"]
    rng = np.random.default_rng(8)
    h_r = h_p = None
    for _ in range(2):
        x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
        r = rng.uniform(0.01, 1.0, (2 * 48,)).astype(np.float32)
        _, _, caps = ref_moe.capture_moe(ffn_r, cfg, jnp.asarray(x))
        st = caps["__slot_token"]
        rf = jnp.concatenate([jnp.asarray(r), jnp.zeros((1,), jnp.float32)])
        buf = caps["experts/wd"]
        r_rows = rf[st].reshape(buf.shape[0], buf.shape[1])
        h_r = ref_hess.accumulate(h_r, buf, r_rows)
        r_p = torch.cat([_t(r), torch.zeros(1)])[_t(st).long()]
        h_p = hessian.accumulate(h_p, _t(buf), r_p.reshape(buf.shape[:2]))
    assert h_p.shape == (cfg.n_routed_experts, cfg.moe_d_ff, cfg.moe_d_ff)
    _close(h_p, h_r)


@pytest.mark.parametrize("with_r", [True, False], ids=["r", "no_r"])
def test_weighted_gram_batched_vs_reference_kernel(with_r):
    """The port's batched gram (x (E, n, d), r (E, n) -> (E, d, d)) against
    the reference's, which vmaps its Pallas kernel (interpret mode) over
    the stack, and each matrix against the port's own 2-D call bitwise."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 64, 128)).astype(np.float32)
    r = rng.uniform(0.0, 1.0, (3, 64)).astype(np.float32) if with_r else None
    want = ref_weighted_gram(jnp.asarray(x),
                             None if r is None else jnp.asarray(r))
    got = weighted_gram(_t(x), None if r is None else _t(r))
    _close(got, want)
    for e in range(3):
        one = weighted_gram(_t(x[e]), None if r is None else _t(r[e]))
        assert torch.equal(got[e], one)


def test_weighted_gram_batched_accumulates_in_place():
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0))
    out = torch.ones(2, 16, 16)
    got = weighted_gram(x, out=out, alpha=2.0)
    assert got is out
    want = 1.0 + 2.0 * torch.bmm(x.transpose(1, 2), x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="out must be"):
        weighted_gram(x, out=torch.zeros(16, 16))
    with pytest.raises(ValueError, match="r must be"):
        weighted_gram(x, torch.ones(5))


def test_chunked_expert_solve_bitwise_one_call(shared, monkeypatch):
    """A shape group solved one matrix a call (``SOLVE_CHUNK_BYTES`` cut to
    nothing) gives the bits, losses and uint8 codes of the whole group in
    one call: the MoE block's expert stacks with wq_a in their group, and
    the shared FFN."""
    from repro_torch.core import pipeline

    cfg, params, pcfg, pparams = shared
    blk = pparams["layers"][1]
    x = np.random.default_rng(10).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    _, caps, dom, _ = capture_block(blk, pcfg, _t(x))
    hessians: dict = {}
    pipeline._accumulate(hessians, caps, dom, torch.rand(64))
    assert hessians["ffn/experts/wu"] is hessians["ffn/experts/wi"]
    rsq = RSQConfig()
    one_c: dict = {}
    p_one, r_one = pipeline.quantize_layer_weights(blk, hessians, rsq,
                                                   collect=one_c)
    monkeypatch.setattr(pipeline, "SOLVE_CHUNK_BYTES", 1)
    chunked_c: dict = {}
    p_ch, r_ch = pipeline.quantize_layer_weights(blk, hessians, rsq,
                                                 collect=chunked_c)
    assert r_ch == r_one and set(r_one) == set(hessians)
    for path in hessians:
        node_a, node_b = p_one, p_ch
        for key in path.split("/"):
            node_a, node_b = node_a[key], node_b[key]
        assert torch.equal(node_a, node_b), path
        for key in ("q", "scale", "zero"):
            assert torch.equal(chunked_c[path][key], one_c[path][key])
        assert one_c[path]["q"].dtype == torch.uint8
    assert one_c["ffn/experts/wd"]["q"].shape == (
        cfg.n_routed_experts, cfg.moe_d_ff, cfg.d_model)


# ----------------------------------------------------- conversion, sharing


def test_params_from_jax_maps_expert_leaves(shared):
    """The prefix block keeps a dense FFN; the stacked group's MoE FFN maps
    to nested ``router``, ``experts/{wi,wu,wd}`` (E, ·, ·) and
    ``shared/{wi,wu,wd}`` leaves, each equal to the reference's."""
    cfg, params, pcfg, pparams = shared
    assert set(pparams["layers"][0]["ffn"]) == {"wi", "wu", "wd"}
    ffn = pparams["layers"][1]["ffn"]
    assert set(ffn) == {"router", "experts", "shared"}
    ref_ffn = _group_block(params)["ffn"]
    for path, w in jax.tree_util.tree_flatten_with_path(ref_ffn)[0]:
        node = ffn
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(w))
    assert ffn["experts"]["wi"].shape == (cfg.n_routed_experts, cfg.d_model,
                                          cfg.moe_d_ff)


# ------------------------------------------- quantize, artifact, keep-packed


@pytest.fixture(scope="module")
def quantized(shared, tmp_path_factory):
    """Both pipelines (3-bit, group 128, rotation, AttnCon) on the same
    params, Q and 8 x 32 calibration tokens, and both artifacts (the
    reference on the model rotated by its compiled ``rotate_model``, with
    its own rotation step off, as ``tests/test_torch_mla.py``)."""
    cfg, params, pcfg, pparams = shared
    model = build_model(cfg)
    calib = _tokens(cfg.vocab_size, 8, 32, 6)
    rotated = jax.jit(lambda p: ref_rot.rotate_model(
        p, cfg, model, jax.random.key(0))[0])(params)
    ref_pipe = RefPipeline(model, RefRSQConfig(pack_output=True, rotate=False,
                                               scheduler="sequential"))
    ref_q, _ = ref_pipe.run(rotated, jnp.asarray(calib), batch_size=4)
    ref_dir = tmp_path_factory.mktemp("ref_moe_artifact")
    ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
    kd, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    rot = np.asarray(ref_rot.random_hadamard(kd, cfg.d_model))
    pmodel = Model(pcfg, "cpu")
    pipe = RSQPipeline(pmodel, RSQConfig(pack_output=True))
    port_q, report = pipe.run(pparams, torch.from_numpy(calib).long(),
                              batch_size=4,
                              rotation=torch.from_numpy(np.array(rot)))
    port_dir = tmp_path_factory.mktemp("port_moe_artifact")
    save_packed_artifact(port_dir, pipe.artifact, params=port_q)
    return {"model": model, "pmodel": pmodel, "ref_dir": ref_dir,
            "port_dir": port_dir, "ref_q": ref_q, "port_q": port_q,
            "report": report}


def test_quantize_pipeline_codes_bitwise(quantized):
    """Every packed entry, the expert stacks' (E, ·, ·) included, bitwise
    the reference's, at the reference's locations."""
    ref_e, ref_meta = ref_load_artifact(quantized["ref_dir"])
    port_e, port_meta = load_packed_artifact(quantized["port_dir"])
    assert set(port_e) == set(ref_e) and len(ref_e) == 19
    for name, em in ref_meta["entries"].items():
        pem = port_meta["entries"][name]
        for key in ("loc", "path", "d_in", "group_size"):
            assert pem[key] == em[key], (name, key)
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(port_e[name][field],
                                          ref_e[name][field])
    wd = ref_meta["entries"]["layer1/ffn/experts/wd"]
    assert wd["loc"] == ["groups", 0, 0]
    assert ref_e["layer1/ffn/experts/wd"]["codes"].shape[0] == 4
    assert "layer1/ffn/router" not in ref_e
    layer1 = quantized["report"]["layers"]["layer1"]["weights"]
    assert {"ffn/experts/wi", "ffn/shared/wd"} <= set(layer1)


def test_reference_artifact_serves_in_the_port(quantized, shared):
    """A reference-written MoE artifact (a dense prefix block and a MoE
    group block, each with its own residual leaves; the fp32 router in
    the residual) loads in the port: expert stacks as (E, ·, ·) packed
    weights bitwise, logits as the reference's quantized model, keep-packed
    greedy tokens as the reference's own keep-packed serve."""
    cfg = shared[0]
    ref_dir, model, pmodel = (quantized[k] for k in ("ref_dir", "model",
                                                     "pmodel"))
    entries_r, meta_r = ref_load_artifact(ref_dir)
    params_p, _ = load_packed_forward_params(ref_dir, device="cpu")
    for name, em in meta_r["entries"].items():
        li = em["loc"][1] if em["loc"][0] == "prefix" else 1 + em["loc"][1]
        pw = params_p["layers"][li]
        for key in em["path"].split("/"):
            pw = pw[key]
        assert isinstance(pw, PackedWeight)
        np.testing.assert_array_equal(words_to_numpy(pw.w_packed),
                                      entries_r[name]["codes"])
    router = params_p["layers"][1]["ffn"]["router"]
    np.testing.assert_array_equal(
        router.numpy(),
        np.asarray(quantized["ref_q"]["groups"]["b0"]["ffn"]["router"][0]))
    assert params_p["layers"][1]["ffn"]["experts"]["wi"].w_packed.ndim == 3
    packed_b, fp_b = resident_weight_bytes(params_p)
    assert packed_b >= sum(
        e[f].nbytes for e in entries_r.values() for f in ("codes", "scale",
                                                            "zero"))
    toks = _tokens(cfg.vocab_size, 2, 24, 7)
    _close(pmodel.logits(params_p, torch.from_numpy(toks).long()),
           model.logits(quantized["ref_q"], jnp.asarray(toks)))
    fwd_r, _ = ref_load_fwd(ref_dir)
    want = ref_generate(model, fwd_r, jnp.asarray(toks[:, :16]), 6)
    got = generate(pmodel, params_p, torch.from_numpy(toks[:, :16]).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_artifact_reads_in_the_reference(quantized, shared):
    """A port-written MoE artifact: the reference's reader takes its
    entries bit for bit, and the reference model with them dequantized
    into its tree gives the port's logits; keep-packed and dequantized
    serving in the port give the same tokens."""
    cfg = shared[0]
    port_dir, model, pmodel = (quantized[k] for k in ("port_dir", "model",
                                                      "pmodel"))
    entries_r, meta_r = ref_load_artifact(port_dir)
    entries_p, meta_p = load_packed_artifact(port_dir)
    assert meta_r["entries"] == meta_p["entries"]
    params = jax.tree.map(lambda a: a, quantized["ref_q"])
    params["prefix"] = [jax.tree.map(lambda a: a, b)
                        for b in params["prefix"]]
    for name, em in meta_r["entries"].items():
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(entries_r[name][field],
                                          entries_p[name][field])
        w = ref_dequantize_entry(entries_r[name], em, meta_r["spec"])
        parts = em["path"].split("/")
        if em["loc"][0] == "prefix":
            node = params["prefix"][em["loc"][1]]
            for key in parts[:-1]:
                node = node[key]
            node[parts[-1]] = w
        else:
            node = params["groups"]["b0"]
            for key in parts[:-1]:
                node = node[key]
            node[parts[-1]] = node[parts[-1]].at[em["loc"][1]].set(w)
    toks = _tokens(cfg.vocab_size, 2, 24, 8)
    packed, _ = load_packed_forward_params(port_dir, device="cpu")
    deq, _ = load_packed_params(port_dir, device="cpu")
    got = pmodel.logits(packed, torch.from_numpy(toks).long())
    _close(got, model.logits(params, jnp.asarray(toks)))
    for kv_bits in (0, 2):
        _, m_p = _models(cfg, ModelConfig(**dataclasses.asdict(cfg)),
                         kv_bits)
        a = generate(m_p, packed, torch.from_numpy(toks[:, :16]).long(), 6)
        b = generate(m_p, deq, torch.from_numpy(toks[:, :16]).long(), 6)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------- the port's engine


@pytest.fixture(scope="module", params=[8, 2], ids=["kv8", "kv2"])
def port(request, shared):
    model = Model(dataclasses.replace(shared[2], kv_bits=request.param),
                  "cpu")
    return model, shared[3]


def _engine(model, params, prompts, budgets, sps, *, chunk, attn, slots,
            loop="graph"):
    engine = Engine(model, params, max_slots=slots, n_pages=16,
                    max_pages_per_request=3, burst_steps=3,
                    prefill_chunk=chunk, prefill_attn=attn, loop=loop)
    rids = [engine.submit(ServeRequest(tokens=p, max_new_tokens=n,
                                       sampling=sp))
            for p, n, sp in zip(prompts, budgets, sps)]
    outs = {o.request_id: o for o in engine.drain()}
    assert engine.pools.free_pages() == 16
    assert all(outs[r].status == "ok" for r in rids)
    return [outs[r].tokens for r in rids]


@pytest.mark.parametrize("mode", ["whole", "chunked-paged"])
def test_engine_graph_loop_bitwise_python_loop(port, mode):
    """Three requests over two slots (the third waits), 130-token prompts,
    one sampled, through the routed experts: the captured burst loop gives
    the Python loop's tokens bit for bit; whole-prompt admission gives each
    request its solo ``generate`` tokens."""
    model, params = port
    prompts = _tokens(model.cfg.vocab_size, 3, 130, 9).tolist()
    sps = [SamplingParams(), SamplingParams(),
           SamplingParams(temperature=1.3, seed=7)]
    budgets = [10, 7, 6]
    chunk, attn = {"whole": (None, "exact"),
                   "chunked-paged": (64, "paged")}[mode]
    got = _engine(model, params, prompts, budgets, sps, chunk=chunk,
                  attn=attn, slots=2)
    py = _engine(model, params, prompts, budgets, sps, chunk=chunk,
                 attn=attn, slots=2, loop="python")
    assert got == py
    if mode == "whole":
        for i in range(3):
            want = generate(model, params, torch.tensor([prompts[i]]),
                            budgets[i], temperature=sps[i].temperature,
                            seed=sps[i].seed)[0].tolist()
            assert got[i] == want, i
