"""The cross-attention slice against the reference: an encoder-decoder
(``whisper-medium-smoke``: 2 non-causal encoder blocks with qkv bias, 2
decoder blocks each with a cross-attention sub-layer on the encoder's
output) and a decoder with cross-attention layers on media rows
(``llama-3.2-vision-11b-smoke``: GQA, cross, GQA, cross; one layer group of
2 blocks, so both g > 0 and o > 0 occur in ``["groups", g, o]``).

The same weights (``convert.params_from_jax``), rotations Q and Q_enc
(the reference's own draws), calibration tokens and frames or media go
through both packages, in fp32.  Norm scales and qkv biases are drawn away
from the reference's constant init, but for the vision model's
cross-attention mixers' ``mixer_norm``: at γ ≠ 1 the reference's rotation
of such a block is not output-preserving (it scales the media-reading
``wk`` / ``wv`` by the stream's γ), so parity is held at γ = 1 and the
port's own rotation is held to its unrotated model at γ ≠ 1.  The frames
are 24 rows against 16 tokens, the media 8 rows.

Tolerances, relative to the largest reference magnitude:
  * logits, loss, prefill and fp-cache decode logits, rotated weights,
    captured inputs, logits of a model served from an artifact: 1e-4 (the
    issue's bound; fp32 products summed in another order);
  * kv8 decode logits: 1e-4 (a K/V row on an int8 rounding boundary may
    flip a code, as in ``tests/test_torch_moe.py``);
  * AttnCon column sums: 1e-5;
  * greedy tokens, quantized codes and packed entries: equal (bitwise),
    but for whisper's pipeline under AttnCon: the encoder's column sums are
    near-uniform (every query sees every frame), so the importance
    normalisation (paper Eq. 4) scales their last-bit differences up and
    H differs by ~1e-6, where 3-bit codes on a rounding boundary flip
    (GPTQ itself is bitwise given one H).  That run is held to the
    reference's names and locations and to ``MIN_ENC0_CODES`` of layer
    ``enc0``'s codes; the bitwise run of the whisper pipeline uses ActNorm.
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
from repro.core import rotation as ref_rot
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro.models import lm as ref_lm
from repro.models.attention import flash_attention as ref_flash
from repro.serving import Engine as RefEngine
from repro_torch.checkpoint import packed
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           save_packed_artifact)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import rotation
from repro_torch.core.pipeline import RSQConfig, RSQPipeline, handover
from repro_torch.core.quantizer import words_to_numpy
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch import quantize, serve
from repro_torch.launch.serve import generate
from repro_torch.models import attention as att
from repro_torch.models import lm
from repro_torch.models.lm import Model
from repro_torch.serving import Engine
from test_torch_dense_variants import _DRAWN, _draw

RTOL = 1e-4
WHISPER, VISION = "whisper-medium", "llama-3.2-vision-11b"
N_FRAMES = 24  # encoder rows a sample, against CALIB_T tokens
CALIB_N, CALIB_T = 8, 16
MIN_ENC0_CODES = 0.99


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def _extra(cfg, n: int, seed: int) -> dict:
    """{"media"} or {"frames"} of ``n`` samples, N(0, 1), as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (n, N_FRAMES, cfg.d_model)).astype(np.float32)}
    return {"media": rng.standard_normal(
        (n, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)}


def _jx(extra: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _pt(extra: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in extra.items()}


def _cfg(arch: str, kv_bits: int = 0):
    return dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32", kv_bits=kv_bits)


def _models(cfg, kv_bits):
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    return build_model(cfg), Model(ModelConfig(**dataclasses.asdict(cfg)),
                                   "cpu")


def _drawn_params(model, cfg, cross_gamma=None):
    """The reference's init with norms (``cross_norm`` too) and biases
    drawn; a vision model's cross mixers' ``mixer_norm`` at 1, or at
    ``cross_gamma`` where given."""
    rng = np.random.default_rng(1)
    params = _draw(jax.jit(model.init)(jax.random.key(0)), rng)
    for o, meta in enumerate(model.group_metas):
        blk = params["groups"][f"b{o}"]
        if "cross_norm" in blk:
            blk["cross_norm"] = jnp.asarray(rng.uniform(
                *_DRAWN["mixer_norm"], blk["cross_norm"].shape), jnp.float32)
        if meta.mixer == "cross":
            blk["mixer_norm"] = jnp.full_like(blk["mixer_norm"],
                                              cross_gamma or 1.0)
    return params


def _port(params, pcfg):
    return params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                           device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread a test worker is faster than
    threads contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipelines(case, importance: str, tmp_path_factory, tag: str) -> dict:
    """Both pipelines (3-bit, group 128) on the case's calibration set:
    the reference on its model rotated by its compiled ``rotate_model``
    (its own rotation step off, as ``tests/test_torch_hybrid.py``), the
    port rotating with the reference's Q and Q_enc; both artifacts."""
    cfg = case["cfg"]
    ref_pipe = RefPipeline(case["model"], RefRSQConfig(
        pack_output=True, rotate=False, scheduler="sequential",
        importance=importance))
    ref_q, _ = ref_pipe.run(case["rotated"], jnp.asarray(case["calib"]),
                            batch_size=4, **_jx(case["calib_extra"]))
    ref_dir = tmp_path_factory.mktemp(f"ref_{tag}")
    ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
    pipe = RSQPipeline(case["pmodel"], RSQConfig(pack_output=True,
                                                 importance=importance))
    rots = {"rotation": torch.from_numpy(case["q"].copy())}
    if cfg.family == "encdec":
        rots["rotation_enc"] = torch.from_numpy(case["q_enc"].copy())
    port_q, report = pipe.run(case["pparams"],
                              torch.from_numpy(case["calib"]).long(),
                              batch_size=4, **_pt(case["calib_extra"]),
                              **rots)
    port_dir = tmp_path_factory.mktemp(f"port_{tag}")
    save_packed_artifact(port_dir, pipe.artifact, params=port_q)
    return {"ref_q": ref_q, "ref_dir": ref_dir, "ref_artifact":
            ref_pipe.artifact, "port_q": port_q, "port_dir": port_dir,
            "report": report, "artifact": pipe.artifact}


@pytest.fixture(scope="module", params=[WHISPER, VISION])
def case(request, tmp_path_factory):
    """Both models on the same params, the reference's rotations, and both
    pipelines' artifacts (AttnCon for the vision model, ActNorm for whisper:
    see the module's note)."""
    cfg = _cfg(request.param)
    model = build_model(cfg)
    params = _drawn_params(model, cfg)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    kd, ke = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    out = {"cfg": cfg, "model": model, "params": params, "pcfg": pcfg,
           "pmodel": Model(pcfg, "cpu"), "pparams": _port(params, pcfg),
           "q": np.asarray(ref_rot.random_hadamard(kd, cfg.d_model)),
           "q_enc": np.asarray(ref_rot.random_hadamard(ke, cfg.d_model)),
           "rotated": jax.jit(lambda p: ref_rot.rotate_model(
               p, cfg, model, jax.random.key(0))[0])(params),
           "calib": _tokens(cfg.vocab_size, CALIB_N, CALIB_T, 6),
           "calib_extra": _extra(cfg, CALIB_N, 5)}
    importance = "act_norm" if cfg.family == "encdec" else "attn_con"
    out.update(_pipelines(out, importance, tmp_path_factory,
                          request.param))
    return out


# ------------------------------------------------------------ config, layout


def test_configs_layer_pattern_and_full_width():
    """The two configs' layer patterns at full width and reduced, and the
    models they build (full-width configs build no weights here)."""
    vision = get_config(VISION)
    assert vision.scan_period == 5
    assert vision.layer_kinds()[:5] == ("attn",) * 3 + ("cross", "attn")
    assert [m.cross for m in Model(vision, "cpu").metas[:5]] == \
        [False, False, False, True, False]
    assert vision.n_params() == ref_get_config(VISION).n_params()
    whisper = get_config(WHISPER)
    assert whisper.n_encoder_layers == 24 and whisper.qkv_bias
    assert set(whisper.layer_kinds()) == {"attn"}
    assert Model(whisper, "cpu").encdec
    assert get_config(VISION + "-smoke").layer_kinds() == \
        ("attn", "cross", "attn", "cross")
    assert get_config(WHISPER + "-smoke").n_encoder_layers == 2


def test_params_from_jax_layout(case):
    """The reference's stacked encoder becomes ``encoder.layers``; decoder
    blocks carry ``cross_norm`` / ``cross`` (enc-dec) or a cross mixer
    without biases (vision); the port's own init draws the same leaves and
    shapes."""
    cfg, params, pparams = case["cfg"], case["params"], case["pparams"]
    shapes = jax.tree.map(lambda a: tuple(a.shape), case["pmodel"].init(
        torch.Generator().manual_seed(0)))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), pparams)
    if cfg.family == "encdec":
        enc = pparams["encoder"]["layers"]
        assert len(enc) == cfg.n_encoder_layers
        for li, blk in enumerate(enc):
            np.testing.assert_array_equal(
                blk["mixer"]["bq"].numpy(), np.asarray(
                    params["encoder"]["groups"]["b0"]["mixer"]["bq"])[li])
        assert all({"cross_norm", "cross"} <= set(b)
                   for b in pparams["layers"])
        assert "frame_proj" not in pparams
    else:
        for blk, kind in zip(pparams["layers"], cfg.layer_kinds()):
            assert "cross" not in blk
            assert ("bq" in blk["mixer"]) == (cfg.qkv_bias
                                              and kind == "attn")


# ------------------------------------------------------------------ forward


def test_logits_and_loss_match_reference(case):
    """Logits and the next-token loss of 2 x 16 tokens with 24 frames or
    8 media rows a sample."""
    cfg = case["cfg"]
    toks = _tokens(cfg.vocab_size, 2, 16, 2)
    extra = _extra(cfg, 2, 3)
    _close(case["pmodel"].logits(case["pparams"],
                                 torch.from_numpy(toks).long(),
                                 **_pt(extra)),
           case["model"].logits(case["params"], jnp.asarray(toks),
                                **_jx(extra)))
    labels = np.roll(toks, -1, axis=1)
    want = case["model"].loss(case["params"], {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        **_jx(extra)})
    got = case["pmodel"].loss(case["pparams"], torch.from_numpy(toks).long(),
                              torch.from_numpy(labels).long(), **_pt(extra))
    _close(got, np.asarray(want))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_prefill_decode_and_generate_match_reference(case, kv_bits):
    """Prefill of 12 tokens, then 4 teacher-forced decode steps: against
    the port's own full forward (fp cache) and the reference's steps; the
    cross layers' entries ``{"xk", "xv"}`` stay fp whatever the codec;
    greedy ``generate`` tokens as the reference's and the graph loop's as
    the Python loop's."""
    cfg, params, pparams = case["cfg"], case["params"], case["pparams"]
    model, pmodel = _models(cfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 2, 16, 2)
    extra = _extra(cfg, 2, 3)
    full = pmodel.logits(pparams, torch.from_numpy(toks).long(),
                         **_pt(extra))
    logits_r, cache_r = model.prefill(params, jnp.asarray(toks[:, :12]),
                                      cache_len=16, **_jx(extra))
    logits_p, cache_p = pmodel.prefill(
        pparams, torch.from_numpy(toks[:, :12]).long(), cache_len=16,
        **_pt(extra))
    _close(logits_p, logits_r)
    _close(logits_p, full[:, 11])
    for kind, entry in zip(cfg.layer_kinds(), cache_p):
        if kind == "cross" or cfg.family == "encdec":
            assert entry["xk"].dtype == torch.float32
            assert entry["xk"].shape[1] == next(iter(extra.values())).shape[1]
        assert ("k" in entry) == (kind == "attn")
    step_r = jax.jit(model.decode_step)
    for i in range(4):
        tok = toks[:, 12 + i:13 + i]
        logits_r, cache_r = step_r(params, cache_r, jnp.asarray(tok),
                                   jnp.int32(12 + i))
        logits_p = pmodel.decode_step(pparams, cache_p,
                                      torch.from_numpy(tok).long(), 12 + i)
        _close(logits_p, logits_r)
        if not kv_bits:
            _close(logits_p, full[:, 12 + i])
    want = ref_generate(model, params, jnp.asarray(toks[:, :8]), 6,
                        **_jx(extra))
    got = generate(pmodel, pparams, torch.from_numpy(toks[:, :8]).long(), 6,
                   **_pt(extra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for temperature in (0.0, 0.9):
        a = generate(pmodel, pparams, torch.from_numpy(toks[:, :8]).long(),
                     6, temperature=temperature, seed=3, **_pt(extra))
        b = generate(pmodel, pparams, torch.from_numpy(toks[:, :8]).long(),
                     6, temperature=temperature, seed=3, loop="python",
                     **_pt(extra))
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_capture_block_matches_reference(case):
    """``capture_block`` of each block kind on the same inputs: the same
    caps and domains (media rows "media"), outputs, and column sums: none
    on a cross mixer, the full map's on an encoder block, the causal map's
    on a decoder block."""
    cfg, model, params, pparams = (case["cfg"], case["model"],
                                   case["params"], case["pparams"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    media = next(iter(_extra(cfg, 2, 5).values()))
    blocks = [(jax.tree.map(lambda a: a[0], params["groups"])[f"b{o}"],
               pparams["layers"][o], m, lm.CROSS if m.mixer == "cross"
               else lm.DECODER, x) for o, m in enumerate(model.group_metas)]
    if cfg.family == "encdec":
        enc = jax.tree.map(lambda a: a[1], params["encoder"]["groups"])
        blocks.append((enc["b0"], pparams["encoder"]["layers"][1],
                       model.enc_metas[0], lm.ENCODER, media))
    kinds = set()
    for blk, pblk, meta, pmeta, inp in blocks:
        y, caps, dom, col = ref_lm.capture_block(
            blk, cfg, meta, jnp.asarray(inp), media=jnp.asarray(media))
        py, pcaps, pdom, pcol = lm.capture_block(
            pblk, case["pcfg"], torch.from_numpy(inp),
            media=torch.from_numpy(media), meta=pmeta)
        assert pdom == dom
        assert set(pcaps) == set(caps)
        for path in caps:
            _close(pcaps[path], caps[path])
        _close(py, y)
        assert (pcol is None) == (col is None)
        if col is not None:
            _close(pcol, col, 1e-5)
        kinds.add((meta.mixer, meta.causal, meta.has_cross))
        if meta.mixer == "cross":
            assert pcol is None and col is None
            assert dom["mixer/wk"] == "media"
        if meta.has_cross:
            assert dom["cross/wv"] == "media" and dom["cross/wq"] == "stream"
    want = ({("attn", True, True), ("attn", False, False)}
            if cfg.family == "encdec" else {("attn", True, False),
                                            ("cross", True, False)})
    assert kinds == want


# ------------------------------------------------------------------ rotation


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_rotate_model_matches_reference(case):
    """Norms fused (``cross_norm`` into ``cross/wq``, the encoder's final
    norm into every ``cross/wk`` / ``cross/wv``), the decoder rotated by
    Q, the encoder by Q_enc with ``frame_proj`` = Q_enc, the cross
    K/V side by Q_encᵀ (enc-dec) or left as it is (vision media)."""
    cfg = case["cfg"]
    rot = {}
    if cfg.family == "encdec":
        rot["q_enc"] = torch.from_numpy(case["q_enc"].copy())
    got, rots = rotation.rotate_model(case["pparams"], case["pcfg"],
                                      torch.from_numpy(case["q"].copy()),
                                      **rot)
    assert (rots["q_enc"] is None) == (cfg.family != "encdec")
    want = case["rotated"]
    period = cfg.scan_period
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [k.key for k in path]
        w = np.asarray(w)
        if keys[0] == "groups":
            o = int(keys[1][1:])
            for g in range(w.shape[0]):
                _close(_leaf(got["layers"][g * period + o], keys[2:]), w[g])
        elif keys[:2] == ["encoder", "groups"]:
            for li in range(w.shape[0]):
                _close(_leaf(got["encoder"]["layers"][li], keys[3:]), w[li])
        else:
            _close(_leaf(got, keys), w)


def test_rotation_preserves_outputs_at_gamma_not_one():
    """Every norm drawn away from 1 (a vision cross mixer's ``mixer_norm``
    at 3): the port's rotated model computes its unrotated model's logits,
    where the reference's rotation of the vision model does not (it scales
    the media-reading wk / wv by the stream's γ; its whisper rotation is
    sound, and held to the port's in ``test_rotate_model_matches_reference``
    with every norm drawn)."""
    for arch in (VISION, WHISPER):
        cfg = _cfg(arch)
        model = build_model(cfg)
        params = _drawn_params(model, cfg, cross_gamma=3.0)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pmodel, pparams = Model(pcfg, "cpu"), _port(params, pcfg)
        toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 16, 2)).long()
        extra = _extra(cfg, 2, 3)
        want = pmodel.logits(pparams, toks, **_pt(extra))
        rotated, _ = rotation.rotate_model(
            pparams, pcfg, gen=torch.Generator().manual_seed(1))
        _close(pmodel.logits(rotated, toks, **_pt(extra)), want)
        if arch == VISION:
            ref_rotated = jax.jit(lambda p: ref_rot.rotate_model(
                p, cfg, model, jax.random.key(0))[0])(params)
            ref_err = np.abs(np.asarray(model.logits(
                ref_rotated, jnp.asarray(toks.numpy()), **_jx(extra)))
                - want.numpy()).max() / np.abs(want.numpy()).max()
            assert ref_err > 1e-2, ref_err


# ------------------------------------------------ quantize and the artifacts


def _entries_equal(ref_art: dict, port_art: dict, names) -> None:
    for name in names:
        for field in ("codes", "scale", "zero"):
            got = port_art["entries"][name][field]
            got = (words_to_numpy(got) if field == "codes"
                   else got.numpy())
            np.testing.assert_array_equal(
                got, np.asarray(ref_art["entries"][name][field]),
                err_msg=f"{name}/{field}")


def test_quantize_pipeline_entries_bitwise(case):
    """Every packed entry bitwise the reference's, with the same names
    (``enc{i}/…`` for encoder blocks), paths, tags and locations
    (``["enc", i]``, ``["groups", g, o]``): the cross mixers' and
    sub-layers' wq / wk / wv / wo, wk and wv from media Hessians."""
    ref_a, port_a = case["ref_artifact"], case["artifact"]
    assert set(port_a["entries"]) == set(ref_a["entries"])
    for name, em in ref_a["meta"].items():
        pem = port_a["meta"][name]
        for key in ("loc", "path", "d_in", "group_size", "tag", "dtype"):
            assert pem[key] == (list(em[key]) if key == "loc" else em[key]), \
                (name, key)
    _entries_equal(ref_a, port_a, ref_a["entries"])
    cfg = case["cfg"]
    locs = {tuple(em["loc"]) for em in ref_a["meta"].values()}
    if cfg.family == "encdec":
        assert len(ref_a["entries"]) == 36
        assert {("enc", 0), ("enc", 1), ("groups", 0, 0),
                ("groups", 1, 0)} == locs
        assert {"enc0/mixer/wq", "layer1/cross/wk", "layer0/cross/wo"} <= \
            set(ref_a["entries"])
    else:
        assert len(ref_a["entries"]) == 28
        assert locs == {("groups", g, o) for g in (0, 1) for o in (0, 1)}
        assert ref_a["meta"]["layer3/mixer/wk"]["loc"] == ["groups", 1, 1]


def test_whisper_attn_con_pipeline(tmp_path_factory):
    """Whisper under AttnCon, whose encoder sums are non-causal: the same
    entry names and locations as the reference's, and layer ``enc0``'s
    codes (Hessians ~1e-6 apart, see the module's note) at least
    MIN_ENC0_CODES equal, entry by entry."""
    cfg = _cfg(WHISPER)
    model = build_model(cfg)
    params = _drawn_params(model, cfg)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    kd, ke = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    case = {"cfg": cfg, "model": model, "pmodel": Model(pcfg, "cpu"),
            "pparams": _port(params, pcfg),
            "q": np.asarray(ref_rot.random_hadamard(kd, cfg.d_model)),
            "q_enc": np.asarray(ref_rot.random_hadamard(ke, cfg.d_model)),
            "rotated": jax.jit(lambda p: ref_rot.rotate_model(
                p, cfg, model, jax.random.key(0))[0])(params),
            "calib": _tokens(cfg.vocab_size, CALIB_N, CALIB_T, 6),
            "calib_extra": _extra(cfg, CALIB_N, 5)}
    run = _pipelines(case, "attn_con", tmp_path_factory, "attn_con")
    ref_a, port_a = run["ref_artifact"], run["artifact"]
    assert set(port_a["entries"]) == set(ref_a["entries"])
    assert {n: em["loc"] for n, em in port_a["meta"].items()} == \
        {n: list(em["loc"]) for n, em in ref_a["meta"].items()}
    for name in ref_a["entries"]:
        if not name.startswith("enc0/"):
            continue
        same = (words_to_numpy(port_a["entries"][name]["codes"])
                == np.asarray(ref_a["entries"][name]["codes"]))
        assert same.mean() >= MIN_ENC0_CODES, (name, same.mean())
    assert all(np.isfinite(v) for rep in run["report"]["layers"].values()
               for v in rep["weights"].values())


def test_pipeline_with_handed_over_layers_is_bitwise(case):
    """Decoder and encoder layers handed over as iterators (``handover``)
    give the same artifact bit for bit as kept lists, and the handed-over
    lists are emptied."""
    cfg = case["cfg"]
    pipe = RSQPipeline(case["pmodel"], RSQConfig(
        pack_output=True,
        importance="act_norm" if cfg.family == "encdec" else "attn_con"))
    layers = list(case["pparams"]["layers"])
    params = dict(case["pparams"], layers=handover(layers))
    rots = {"rotation": torch.from_numpy(case["q"].copy())}
    if cfg.family == "encdec":
        enc = list(case["pparams"]["encoder"]["layers"])
        params["encoder"] = dict(case["pparams"]["encoder"],
                                 layers=handover(enc))
        rots["rotation_enc"] = torch.from_numpy(case["q_enc"].copy())
    got, _ = pipe.run(params, torch.from_numpy(case["calib"]).long(),
                      batch_size=4, **_pt(case["calib_extra"]), **rots)
    assert layers == [] and (cfg.family != "encdec" or enc == [])
    want, flat = packed._flatten(case["port_q"]), packed._flatten(got)
    assert set(flat) == set(want)
    for path, w in want.items():
        assert torch.equal(flat[path], w), path
    for name, entry in case["artifact"]["entries"].items():
        for field, v in entry.items():
            assert torch.equal(pipe.artifact["entries"][name][field], v)


def test_reference_artifact_serves_in_the_port(case):
    """A reference-written artifact (encoder entries at ``["enc", i]``,
    its residual with the encoder's norms and ``frame_proj``) loads in
    the port: packed weights bitwise, the residual's leaves as the
    reference's quantized model's, logits as that model's, and keep-packed
    greedy tokens as the reference's own keep-packed serve."""
    cfg, model, pmodel = case["cfg"], case["model"], case["pmodel"]
    entries_r, meta_r = ref_load_artifact(case["ref_dir"])
    params_p, _ = load_packed_forward_params(case["ref_dir"], device="cpu")
    for name, em in meta_r["entries"].items():
        if em["loc"][0] == "enc":
            pw = params_p["encoder"]["layers"][em["loc"][1]]
        else:
            _, g, o = em["loc"]
            pw = params_p["layers"][g * cfg.scan_period + o]
        pw = _leaf(pw, em["path"].split("/"))
        assert isinstance(pw, PackedWeight)
        np.testing.assert_array_equal(packed.words_to_numpy(pw.w_packed),
                                      entries_r[name]["codes"])
    if cfg.family == "encdec":
        np.testing.assert_array_equal(params_p["frame_proj"].numpy(),
                                      np.asarray(case["ref_q"]["frame_proj"]))
        enc_r = case["ref_q"]["encoder"]["groups"]["b0"]
        for li, blk in enumerate(params_p["encoder"]["layers"]):
            for key in ("mixer_norm", "ffn_norm"):
                np.testing.assert_array_equal(blk[key].numpy(),
                                              np.asarray(enc_r[key])[li])
            np.testing.assert_array_equal(
                blk["mixer"]["bk"].numpy(),
                np.asarray(enc_r["mixer"]["bk"])[li])
        np.testing.assert_array_equal(
            params_p["layers"][1]["cross_norm"].numpy(),
            np.asarray(case["ref_q"]["groups"]["b0"]["cross_norm"])[1])
    toks = _tokens(cfg.vocab_size, 2, 16, 7)
    extra = _extra(cfg, 2, 8)
    _close(pmodel.logits(params_p, torch.from_numpy(toks).long(),
                         **_pt(extra)),
           model.logits(case["ref_q"], jnp.asarray(toks), **_jx(extra)))
    fwd_r, _ = ref_load_fwd(case["ref_dir"])
    want = ref_generate(model, fwd_r, jnp.asarray(toks[:, :8]), 6,
                        **_jx(extra))
    got = generate(pmodel, params_p, torch.from_numpy(toks[:, :8]).long(), 6,
                   **_pt(extra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_artifact_reads_in_the_reference(case):
    """A port-written artifact: the reference's reader takes its entries
    and locations bit for bit, and the reference model with them
    dequantized in place (``encoder.groups.b0[i]`` for ``["enc", i]``)
    gives the port's logits."""
    cfg, model, pmodel = case["cfg"], case["model"], case["pmodel"]
    entries_r, meta_r = ref_load_artifact(case["port_dir"])
    entries_p, meta_p = load_packed_artifact(case["port_dir"])
    assert meta_r["entries"] == meta_p["entries"]
    params = jax.tree.map(lambda a: a, case["ref_q"])
    for name, em in meta_r["entries"].items():
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(entries_r[name][field],
                                          entries_p[name][field])
        w = ref_dequantize_entry(entries_r[name], em, meta_r["spec"])
        if em["loc"][0] == "enc":
            node, g = params["encoder"]["groups"]["b0"], em["loc"][1]
        else:
            node, g = params["groups"][f"b{em['loc'][2]}"], em["loc"][1]
        parts = em["path"].split("/")
        node = _leaf(node, parts[:-1])
        node[parts[-1]] = node[parts[-1]].at[g].set(w)
    toks = _tokens(cfg.vocab_size, 2, 16, 8)
    extra = _extra(cfg, 2, 9)
    got = pmodel.logits(load_packed_forward_params(
        case["port_dir"], device="cpu")[0], torch.from_numpy(toks).long(),
        **_pt(extra))
    _close(got, model.logits(params, jnp.asarray(toks), **_jx(extra)))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_port_artifact_keep_packed_equals_dequantized(case, kv_bits):
    """The port's own artifact: keep-packed and load-time dequantized
    serving give the same greedy tokens, in both loops."""
    _, pmodel = _models(case["cfg"], kv_bits)
    toks = torch.from_numpy(_tokens(case["cfg"].vocab_size, 2, 12, 9)).long()
    extra = _pt(_extra(case["cfg"], 2, 10))
    keep, _ = load_packed_forward_params(case["port_dir"], device="cpu")
    deq, _ = load_packed_params(case["port_dir"], device="cpu")
    a = generate(pmodel, keep, toks, 6, **extra)
    np.testing.assert_array_equal(
        a.numpy(), generate(pmodel, deq, toks, 6, **extra).numpy())
    np.testing.assert_array_equal(
        a.numpy(), generate(pmodel, keep, toks, 6, loop="python",
                            **extra).numpy())


# ------------------------------------------------------------ serving paths


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_engine_and_chunked_prefill_refuse(arch):
    """Media or encoder K/V are per request, not per page: the port's
    engine refuses both models with the reference's reason, and so does
    the chunked prefill."""
    model, pmodel = _models(_cfg(arch), 8)
    reason = ("cross-attention caches" if arch == WHISPER
              else "launch.serve.generate")
    with pytest.raises(ValueError, match=reason):  # both refuse before
        RefEngine(model, None, n_pages=4)  # they read the params
    with pytest.raises(ValueError, match=reason):
        Engine(pmodel, None, n_pages=4)
    with pytest.raises(NotImplementedError, match="got 'cross'"):
        pmodel.init_ingest(64)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_clis_refuse_with_the_library_entry_points(arch):
    """The quantize and serve CLIs draw no frames or media (nor do the
    reference's): both refuse these models and name the entry points."""
    what = "frames=" if arch == WHISPER else "media="
    with pytest.raises(ValueError, match=f"takes {what}.*RSQPipeline"):
        quantize.main(["--device", "cpu", "--arch", arch + "-smoke"])
    with pytest.raises(ValueError, match=f"takes {what}.*launch.serve"):
        serve.main(["--device", "cpu", "--arch", arch + "-smoke"])


def test_kv_cache_bytes_counts_cross_entries():
    """Cross-attention K/V in fp (media rows x KV heads x Dh, K and V)
    beside the self-attention cache: what ``init_cache`` allocates."""
    for arch in (WHISPER, VISION):
        for kv_bits in (0, 8):
            cfg = dataclasses.replace(get_config(arch + "-smoke"),
                                      kv_bits=kv_bits)
            m = Model(cfg, "cpu")
            fp = Model(dataclasses.replace(cfg, kv_bits=0), "cpu")

            def allocated(mm):
                return sum(a.numel() * a.element_size()
                           for c in mm.init_cache(3, 70, 24)
                           for a in c.values())

            assert serve.kv_cache_bytes(m, 3, 70, 24) == (allocated(m),
                                                          allocated(fp))


# ------------------------------------------------------- flash_attention


def _flash_before(q, k, v, *, kv_chunk=512, q_offset=0):
    """``attention.flash_attention`` as it was before it took ``causal``
    (always causal): the causal rows must stay bitwise these."""
    b, tq, h, dh = q.shape
    tk, kv_heads = k.shape[1], k.shape[2]
    n_rep = h // kv_heads
    kv_chunk = min(kv_chunk, tk)
    qf = (q.float() * (dh ** -0.5)).transpose(1, 2)
    q_pos = q_offset + torch.arange(tq)
    m = torch.full((b, h, tq, 1), att.NEG_INF)
    l = torch.zeros((b, h, tq, 1))
    acc = torch.zeros((b, h, tq, v.shape[-1]))
    for off in range(0, tk, kv_chunk):
        k_r = att._repeat_kv(k[:, off:off + kv_chunk], n_rep).float()
        v_r = att._repeat_kv(v[:, off:off + kv_chunk], n_rep).float()
        s = att.matmul(qf, k_r.permute(0, 2, 3, 1))
        kv_pos = off + torch.arange(k_r.shape[1])
        s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, att.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + att.matmul(p, v_r.transpose(1, 2))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("tq,tk,chunk", [(5, 37, 16), (16, 50, 512),
                                         (1, 1500, 512)])
def test_flash_attention_noncausal_ragged_keys(tq, tk, chunk):
    """``causal=False`` on a key length that is no chunk multiple (the
    reference pads and masks, the port ends in a short chunk; Whisper's
    1500 frames against 512-key chunks) against the reference; the causal
    rows bitwise the earlier function's."""
    rng = np.random.default_rng(tk)
    q = rng.standard_normal((2, tq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    got = att.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              kv_chunk=chunk)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, kv_chunk=chunk)
    _close(got, want, 1e-5)
    qs = rng.standard_normal((2, tk, 4, 16)).astype(np.float32)
    args = (torch.from_numpy(qs), torch.from_numpy(k), torch.from_numpy(v))
    for off in (0, tk // 2):
        a = att.flash_attention(*(x[:, off:] if i == 0 else x
                                  for i, x in enumerate(args)),
                                kv_chunk=chunk, q_offset=off)
        b = _flash_before(*(x[:, off:] if i == 0 else x
                            for i, x in enumerate(args)),
                          kv_chunk=chunk, q_offset=off)
        assert torch.equal(a, b)
