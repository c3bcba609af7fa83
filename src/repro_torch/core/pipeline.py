"""RSQ layer-wise quantization pipeline (Rotate -> Scale -> Quantize).

  0. expand the calibration set with circular shifts (paper Sec. 4.4);
  1. fuse norms + rotate the model (skippable -> GPTQ baseline);
  2. layer by layer: capture every weight's input with the block's AttnCon
     column sums and output, turn them into token importances R (any of
     the paper's eight strategies, optionally restricted to a chunk of
     positions), accumulate H_w = 2 X R² Xᵀ per weight (``gram`` kernel),
     run GPTQ, write the dequantized weights back and propagate the
     *quantized* block's outputs to the next layer (the standard GPTQ
     error-feedback scheme).  An encoder-decoder's encoder blocks go
     first (tags ``enc{i}``, artifact locations ``["enc", i]``, the last
     one propagated too): their outputs, through the encoder's final norm,
     are the decoder's media.  Media rows (a vision model's, or the
     encoder's output) calibrate the cross-attention K/V projections
     unweighted: they are no tokens of the stream and have no importance.

Baselines are config points: GPTQ = no rotation + uniform; QuaRot =
rotation + uniform; RSQ = rotation + a token-importance strategy.  This is
the reference's sequential schedule.  The solves of a layer are grouped by
shape, as the reference's: weights sharing (d_in, d_out), every matrix of
an expert stack among them, stack into ``gptq_quantize_batched`` calls
(one ``solve_block`` launch a block for all of a call's matrices; a group
whose solve workspace exceeds ``SOLVE_CHUNK_BYTES`` is solved a chunk at a
time), and the proxy losses stay on the device until the layer's one
read-back (``finalize_layer_report``).  A routed-expert layer's stacks
take (E, d_in, d_in) Hessians from their capacity buffers, with each
slot's token importance.  With ``pack_output`` every
solve's (q, scale, zero) is also packed into the serving artifact
(``RSQPipeline.artifact``, saved by
``checkpoint.packed.save_packed_artifact``).

Memory: the pipeline holds one layer's rotated block at a time (each is
rotated when the loop reaches it) and the quantized blocks it has built.
A caller that keeps its own params (a list of layers) keeps the original
model beside them; one that hands the layers over as an iterator
(:func:`handover`) lets each original block go once it is rotated, so a
run holds about one copy of the weights plus one layer's Hessians and
solves (jamba's 8-layer group: 26.5 GB of bf16 weights, not three
copies).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.core import hessian as hess
from repro_torch.core.expansion import expand_dataset
from repro_torch.core.gptq import gptq_quantize_batched
from repro_torch.core.importance import ImportanceInputs, get_strategy
from repro_torch.core.quantizer import QuantSpec, pack_codes
from repro_torch.core.rotation import (rotate_ends, rotate_layer,
                                       rotation_matrix)
from repro_torch.device import generator
from repro_torch.models.layers import rms_norm
from repro_torch.models.lm import (DECODER, ENCODER, Model, apply_block,
                                   capture_block, layer_loc)


@dataclasses.dataclass(frozen=True)
class RSQConfig:
    bits: int = 3
    group_size: int = 128
    sym: bool = True
    rotate: bool = True
    importance: str = "attn_con"  # see core.importance.STRATEGIES
    r_min: float = 0.01
    r_max: float = 1.0
    first_n: int = 1024  # for the First-N / First&Last-N heuristics
    expansion: int = 1  # dataset expansion factor M (paper: 8)
    damp: float = 0.01
    gptq_block: int = 128
    seed: int = 0  # draws the rotation when none is given
    # restrict the loss to a token chunk (Tab. 1 reproduction)
    chunk_lo: float = 0.0
    chunk_hi: float = 1.0
    # collect every solve's packed codes into ``RSQPipeline.artifact``
    pack_output: bool = False

    def spec(self) -> QuantSpec:
        return QuantSpec(bits=self.bits, group_size=self.group_size,
                         sym=self.sym)


def _strategy_kwargs(rsq: RSQConfig) -> dict:
    if rsq.importance in ("first_n", "first_last_n"):
        return {"n": rsq.first_n}
    if rsq.importance == "uniform":
        return {}
    return {"r_min": rsq.r_min, "r_max": rsq.r_max}


def _chunk_mask(r: torch.Tensor, rsq: RSQConfig) -> torch.Tensor:
    """Tab.-1 style chunk restriction on top of any strategy: positions
    outside [chunk_lo·T, chunk_hi·T) weigh 0."""
    if rsq.chunk_lo <= 0.0 and rsq.chunk_hi >= 1.0:
        return r
    t = r.shape[-1]
    idx = torch.arange(t, device=r.device)
    mask = (idx >= int(rsq.chunk_lo * t)) & (idx < int(rsq.chunk_hi * t))
    return r * mask.to(r.dtype)


# a shape group's matrices are solved a chunk at a time, each chunk's
# solve workspace (``_solve_bytes``) at most this many bytes: deepseek-v2's
# wi + wu stack (320 matrices of 5120 x 1536, 33.6 GB of Hessians) in
# chunks of 10, its wd stack (160 of 1536 x 5120) in chunks of 20, and
# deepseek-v3's dense wi and wu (7168 x 18432, 3.6 GB each) one at a time.
# The solves are independent, so the chunks give the bits of one call
SOLVE_CHUNK_BYTES = 4 << 30


def _solve_bytes(d_in: int, d_out: int) -> int:
    """fp32 bytes ``gptq_quantize_batched`` holds for one matrix: its
    Hessian and U factor (d_in²) and about six (d_in, d_out) arrays (the
    weight's working copy, the codes and dequantized rows of each block,
    their concatenations, the result)."""
    return 4 * d_in * (2 * d_in + 6 * d_out)


def _is_quantizable(w: torch.Tensor) -> bool:
    return w.ndim >= 2 and min(w.shape[-2:]) >= 16


def _copy_dicts(tree):
    """The param tree with every dict copied (leaves shared)."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _leaf(tree: dict, path: str) -> tuple[dict, str]:
    """(parent dict, key) of a weight path such as "ffn/experts/wi"."""
    parts = path.split("/")
    for key in parts[:-1]:
        tree = tree[key]
    return tree, parts[-1]


def _pack_stack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """``pack_codes`` eight matrices of a stack at a time (its int64
    intermediates of a whole expert stack would be several times the
    codes): the same words."""
    flat = q.reshape((-1,) + tuple(q.shape[-2:]))
    words = torch.cat([pack_codes(c, bits) for c in flat.split(8)])
    return words.reshape(tuple(q.shape[:-2]) + tuple(words.shape[-2:]))


def _solve_spec(rsq: RSQConfig, d_in: int) -> tuple[QuantSpec, int]:
    """Per-d_in GPTQ block size and group-size fallback (as the reference:
    a group that cannot tile the block becomes one per-tensor group)."""
    block = min(rsq.gptq_block, d_in)
    spec = rsq.spec()
    gs = spec.group_size
    if gs != -1 and (gs > block or block % gs or d_in % gs):
        spec = dataclasses.replace(spec, group_size=-1)
    return spec, block


def finalize_layer_report(report: dict) -> dict:
    """A layer's deferred solve report ({path: 0-d tensor}) as floats, with
    one read-back from the device for the whole layer."""
    if not report:
        return {}
    vals = torch.stack([v.float() for v in report.values()]).tolist()
    return dict(zip(report, vals))


def quantize_layer_weights(p_block: dict, hessians: dict[str, torch.Tensor],
                           rsq: RSQConfig, *,
                           collect: Optional[dict] = None) -> tuple[dict, dict]:
    """GPTQ-solve every captured weight of one block, grouped by shape.

    Weights sharing (d_in, d_out) (q/o, k/v, gate/up, every matrix of a
    stacked (E, d_in, d_out) expert tensor with its (E, d_in, d_in)
    Hessians) are solved together by ``gptq_quantize_batched``, a chunk of
    at most ``SOLVE_CHUNK_BYTES`` of solve workspace a call; a lone 2-D
    weight is its one-matrix case, which is ``gptq_quantize``.  Weight
    paths name nested dicts ("mixer/wq", "ffn/experts/wi").  Returns (new
    block params with dequantized weights, {path: proxy loss}): a stacked
    weight reports the mean of its matrices' losses, and the losses stay
    on the device until one read-back for the layer
    (:func:`finalize_layer_report`).
    ``collect`` receives {path: {"q", "scale", "zero", "dtype"}}, a stack's
    with its leading (E,) axis; the codes ``q`` as uint8 (an expert stack's
    int32 codes would be 5 GB at deepseek-v2's widths)."""
    new_p = _copy_dicts(p_block)
    groups: dict[tuple, list] = {}
    for path, h in hessians.items():
        node, name = _leaf(new_p, path)
        w = node[name]
        if _is_quantizable(w):
            groups.setdefault(tuple(w.shape[-2:]), []).append(
                (path, node, name, w, h))
    report = {}
    for (d_in, d_out), items in groups.items():
        spec, block = _solve_spec(rsq, d_in)
        # every matrix of the group: (item, its index in a stack or None)
        mats = [(it, i) for it in items
                for i in (range(it[3].shape[0]) if it[3].ndim == 3
                          else (None,))]
        per = max(1, SOLVE_CHUNK_BYTES // _solve_bytes(d_in, d_out))
        sols: dict[str, dict] = {}
        for c0 in range(0, len(mats), per):
            chunk = mats[c0:c0 + per]
            ws = torch.stack([it[3] if i is None else it[3][i]
                              for it, i in chunk])
            hs = torch.stack([it[4] if i is None else it[4][i]
                              for it, i in chunk])
            out = gptq_quantize_batched(ws, hs, spec, damp=rsq.damp,
                                        block=block)
            del ws, hs
            out["q"] = out["q"].to(torch.uint8)  # bits <= 8
            for j, ((path, _, _, w, _), i) in enumerate(chunk):
                if i is None:
                    sols[path] = {key: v[j] for key, v in out.items()}
                    continue
                if path not in sols:  # the stack's outputs, filled in turn
                    # (its dequantized weights in the stack's own dtype:
                    # the cast they get below anyway, without a transient
                    # fp32 stack of 3.8 GB at jamba's widths)
                    sols[path] = {key: v.new_empty(
                        (w.shape[0],) + tuple(v.shape[1:]),
                        dtype=w.dtype if key == "w_deq" else v.dtype)
                        for key, v in out.items()}
                for key, v in out.items():
                    sols[path][key][i] = v[j]
            del out
        for path, node, name, w, _ in items:
            sol = sols.pop(path)
            node[name] = sol["w_deq"].to(w.dtype)
            report[path] = sol["err"].mean()
            if collect is not None:
                collect[path] = {"q": sol["q"], "scale": sol["scale"],
                                 "zero": sol["zero"],
                                 "dtype": str(w.dtype).removeprefix("torch.")}
    return new_p, finalize_layer_report(report)


def _accumulate(hessians: dict, caps: dict, dom: dict,
                r: torch.Tensor) -> None:
    """Add one calibration batch to every weight's Hessian (in place).

    Token-aligned inputs ("stream", "hidden") flatten to (B·T, d_in) and
    take r (B·T,); media rows ("media", (B, Tm, d_in)) flatten likewise
    and take no importance (uniform); an expert stack's (E, C, d_in)
    buffers take r scattered into their slots through
    ``ffn/__moe_slot_token`` (0 on an empty slot)
    and accumulate (E, d_in, d_in) Hessians.  Expert weights that read one
    buffer (wi and wu) share one accumulator: their Hessians are equal bit
    for bit (deepseek-v2: 16.8 GB once instead of twice)."""
    slot_token = caps.get("ffn/__moe_slot_token")
    by_buffer: dict[int, str] = {}
    for path, x_c in caps.items():
        if path.endswith("__moe_slot_token"):
            continue
        if dom[path] == "expert":
            first = by_buffer.setdefault(id(x_c), path)
            if first != path:
                hessians[path] = hessians[first]
                continue
            r_rows = torch.cat([r, r.new_zeros((1,))])[slot_token]
            r_rows = r_rows.reshape(x_c.shape[:2])
        else:
            x_c = x_c.reshape(-1, x_c.shape[-1])
            r_rows = None if dom[path] == "media" else r
        hessians[path] = hess.accumulate(hessians.get(path), x_c, r_rows)


def handover(layers: list):
    """The blocks of ``layers``, which it empties as it yields them: as
    ``params["layers"]`` of :meth:`RSQPipeline.run`, the caller holds no
    block the pipeline has taken, and each is freed once replaced."""
    while layers:
        yield layers.pop(0)


class RSQPipeline:
    def __init__(self, model: Model, rsq: RSQConfig):
        self.model = model
        self.cfg = model.cfg
        self.rsq = rsq
        self.strategy = get_strategy(rsq.importance)
        self.skw = _strategy_kwargs(rsq)
        self.artifact: Optional[dict] = None

    def _importance(self, z_in, z_out, tokens, colsum, counts
                    ) -> torch.Tensor:
        inp = ImportanceInputs(z_in=z_in, z_out=z_out, tokens=tokens,
                               attn_colsum=colsum, token_counts=counts)
        return _chunk_mask(self.strategy(inp, **self.skw), self.rsq)

    def run(self, params: dict, calib_tokens: torch.Tensor, *,
            batch_size: int = 8, media: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            rotation: Optional[torch.Tensor] = None,
            rotation_enc: Optional[torch.Tensor] = None,
            verbose: bool = False) -> tuple[dict, dict]:
        """Quantize ``params``. calib_tokens: (N, T) integer tokens, before
        expansion (``rsq.expansion`` M makes N·M samples of them).
        ``media`` (N, Tm, D), a vision model's, and ``frames`` (N, Tf, D),
        an encoder-decoder's (Tf may differ from T), are cut into batches
        as the tokens are.

        ``rotation``: the (d_model, d_model) Q to rotate with, and an
        encoder-decoder's ``rotation_enc`` Q_enc; each drawn from
        ``torch.Generator(rsq.seed)`` when None (Q first).
        ``params["layers"]`` is a list, which stays as it is, or an
        iterator of the blocks (:func:`handover`), read one block a layer;
        an encoder's ``params["encoder"]["layers"]`` likewise.  The result
        is ``rotate_model``'s rotation, block by block, then the same
        solves.  Returns (new_params, report)."""
        model, cfg, rsq = self.model, self.cfg, self.rsq
        report: dict[str, Any] = {"layers": {}, "rsq": dataclasses.asdict(rsq)}
        layers = params["layers"]
        n_layers = (len(layers) if isinstance(layers, (list, tuple))
                    else cfg.n_layers)
        encoder = params.get("encoder")
        if model.encdec and frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder calibrates on "
                             f"frames=(N, Tf, d_model)")
        q = q_enc = None
        if rsq.rotate:
            gen = generator(rsq.seed, model.device)  # draws where Q is None
            q = rotation_matrix(params, cfg, rotation, gen)
            if encoder is not None:
                q_enc = rotation_matrix(params, cfg, rotation_enc, gen)
            params = rotate_ends(params, q, q_enc)
            report["rotated"] = True
        new_params = {k: v for k, v in params.items() if k != "layers"}
        new_params["layers"] = []

        calib = expand_dataset(calib_tokens.to(model.device), rsq.expansion)
        counts = torch.bincount(calib.reshape(-1), minlength=cfg.vocab_size
                                )[:cfg.vocab_size].float()
        n = calib.shape[0]

        def batches(a: torch.Tensor) -> list:
            return [a[i:i + batch_size].to(model.device, model.dtype)
                    for i in range(0, n, batch_size)]

        toks = [calib[i:i + batch_size] for i in range(0, n, batch_size)]
        acts = [model.embed(params, tok) for tok in toks]
        media_b = batches(media) if media is not None else None
        ctx = {"rsq": rsq, "toks": toks, "counts": counts, "report": report,
               "entries": {}, "meta": {}, "verbose": verbose}
        if encoder is not None:
            xs = batches(frames)
            if "frame_proj" in params:
                xs = [x @ params["frame_proj"].to(x.dtype) for x in xs]
            enc_layers = []
            for li, p_blk in enumerate(encoder["layers"]):
                if q is not None:
                    p_blk = rotate_layer(p_blk, cfg, q_enc)
                p_new, xs = self._layer(ctx, p_blk, xs, None, f"enc{li}",
                                        ["enc", li], ENCODER, True)
                enc_layers.append(p_new)
            new_params["encoder"] = {"layers": enc_layers,
                                     "final_norm": params["encoder"][
                                         "final_norm"]}
            media_b = [rms_norm(x, params["encoder"]["final_norm"],
                                cfg.norm_eps) for x in xs]
            del xs
        for li, p_blk in enumerate(layers):
            meta = model.metas[li]
            if q is not None:  # rotation is set-up: outside the layer's time
                p_blk = rotate_layer(
                    p_blk, cfg, q, cross=meta.cross, q_media=q_enc,
                    media_norm=None if encoder is None
                    else encoder["final_norm"])
            p_new, acts = self._layer(ctx, p_blk, acts, media_b,
                                      f"layer{li}", layer_loc(cfg, li), meta,
                                      li + 1 < n_layers)
            new_params["layers"].append(p_new)
        if rsq.pack_output:
            self.artifact = {
                "entries": ctx["entries"], "meta": ctx["meta"],
                "spec": {"bits": rsq.bits, "sym": rsq.sym,
                         "group_size": rsq.group_size, "method": "gptq"}}
            report["packed"] = {"entries": len(ctx["entries"])}
        return new_params, report

    def _layer(self, ctx: dict, p_blk: dict, acts: list, media_b,
               tag: str, loc: list, meta=DECODER,
               propagate: bool = True) -> tuple[dict, list]:
        """Calibrate one (rotated) block on ``acts``, its input batches
        (with ``media_b``, the media batches its cross-attention reads):
        capture, importances, Hessians, the grouped solves, the artifact's
        entries under ``tag`` at ``loc``, and with ``propagate`` the
        quantized block's outputs.  Returns (the quantized block, the next
        layer's input batches, or ``acts`` itself when not propagated)."""
        model, cfg, rsq = self.model, self.cfg, ctx["rsq"]

        def clock() -> float:  # wall time after the device has caught up
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            return time.perf_counter()

        medias = media_b if media_b is not None else [None] * len(acts)
        t0 = clock()
        hessians: dict[str, torch.Tensor] = {}
        for x_b, tok, med in zip(acts, ctx["toks"], medias):
            y, caps, dom, colsum = capture_block(p_blk, cfg, x_b, media=med,
                                                 meta=meta)
            r = self._importance(x_b, y, tok, colsum,
                                 ctx["counts"]).reshape(-1)
            _accumulate(hessians, caps, dom, r)
            del caps, y
        t1 = clock()
        collect = {} if rsq.pack_output else None
        p_new, weights = quantize_layer_weights(p_blk, hessians, rsq,
                                                collect=collect)
        del hessians, p_blk
        for path, sol in (collect or {}).items():
            name = f"{tag}/{path}"
            ctx["entries"][name] = {"codes": _pack_stack(sol["q"], rsq.bits),
                                    "scale": sol["scale"],
                                    "zero": sol["zero"]}
            d_in = int(sol["q"].shape[-2])
            ctx["meta"][name] = {
                "path": path, "tag": tag, "d_in": d_in,
                "group_size": d_in // int(sol["scale"].shape[-2]),
                "dtype": sol["dtype"], "loc": loc}
        t2 = clock()
        if propagate:
            acts = [apply_block(p_new, cfg, x_b, media=med, meta=meta)[0]
                    for x_b, med in zip(acts, medias)]
        t3 = clock()
        rep = {"weights": weights, "seconds": round(t3 - t0, 4),
               "capture_s": round(t1 - t0, 4),
               "solve_s": round(t2 - t1, 4),
               "apply_s": round(t3 - t2, 4)}
        ctx["report"]["layers"][tag] = rep
        if ctx["verbose"]:
            print(f"  [{tag}] {len(weights)} weights quantized in "
                  f"{rep['seconds']}s", flush=True)
        return p_new, acts


def quantize_model(model: Model, params: dict, calib_tokens,
                   rsq: RSQConfig, **kw):
    return RSQPipeline(model, rsq).run(params, calib_tokens, **kw)
