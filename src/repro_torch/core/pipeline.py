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
rotation + uniform; RSQ = rotation + a token-importance strategy; the
solver is GPTQ or LDLQ/E8 (``rsq.method``, paper Sec. 5.4).  The layers
are driven by a ``core.scheduler`` schedule through the engine hooks of
``RSQPipeline`` (sequential, or overlapped: the next layer's capture
issued batch by batch with this layer's apply, no host sync until the end
of the stack; the same bits).  The solves of a layer are grouped by
shape, as the reference's: weights sharing (d_in, d_out), every matrix of
an expert stack among them, stack into ``gptq_quantize_batched`` /
``ldlq_quantize_batched`` calls (one ``solve_block`` / ``ldlq_block``
launch a block for all of a call's matrices; a group whose solve
workspace exceeds ``SOLVE_CHUNK_BYTES`` is solved a chunk at a time), and
the proxy losses stay on the device until the layer's one read-back
(``finalize_layer_report``).  A routed-expert layer's stacks
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
import functools
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import hessian as hess
from repro_torch.core.expansion import expand_dataset
from repro_torch.core.gptq import check_factors, gptq_quantize_batched
from repro_torch.core.importance import ImportanceInputs, get_strategy
from repro_torch.core.ldlq import ldlq_quantize_batched
from repro_torch.core.quantizer import QuantSpec, pack_codes
from repro_torch.core.rotation import (rotate_ends, rotate_layer,
                                       rotation_matrix)
from repro_torch.core.scheduler import get_scheduler
from repro_torch.device import generator
from repro_torch.models.layers import rms_norm
from repro_torch.models.lm import (ENCODER, Model, apply_block,
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
    # the solver: "gptq" (integer codes) or "ldlq" (the E8 lattice; no
    # codes, so no packed artifact)
    method: str = "gptq"
    # the layer schedule (core.scheduler): None or "auto" chooses by the
    # model's device (sequential on the CPU, overlapped on CUDA)
    scheduler: Optional[str] = None

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


def finalize_layer_report(report: dict, info=None) -> dict:
    """A layer's deferred solve report ({path: 0-d tensor}) as floats, with
    one read-back from the device for the whole layer; ``info`` (the
    layer's Cholesky infos, deferred by ``check=False``) is read back with
    it, and a failed factorization raises."""
    if not report:
        return {}
    vals = [v.float().reshape(1) for v in report.values()]
    n = len(vals)
    if info is not None:
        vals.append(info.float().reshape(-1))
    back = torch.cat(vals).tolist()
    if info is not None and any(back[n:]):
        check_factors(info)
    return dict(zip(report, back[:n]))


def quantize_layer_weights(p_block: dict, hessians: dict[str, torch.Tensor],
                           rsq: RSQConfig, *, collect: Optional[dict] = None,
                           defer: bool = False) -> tuple[dict, dict]:
    """Solve GPTQ or LDLQ (``rsq.method``) for every captured weight of one
    block, grouped by shape.

    Weights sharing (d_in, d_out) (q/o, k/v, gate/up, every matrix of a
    stacked (E, d_in, d_out) expert tensor with its (E, d_in, d_in)
    Hessians) are solved together by ``gptq_quantize_batched`` /
    ``ldlq_quantize_batched``, a chunk of at most ``SOLVE_CHUNK_BYTES`` of
    solve workspace a call; a lone 2-D weight is its one-matrix case.
    LDLQ's block is ``min(gptq_block, d_in)`` (no group-size fallback: it
    has no groups).  Weight paths name nested dicts ("mixer/wq",
    "ffn/experts/wi").  Returns (new block params with dequantized
    weights, {path: proxy loss}): a stacked weight reports the mean of its
    matrices' losses, and the losses stay on the device until one
    read-back for the layer (:func:`finalize_layer_report`); with
    ``defer`` that read-back is left to the caller, and the report is
    ``{"weights": {path: 0-d tensor}, "info": the Cholesky infos}``.
    ``collect`` (GPTQ only: LDLQ has no integer codes) receives {path:
    {"q", "scale", "zero", "dtype"}}, a stack's with its leading (E,)
    axis; the codes ``q`` as uint8 (an expert stack's int32 codes would be
    5 GB at deepseek-v2's widths)."""
    use_ldlq = rsq.method == "ldlq"
    if use_ldlq:
        collect = None
    new_p = _copy_dicts(p_block)
    groups: dict[tuple, list] = {}
    for path, h in hessians.items():
        node, name = _leaf(new_p, path)
        w = node[name]
        if _is_quantizable(w):
            groups.setdefault(tuple(w.shape[-2:]), []).append(
                (path, node, name, w, h))
    report, infos = {}, []
    for (d_in, d_out), items in groups.items():
        if use_ldlq:
            block = min(rsq.gptq_block, d_in)

            def solve(ws, hs, block=block):
                return ldlq_quantize_batched(ws, hs, damp=rsq.damp,
                                             block=block, check=False)
        else:
            spec, block = _solve_spec(rsq, d_in)

            def solve(ws, hs, spec=spec, block=block):
                return gptq_quantize_batched(ws, hs, spec, damp=rsq.damp,
                                             block=block, check=False)
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
            out = solve(ws, hs)
            del ws, hs
            infos.append(out.pop("info"))
            if "q" in out:
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
    info = torch.cat(infos) if infos else None
    if defer:
        return new_p, {"weights": report, "info": info}
    return new_p, finalize_layer_report(report, info)


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


@dataclasses.dataclass(frozen=True)
class LayerTask:
    """One unit of scheduler work: quantize one block.

    ``index`` is the block's position in the decoder stack, the
    coordinate that fault injection (``stage_point``) and checkpointing
    (``layer_commit``) key on; None (an encoder block) opts the task out
    of both.  ``fetch`` returns the block, rotated, when the schedule
    begins the task (so a run holds one rotated block ahead, not all);
    ``loc`` is its artifact location and ``meta`` its ``BlockMeta``."""
    tag: str
    loc: list
    meta: Any
    fetch: Callable[[], dict]
    index: Optional[int] = None


@dataclasses.dataclass
class _RunCtx:
    """Per-run state shared by the engine hooks of one ``run`` call."""
    toks: list
    counts: torch.Tensor
    medias: Optional[list]
    verbose: bool


class RSQPipeline:
    """The calibration engine: ``run`` builds the layer tasks and a
    ``core.scheduler`` schedule drives the per-layer hooks (``layer_begin``
    / ``layer_capture`` / ``layer_solve`` / ``layer_sync`` /
    ``layer_apply`` / ``layer_finalize``, with ``stage_point`` and
    ``layer_commit`` for fault injection and checkpoints).  The hooks only
    issue device work; the host waits for the device in ``layer_sync``
    (the layer's one read-back) and, under the sequential schedule, at
    each ``clock``."""

    def __init__(self, model: Model, rsq: RSQConfig):
        if rsq.method not in ("gptq", "ldlq"):
            raise ValueError(f"unknown method {rsq.method!r}; gptq or ldlq")
        if rsq.pack_output and rsq.method != "gptq":
            raise ValueError("pack_output needs integer codes; the LDLQ/E8 "
                             "rounder has none (method='gptq')")
        self.model = model
        self.cfg = model.cfg
        self.rsq = rsq
        self.strategy = get_strategy(rsq.importance)
        self.skw = _strategy_kwargs(rsq)
        self.artifact: Optional[dict] = None
        self._entries: dict[str, dict] = {}
        self._meta: dict[str, dict] = {}
        self._rc: Optional[_RunCtx] = None
        # fault tolerance, per run: a FaultPlan checked at every
        # stage_point, a commit callback (core.resume.QuantizeRunner),
        # restored Hessians by layer index and the last decoder index
        self._fault = None
        self._commit_cb: Optional[Callable] = None
        self._resume_hess: dict[int, dict] = {}
        self._last_index: Optional[int] = None

    def _importance(self, z_in, z_out, tokens, colsum, counts
                    ) -> torch.Tensor:
        inp = ImportanceInputs(z_in=z_in, z_out=z_out, tokens=tokens,
                               attn_colsum=colsum, token_counts=counts)
        return _chunk_mask(self.strategy(inp, **self.skw), self.rsq)

    # ----------------------------------------------- scheduler engine hooks
    def prewarm(self, tasks, acts) -> None:
        """Nothing to do: the reference compiles every distinct layer
        program here, ahead of the stack; PyTorch runs eagerly and
        compiles nothing (the kernels are built at their first launch)."""

    def stage_point(self, index: Optional[int], stage: str,
                    batch: Optional[int] = None) -> None:
        """A stage's dispatch boundary: with a ``FaultPlan`` passed to
        ``run``, an armed ``(layer, stage[, batch])`` raises here, before
        the stage's device work."""
        if self._fault is not None and index is not None:
            self._fault.check(index, stage, batch)

    def clock(self, state: dict, mark: str) -> None:
        """Record the wall time of ``mark`` once the device has caught up
        (a host sync; only the sequential schedule calls it)."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        state["marks"][mark] = time.perf_counter()

    def layer_begin(self, task: LayerTask, acts) -> dict:
        """Fetch (and rotate) the task's block; fresh accumulators, or the
        ones a checkpoint restored for it (then its capture is skipped)."""
        st = {"task": task, "p_blk": task.fetch(), "marks": {},
              "t0": time.perf_counter(), "pending": None, "synced": False}
        rh = (self._resume_hess.pop(task.index, None)
              if task.index is not None else None)
        st["hessians"] = {} if rh is None else rh
        st["capture_done"] = rh is not None
        return st

    def layer_capture(self, state: dict, bi: int, x_b) -> None:
        """Capture, importances and Hessian accumulation for one batch."""
        if state["capture_done"]:  # accumulators restored: nothing to add
            return
        rc = self._rc
        med = rc.medias[bi] if rc.medias is not None else None
        y, caps, dom, colsum = capture_block(state["p_blk"], self.cfg, x_b,
                                             media=med,
                                             meta=state["task"].meta)
        r = self._importance(x_b, y, rc.toks[bi], colsum,
                             rc.counts).reshape(-1)
        _accumulate(state["hessians"], caps, dom, r)

    def layer_solve(self, state: dict) -> dict:
        """The layer's grouped solves, issued without a read-back (the
        report stays on the device in ``state``); with ``pack_output`` the
        codes go into the artifact's entries.  Returns the quantized
        block."""
        hessians = state.pop("hessians")
        collect = {} if self.rsq.pack_output else None
        p_new, state["pending"] = quantize_layer_weights(
            state.pop("p_blk"), hessians, self.rsq, collect=collect,
            defer=True)
        del hessians
        if collect is not None:
            self._collect_packed(state["task"], collect)
        return p_new

    def _collect_packed(self, task: LayerTask, collect: dict) -> None:
        """Fold one layer's solve outputs into the serving artifact."""
        self.stage_point(task.index, "pack")
        bits = self.rsq.bits
        for path, sol in collect.items():
            name = f"{task.tag}/{path}"
            self._entries[name] = {"codes": _pack_stack(sol["q"], bits),
                                   "scale": sol["scale"],
                                   "zero": sol["zero"]}
            d_in = int(sol["q"].shape[-2])
            self._meta[name] = {
                "path": path, "tag": task.tag, "d_in": d_in,
                "group_size": d_in // int(sol["scale"].shape[-2]),
                "dtype": sol["dtype"], "loc": list(task.loc)}

    def layer_apply(self, state: dict, p_new: dict, bi: int, x_b):
        """Propagate one batch through the quantized block."""
        rc = self._rc
        med = rc.medias[bi] if rc.medias is not None else None
        return apply_block(p_new, self.cfg, x_b, media=med,
                           meta=state["task"].meta)[0]

    def layer_sync(self, state: dict) -> None:
        """Read the layer's report back (a host sync; once)."""
        if not state["synced"]:
            pend = state["pending"]
            state["pending"] = finalize_layer_report(pend["weights"],
                                                     pend["info"])
            state["synced"] = True

    def layer_finalize(self, state: dict) -> dict:
        """The layer's report: its losses and seconds; under the
        sequential schedule also ``capture_s``, ``solve_s`` and
        ``apply_s`` (device caught up at each).  Under the overlapped one
        ``seconds`` runs from the layer's dispatch to the end of the stack
        and the layers' spans overlap."""
        self.layer_sync(state)
        m = state["marks"]
        if "apply" in m:
            rep = {"weights": state["pending"],
                   "seconds": round(m["apply"] - m["begin"], 4),
                   "capture_s": round(m["capture"] - m["begin"], 4),
                   "solve_s": round(m["solve"] - m["capture"], 4),
                   "apply_s": round(m["apply"] - m["solve"], 4)}
        else:
            rep = {"weights": state["pending"],
                   "seconds": round(time.perf_counter() - state["t0"], 4)}
        if self._rc.verbose:
            print(f"  [{state['task'].tag}] {len(rep['weights'])} weights "
                  f"quantized in {rep['seconds']}s", flush=True)
        return rep

    def layer_commit(self, task: LayerTask, state: dict, p_new: dict, acts,
                     next_state: Optional[dict] = None) -> None:
        """Durable progress, once a layer after its apply sweep is issued:
        hands a checkpointing runner the quantized block, the propagated
        activations (the next layer's inputs), the artifact's entries so
        far and, under the overlapped schedule, the next layer's finished
        Hessians.  Nothing without a runner."""
        if self._commit_cb is None or task.index is None:
            return
        nh = nidx = None
        if next_state is not None and not next_state["capture_done"]:
            nh, nidx = next_state["hessians"], next_state["task"].index
        self._commit_cb(index=task.index, state=state, p_new=p_new,
                        acts=acts, art_entries=self._entries,
                        art_meta=self._meta, next_hessians=nh,
                        next_index=nidx, last=task.index == self._last_index)

    # ----------------------------------------------------------------- main
    def run(self, params: dict, calib_tokens: torch.Tensor, *,
            batch_size: int = 8, media: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            rotation: Optional[torch.Tensor] = None,
            rotation_enc: Optional[torch.Tensor] = None,
            verbose: bool = False, fault=None,
            commit: Optional[Callable] = None,
            resume: Optional[dict] = None) -> tuple[dict, dict]:
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
        solves, in the order ``rsq.scheduler`` issues them.

        Fault tolerance (``core.resume.QuantizeRunner`` drives all three):
        ``fault``, a ``runtime.fault.FaultPlan`` checked at each stage
        point; ``commit``, called once a decoder layer (``layer_commit``);
        ``resume``, progress restored from a checkpoint ({"start",
        "solved", "acts", "art", "art_meta", "hessians", "reports"}):
        layers below ``start`` are taken as solved and the stack goes on
        from the restored activations, bit for bit the run that never
        died.  Returns (new_params, report)."""
        model, cfg, rsq = self.model, self.cfg, self.rsq
        scheduler = get_scheduler(rsq.scheduler, model.device)
        report: dict[str, Any] = {"layers": {}, "rsq": dataclasses.asdict(rsq),
                                  "scheduler": scheduler.name}
        self._entries, self._meta, self.artifact = {}, {}, None
        self._fault, self._commit_cb = fault, commit
        self._resume_hess, self._last_index = {}, None
        layers = params["layers"]
        n_layers = (len(layers) if isinstance(layers, (list, tuple))
                    else cfg.n_layers)
        encoder = params.get("encoder")
        if model.encdec and frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder calibrates on "
                             f"frames=(N, Tf, d_model)")
        if resume is not None and encoder is not None:
            raise NotImplementedError(
                "resume covers the decoder stack only; encoder-decoder "
                "calibration restarts from scratch")
        q = q_enc = None
        if rsq.rotate:
            gen = generator(rsq.seed, model.device)  # draws where Q is None
            q = rotation_matrix(params, cfg, rotation, gen)
            if encoder is not None:
                q_enc = rotation_matrix(params, cfg, rotation_enc, gen)
            params = rotate_ends(params, q, q_enc)
            report["rotated"] = True
        new_params = {k: v for k, v in params.items() if k != "layers"}

        calib = expand_dataset(calib_tokens.to(model.device), rsq.expansion)
        counts = torch.bincount(calib.reshape(-1), minlength=cfg.vocab_size
                                )[:cfg.vocab_size].float()
        n = calib.shape[0]

        def batches(a: torch.Tensor) -> list:
            return [a[i:i + batch_size].to(model.device, model.dtype)
                    for i in range(0, n, batch_size)]

        toks = [calib[i:i + batch_size] for i in range(0, n, batch_size)]
        media_b = batches(media) if media is not None else None
        self._rc = _RunCtx(toks=toks, counts=counts, medias=None,
                           verbose=verbose)
        if encoder is not None:
            xs = batches(frames)
            if "frame_proj" in params:
                xs = [x @ params["frame_proj"].to(x.dtype) for x in xs]
            enc_it = iter(encoder["layers"])

            def fetch_enc():
                p_blk = next(enc_it)
                return p_blk if q is None else rotate_layer(p_blk, cfg,
                                                            q_enc)

            enc_tasks = [LayerTask(f"enc{li}", ["enc", li], ENCODER,
                                   fetch_enc)
                         for li in range(cfg.n_encoder_layers)]
            # the encoder's outputs are the decoder's media: its last layer
            # propagates too
            xs, enc_outs = scheduler.run(self, enc_tasks, xs,
                                         propagate_last=True)
            new_params["encoder"] = {
                "layers": [p for p, _ in enc_outs],
                "final_norm": params["encoder"]["final_norm"]}
            for task, (_, rep) in zip(enc_tasks, enc_outs):
                report["layers"][task.tag] = rep
            media_b = [rms_norm(x, params["encoder"]["final_norm"],
                                cfg.norm_eps) for x in xs]
            del xs
        self._rc.medias = media_b

        dec_it = iter(layers)
        metas = model.metas

        def fetch(li: int):
            p_blk = next(dec_it)
            if q is None:  # rotation is set-up: outside the layer's time
                return p_blk
            return rotate_layer(
                p_blk, cfg, q, cross=metas[li].cross, q_media=q_enc,
                media_norm=None if encoder is None
                else encoder["final_norm"])

        tasks = [LayerTask(f"layer{li}", layer_loc(cfg, li), metas[li],
                           functools.partial(fetch, li), li)
                 for li in range(n_layers)]
        self._last_index = n_layers - 1
        start, pre_outs = 0, []
        if resume is None:
            acts = [model.embed(params, tok) for tok in toks]
        else:
            start = int(resume["start"])
            solved = {int(k): v for k, v in resume["solved"].items()}
            if sorted(solved) != list(range(start)):
                raise ValueError(f"resume state is not a solved prefix: "
                                 f"{sorted(solved)} against start {start}")
            reps = resume.get("reports") or {}
            for li in range(start):
                next(dec_it)  # the original block: solved already
                rep = dict(reps.get(f"layer{li}")
                           or {"weights": {}, "seconds": 0.0})
                rep["resumed"] = True
                pre_outs.append((_to_device(solved[li], model.device), rep))
            acts = [_to_device(a, model.device) for a in resume["acts"]]
            for name, em in (resume.get("art_meta") or {}).items():
                self._meta[name] = dict(em)
                self._entries[name] = _to_device(resume["art"][name],
                                                 model.device)
            for li, hs in (resume.get("hessians") or {}).items():
                self._resume_hess[int(li)] = _to_device(hs, model.device)
        # nothing reads the last decoder layer's outputs: its apply sweep
        # is not issued
        acts, outs = scheduler.run(self, tasks[start:], acts,
                                   propagate_last=False)
        del acts
        outs = pre_outs + outs
        new_params["layers"] = [p for p, _ in outs]
        for task, (_, rep) in zip(tasks, outs):
            report["layers"][task.tag] = rep
        self._rc = None
        self._fault = self._commit_cb = None
        if rsq.pack_output:
            self.artifact = {
                "entries": self._entries, "meta": self._meta,
                "spec": {"bits": rsq.bits, "sym": rsq.sym,
                         "group_size": rsq.group_size,
                         "method": rsq.method}}
            report["packed"] = {"entries": len(self._entries)}
        return new_params, report


def _to_device(tree, device):
    """A restored (host) tree of tensors on ``device``, dicts and lists
    kept."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def quantize_model(model: Model, params: dict, calib_tokens,
                   rsq: RSQConfig, **kw):
    return RSQPipeline(model, rsq).run(params, calib_tokens, **kw)
