"""Resumable quantization: checkpoints of the RSQ pipeline a layer solve
at a time.

``QuantizeRunner`` drives ``RSQPipeline.run`` through failures.  The unit
of durable progress is one layer: after layer i's apply sweep is issued,
the pipeline calls back (``RSQPipeline.layer_commit``) with all that the
stack needs to go on from layer i + 1, and the runner keeps it through the
crash-safe ``checkpoint.checkpoint.CheckpointManager``:

  * the quantized blocks of the layers solved since the last save, and
    the artifact's entries they added: one part of the manager's, written
    once (a step names every part before it, and a restore joins them in
    order), so the bytes written grow with the depth, not its square;
  * the propagated activations (layer i + 1's calibration inputs);
  * the metadata of every artifact entry so far (which also keeps their
    order, as the artifact's files are written in it);
  * under the overlapped schedule, layer i + 1's finished Hessians (the
    resumed run then skips that capture sweep).

On a restart the runner restores the latest checkpoint and re-enters
``RSQPipeline.run(resume=...)``: the solved layers are skipped, the stack
goes on from the restored activations, and the packed artifact is
byte-identical to that of a run that never died (``tests/
test_torch_resume.py`` compares the files' SHA-256 under both schedules).

Failures: ``runtime.fault.RetryPolicy`` says which are recoverable (by
default only an injected one), how many restarts, and the backoff between
them; ``runtime.fault.EventLog`` keeps ``checkpoint`` / ``restart`` /
``resume`` events; ``runtime.fault.FaultPlan`` injects failures at any
``(layer, stage)``, stage one of capture, solve, apply and pack.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.pipeline import RSQPipeline
from repro_torch.runtime.fault import EventLog, RetryPolicy


class QuantizeRunner:
    """Drive ``RSQPipeline.run`` with a checkpoint every
    ``save_every_layers`` layer solves (and always at the last layer, which
    waits for its save).

    ``policy``: which exceptions an in-process retry survives, how many
    restarts and the backoff; a new process pointed at the same progress
    directory resumes through the same restore.  ``save_hessians``: keep
    the next layer's finished Hessians where the schedule has them
    (overlapped): exact fp32 sums, so only the resumed run's time
    changes.  ``resume=False`` ignores existing checkpoints (in-process
    retries then start from scratch, which still ends: a ``FaultPlan``
    counts its firings down).

    After ``run``: ``restarts``, ``events`` and ``ckpt_overhead_s`` (the
    seconds spent in the commit callback and the saves it waited for)."""

    def __init__(self, pipeline: RSQPipeline, ckpt: CheckpointManager, *,
                 save_every_layers: int = 1,
                 policy: Optional[RetryPolicy] = None,
                 save_hessians: bool = True, resume: bool = True,
                 on_event=None, verbose: bool = False):
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.save_every_layers = max(int(save_every_layers), 1)
        self.policy = policy or RetryPolicy()
        self.save_hessians = save_hessians
        self.resume = resume
        self.events = EventLog(on_event, verbose=verbose)
        self.restarts = 0
        self.ckpt_overhead_s = 0.0
        self._reset()

    def _reset(self) -> None:
        # the layers solved since the last save, the parts saved so far,
        # and the artifact entries they hold
        self._solved: dict[str, Any] = {}
        self._parts: list[str] = []
        self._saved_entries: set[str] = set()
        self._reports: dict[str, dict] = {}
        self._last_saved = 0

    def _commit(self, *, index: int, state: dict, p_new, acts,
                art_entries: dict, art_meta: dict,
                next_hessians: Optional[dict], next_index: Optional[int],
                last: bool) -> None:
        """``RSQPipeline.layer_commit``'s callback: layer ``index`` is
        solved; checkpoint on the cadence, and always at the last layer."""
        t0 = time.perf_counter()
        self._solved[str(index)] = p_new
        self.pipeline.layer_sync(state)  # floats for the JSON report
        self._reports[f"layer{index}"] = {
            "weights": dict(state["pending"]),
            "seconds": round(time.perf_counter() - state["t0"], 4)}
        if last or index + 1 - self._last_saved >= self.save_every_layers:
            name = f"layers_{self._last_saved:06d}_{index:06d}"
            part = {"solved": self._solved,
                    "art": {n: dict(e) for n, e in art_entries.items()
                            if n not in self._saved_entries}}
            ckpt_state: dict[str, Any] = {"acts": list(acts)}
            extra = {"next": index + 1, "complete": bool(last),
                     "parts": self._parts + [name],
                     "reports": dict(self._reports),
                     "art_meta": {n: dict(m) for n, m in art_meta.items()},
                     "hess_layer": None}
            if self.save_hessians and next_hessians is not None and not last:
                ckpt_state["hessians"] = {str(next_index):
                                          dict(next_hessians)}
                extra["hess_layer"] = int(next_index)
            self.ckpt.save(index + 1, ckpt_state, extra=extra, blocking=last,
                           parts={name: part})
            self._parts.append(name)
            self._saved_entries.update(part["art"])
            self._solved = {}
            self._last_saved = index + 1
            self.events.emit("checkpoint", layer=index, next=index + 1,
                             complete=bool(last), entries=len(art_entries))
        self.ckpt_overhead_s += time.perf_counter() - t0

    def _load_resume(self) -> Optional[dict]:
        """The latest checkpoint as ``RSQPipeline.run(resume=...)``'s
        dict, or None when there is none."""
        self.ckpt.wait()
        if self.ckpt.latest_step() is None:
            return None
        step, state, extra = self.ckpt.restore()
        solved: dict[str, Any] = {}
        art: dict[str, Any] = {}
        for name in extra["parts"]:
            part = self.ckpt.load_part(name)
            solved.update(part["solved"])
            art.update(part["art"])
        resume = {"start": int(extra["next"]), "solved": solved,
                  "acts": list(state.get("acts", [])), "art": art,
                  "art_meta": extra.get("art_meta") or {},
                  "reports": extra.get("reports") or {}}
        hl = extra.get("hess_layer")
        if hl is not None and "hessians" in state:
            resume["hessians"] = {int(hl): state["hessians"][str(hl)]}
        # the next save writes only what comes after this step
        self._parts = list(extra["parts"])
        self._saved_entries = set(art)
        self._reports = dict(resume["reports"])
        self._last_saved = int(step)
        self.events.emit("resume", step=int(step), start=resume["start"],
                         complete=bool(extra.get("complete")))
        return resume

    def run(self, params: dict, calib_tokens, *, fault=None, **kw):
        """Run the pipeline to its end through recoverable failures: on
        one, a ``restart`` event, the backoff, the latest checkpoint
        restored and the stack re-entered there.  Anything else
        propagates.  ``params["layers"]`` must be a list, not a
        ``handover`` iterator: a retry reads the blocks again.  Returns
        ``RSQPipeline.run``'s (new_params, report)."""
        while True:
            self._reset()
            resume = self._load_resume() if self.resume else None
            try:
                return self.pipeline.run(params, calib_tokens, fault=fault,
                                         commit=self._commit, resume=resume,
                                         **kw)
            except Exception as e:
                # progress already handed to the checkpointer lands before
                # anything else: the next attempt (or process) resumes there
                try:
                    self.ckpt.wait()
                except Exception:
                    pass  # a failed save: an older checkpoint greets the
                    # next attempt
                if not self.policy.is_recoverable(e):
                    raise
                self.restarts += 1
                if self.restarts > self.policy.max_restarts:
                    raise
                b = self.policy.backoff(self.restarts)
                self.events.emit("restart", error=repr(e),
                                 attempt=self.restarts,
                                 backoff_s=round(b, 4))
                if b:
                    time.sleep(b)
