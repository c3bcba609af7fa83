"""Layer schedulers of the RSQ calibration loop.

A layer's recipe (capture -> solve -> apply) is a strict chain: layer
i + 1 calibrates on layer i's *quantized* outputs.  What a schedule
chooses is when the host issues each stage's device work and when it
waits for the device.  The pipeline (``core.pipeline.RSQPipeline``)
exposes the stages as engine hooks (``prewarm``, ``layer_begin``,
``layer_capture``, ``layer_solve``, ``layer_sync``, ``layer_apply``,
``layer_finalize``), and a scheduler issues them:

``SequentialScheduler``
    The classic loop: capture every batch, solve, read the layer's report
    back, apply every batch, next layer.  The host waits for the device
    after each stage (``engine.clock``), which is what times ``capture_s``,
    ``solve_s`` and ``apply_s``.  Default on the CPU.

``OverlappedScheduler``
    Layer i's solve is issued and not waited for; then layer i's apply
    and layer i + 1's capture are issued batch by batch over two
    activation lists (A holds layer i's inputs, B fills with layer i + 1's
    inputs; they swap at the layer boundary), and every report is read
    back once, at the end of the stack.  CUDA runs the queue in issue
    order, so the host runs ahead of the device and the device never
    waits for the host between layers.  The same operations on the same
    values in the same order: the quantized parameters, reports and
    artifact entries are the sequential schedule's bit for bit.  Default
    on CUDA.

Both thread two more hooks through the stack:

``engine.stage_point(index, stage, batch=None)``
    Before each stage's device work (each batch of ``capture`` and
    ``apply``, each layer's ``solve``; the pipeline raises ``pack`` inside
    its artifact write-back): where a ``runtime.fault.FaultPlan`` injects
    a failure.

``engine.layer_commit(task, state, p_new, acts, next_state=)``
    Once a layer, after its apply sweep is issued: ``acts`` are the next
    layer's inputs and, under the overlapped schedule, ``next_state``
    already holds the next layer's finished Hessians.  A
    ``core.resume.QuantizeRunner`` checkpoints here; without one it does
    nothing.
"""
from __future__ import annotations

from typing import Optional

import torch


class LayerScheduler:
    """Drives the engine hooks over a stack of layer tasks: ``run``
    returns the propagated activations and one (p_new, report) a task."""

    name = "base"

    def run(self, engine, tasks: list, acts: list, *,
            propagate_last: bool = True) -> tuple[list, list]:
        """``propagate_last=False``: nothing reads the last layer's
        outputs (the decoder stack), so its apply sweep is not issued; the
        encoder passes True, as its outputs are the decoder's media."""
        raise NotImplementedError


class SequentialScheduler(LayerScheduler):
    """One stage at a time, the host waiting for the device after each."""

    name = "sequential"

    def run(self, engine, tasks, acts, *, propagate_last=True):
        outs = []
        for k, task in enumerate(tasks):
            st = engine.layer_begin(task, acts)
            engine.clock(st, "begin")
            for bi, x_b in enumerate(acts):
                engine.stage_point(task.index, "capture", bi)
                engine.layer_capture(st, bi, x_b)
            engine.clock(st, "capture")
            engine.stage_point(task.index, "solve")
            p_new = engine.layer_solve(st)
            engine.layer_sync(st)  # the report, before any propagation
            engine.clock(st, "solve")
            if propagate_last or k + 1 < len(tasks):
                buf = []
                for bi, x_b in enumerate(acts):
                    engine.stage_point(task.index, "apply", bi)
                    buf.append(engine.layer_apply(st, p_new, bi, x_b))
                acts = buf
            engine.clock(st, "apply")
            outs.append((p_new, engine.layer_finalize(st)))
            engine.layer_commit(task, st, p_new, acts)
        return acts, outs


class OverlappedScheduler(LayerScheduler):
    """Double-buffered issue over the layer stack.

    For layer i, with no host sync:

        solve(i)
        begin(i+1)
        for each batch b:
            y_b = apply(i, b)        # reads solve(i)'s output
            capture(i+1, y_b)        # reads apply(i, b)'s output
        swap the activation lists

    and the reports of every layer are read back at the end (the drain).
    """

    name = "overlapped"

    def run(self, engine, tasks, acts, *, propagate_last=True):
        if not tasks:
            return acts, []
        engine.prewarm(tasks, acts)
        pending = []  # (state, p_new) awaiting the drain
        st = engine.layer_begin(tasks[0], acts)
        for bi, x_b in enumerate(acts):
            engine.stage_point(tasks[0].index, "capture", bi)
            engine.layer_capture(st, bi, x_b)
        for i, task in enumerate(tasks):
            engine.stage_point(task.index, "solve")
            p_new = engine.layer_solve(st)  # issued, not waited for
            last = i + 1 == len(tasks)
            st_next = None if last else engine.layer_begin(tasks[i + 1],
                                                           acts)
            if not last or propagate_last:
                buf = []  # fills while `acts` is still read
                for bi, x_b in enumerate(acts):
                    engine.stage_point(task.index, "apply", bi)
                    y_b = engine.layer_apply(st, p_new, bi, x_b)
                    if st_next is not None:
                        engine.stage_point(tasks[i + 1].index, "capture", bi)
                        engine.layer_capture(st_next, bi, y_b)
                    buf.append(y_b)
                acts = buf
            pending.append((st, p_new))
            # after the interleaved capture sweep: the next layer's
            # Hessians are complete here, so a checkpoint can keep them
            engine.layer_commit(task, st, p_new, acts, next_state=st_next)
            st = st_next
        outs = [(p_new, engine.layer_finalize(st_)) for st_, p_new in pending]
        return acts, outs


SCHEDULERS: dict[str, type[LayerScheduler]] = {
    "sequential": SequentialScheduler,
    "overlapped": OverlappedScheduler,
}


def get_scheduler(name: Optional[str] = None, device=None) -> LayerScheduler:
    """A scheduler by name.  None or "auto" chooses by ``device`` (the
    model's; the current CUDA device's availability when not given):
    sequential on the CPU, overlapped on CUDA, as the reference's "auto"
    chooses by backend."""
    if name is None or name == "auto":
        dev = (torch.device(device) if device is not None else
               torch.device("cuda" if torch.cuda.is_available() else "cpu"))
        name = "overlapped" if dev.type == "cuda" else "sequential"
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; one of "
                         f"{sorted(SCHEDULERS)}") from None
