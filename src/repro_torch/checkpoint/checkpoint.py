"""Crash-safe checkpoints: atomic, asynchronous, latest-k.

  * atomic: a step is written into ``<dir>/tmp.<step>`` and renamed to
    ``step_<step>`` (``os.rename`` is atomic on POSIX); inside it the
    payload is written to a temporary name and renamed too, and a ``DONE``
    marker is the last file written, so ``all_steps`` never offers a step
    cut short mid-save (a half-written or copied directory without it).
  * asynchronous: the device -> host copy runs on the caller's thread (the
    state is consistent with the step), serialisation on a background
    thread, so the caller does not wait for the disk; one save is in
    flight at a time, and its error surfaces at the next ``wait``.
  * latest-k: older steps are removed after each successful save.
  * parts: a save may also carry named parts, each written once into
    ``<dir>/parts/<name>.pt`` (a temporary name, then ``os.replace``)
    before the step's own files, and never removed by the retention: the
    steps that come later name the parts they build on, so a state that
    grows (a stack solved layer by layer) is written once in all, not
    once a step.

A state is a tree of dicts, lists and tuples whose leaves are tensors and
plain Python values; it is saved with ``torch.save`` (``state.pt``) and
restored with ``torch.load(weights_only=True)`` (no code runs at load), on
the CPU.  ``extra`` is kept as JSON in ``meta.json``.  The reference's
elastic re-layout onto another mesh comes with multi-GPU quantization.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch


def _to_host(tree):
    """A detached CPU copy of every tensor of ``tree``."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: dict | None = None,
             blocking: bool = False, parts: dict | None = None) -> None:
        """state: a tree of tensors and plain values; ``extra``: a JSON
        dict kept beside it; ``parts``: {name: tree}, each written once
        (``load_part``), before the step."""
        self.wait()  # one outstanding save at a time
        host = _to_host(state)
        host_parts = {n: _to_host(t) for n, t in (parts or {}).items()}
        meta = {"step": int(step), "extra": extra or {}, "time": time.time(),
                "format": "torch-save-v1"}

        def work():
            try:
                for name, tree in host_parts.items():
                    pdir = self.dir / "parts"
                    pdir.mkdir(exist_ok=True)
                    torch.save(tree, pdir / f"{name}.tmp.pt")
                    os.replace(pdir / f"{name}.tmp.pt", pdir / f"{name}.pt")
                tmp = self.dir / f"tmp.{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                torch.save(host, tmp / "state.tmp.pt")
                os.replace(tmp / "state.tmp.pt", tmp / "state.pt")
                (tmp / "meta.tmp.json").write_text(json.dumps(meta))
                os.replace(tmp / "meta.tmp.json", tmp / "meta.json")
                (tmp / "DONE").write_text("ok")  # last: marks it whole
                final = self.dir / f"step_{step:010d}"
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except Exception as e:  # surfaced at the next wait()
                self._error = e

        if blocking:
            work()
            self.check()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the save in flight, and raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from e

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """The whole steps, oldest first: a directory without its ``DONE``
        marker was cut short mid-save and is never offered."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "DONE").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> tuple[int, Any, dict]:
        """(step, state on the CPU, extra) of ``step``, or of the latest
        whole step when None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        if not (d / "DONE").exists():
            raise FileNotFoundError(
                f"checkpoint {d} is missing or half-written (no DONE "
                f"marker): restore an earlier step")
        meta = json.loads((d / "meta.json").read_text())
        state = torch.load(d / "state.pt", map_location="cpu",
                           weights_only=True)
        return int(meta["step"]), state, meta.get("extra", {})

    def load_part(self, name: str) -> Any:
        """A part written by an earlier ``save``, on the CPU."""
        return torch.load(self.dir / "parts" / f"{name}.pt",
                          map_location="cpu", weights_only=True)
