"""Failure injection and retry policy, shared by the serve engine and (in a
later slice) the quantize pipeline.

Failures are injected as exceptions at named stage points, so the recovery
paths run end to end in tests and on the card without a real fault:

  * :class:`RetryPolicy`: which exception types are recoverable, how many
    restarts are allowed, and the exponential backoff between them.  Only
    :class:`InjectedFailure` is recoverable by default: a CUDA error, a
    failed kernel build or a failed launch propagates.
  * :class:`FaultPlan`: arms a failure at a ``(point, stage)``.  The quantize
    pipeline's points are ``(layer, stage)`` with ``stage`` in
    :data:`STAGES` (optionally down to a batch); the serve engine's are
    ``(round, stage)`` with ``stage`` in :data:`SERVE_STAGES`.  Both use the
    CLI spec ``POINT:STAGE[:COUNT]``.
  * :class:`EventLog`: structured events (a dict with a ``kind`` and its
    fields), kept in a list and optionally passed to an ``on_event``
    callback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class InjectedFailure(RuntimeError):
    pass


STAGES = ("capture", "solve", "apply", "pack")

# The serve engine's stage points: one scheduling round visits admit ->
# ingest -> burst -> retire and checks the plan at each, before the stage's
# device work, so an injected failure leaves the pools and slot rows as
# they were and a retry starts from the same inputs.
SERVE_STAGES = ("admit", "ingest", "burst", "retire")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Which failures are survivable, and how to pace the restarts.

    ``recoverable`` is the tuple of exception types treated as transient;
    anything else propagates at once.  Restart ``n`` (1-based) sleeps
    ``backoff_s * backoff_factor**(n-1)`` seconds, capped at
    ``max_backoff_s``."""

    recoverable: tuple = (InjectedFailure,)
    max_restarts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0

    def is_recoverable(self, e: BaseException) -> bool:
        return isinstance(e, tuple(self.recoverable))

    def backoff(self, attempt: int) -> float:
        """Seconds to sleep before restart ``attempt`` (1-based)."""
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** max(attempt - 1, 0),
                   self.max_backoff_s)


class EventLog:
    """Structured events: appended dicts, with an optional sink callback."""

    def __init__(self, on_event: Optional[Callable[[dict], None]] = None,
                 verbose: bool = True):
        self.events: list[dict] = []
        self.on_event = on_event
        self.verbose = verbose

    def emit(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "time": time.time(), **fields}
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)
        if self.verbose:
            body = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{kind}] {body}", flush=True)
        return ev

    def __iter__(self):
        return iter(self.events)

    def kinds(self) -> list[str]:
        return [e["kind"] for e in self.events]


@dataclasses.dataclass
class FaultPlan:
    """Stage-level failure injection.

    ``fail_at`` maps an injection point to how many times it fires: keys
    are ``(layer, stage)`` or, for a per-batch stage, ``(layer, stage,
    batch)``; for the serve engine ``layer`` is the scheduling round.
    ``check`` is called right before the stage's work; an armed point
    raises ``exc`` (default :class:`InjectedFailure`) and records the firing
    in ``fired``."""

    fail_at: dict
    exc: type = InjectedFailure
    fired: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.fail_at = dict(self.fail_at)
        for key in self.fail_at:
            stage = key[1]
            if stage not in STAGES + SERVE_STAGES:
                raise ValueError(f"unknown stage {stage!r}; one of "
                                 f"{STAGES + SERVE_STAGES}")

    def check(self, layer: int, stage: str, batch: Optional[int] = None
              ) -> None:
        keys = [(layer, stage)]
        if batch is not None:
            keys.insert(0, (layer, stage, batch))
        for key in keys:
            if self.fail_at.get(key, 0) > 0:
                self.fail_at[key] -= 1
                self.fired.append(
                    {"layer": layer, "stage": stage, "batch": batch})
                raise self.exc(
                    f"injected failure at layer {layer} stage {stage}"
                    + (f" batch {batch}" if batch is not None else ""))

    @classmethod
    def parse(cls, specs: list[str], **kw) -> "FaultPlan":
        """Build a plan from CLI specs ``LAYER:STAGE[:COUNT]`` (for the
        serve engine ``ROUND:STAGE[:COUNT]``)."""
        fail_at: dict = {}
        for s in specs:
            parts = s.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"--fail-at wants LAYER:STAGE[:COUNT], "
                                 f"got {s!r}")
            layer, stage = int(parts[0]), parts[1]
            count = int(parts[2]) if len(parts) == 3 else 1
            fail_at[(layer, stage)] = count
        return cls(fail_at, **kw)
