"""The port's ``runtime.fault`` against the reference's on the same specs:
``RetryPolicy``'s backoff curve and what it treats as recoverable, and
``FaultPlan``'s parsing, arming, firing record and refusals."""
import pytest

from repro.runtime import fault as ref
from repro_torch.runtime import fault as port


@pytest.mark.parametrize("kw", [
    dict(backoff_s=0.5, backoff_factor=2.0, max_backoff_s=3.0),
    dict(backoff_s=0.0),
    dict(),
    dict(backoff_s=0.05, backoff_factor=3.0, max_backoff_s=1.0)])
def test_retry_policy_backoff_curve(kw):
    p, r = port.RetryPolicy(**kw), ref.RetryPolicy(**kw)
    got = [p.backoff(n) for n in range(0, 9)]
    assert got == [r.backoff(n) for n in range(0, 9)]
    assert got == sorted(got) and got[-1] <= p.max_backoff_s
    assert p.max_restarts == r.max_restarts
    assert p.is_recoverable(port.InjectedFailure("x"))
    assert not p.is_recoverable(RuntimeError("CUDA error"))
    assert not p.is_recoverable(ValueError("x"))


def test_retry_policy_curve_values():
    p = port.RetryPolicy(backoff_s=0.5, backoff_factor=2.0, max_backoff_s=3.0)
    assert [p.backoff(n) for n in (1, 2, 3, 4, 5)] == [0.5, 1.0, 2.0, 3.0, 3.0]
    assert port.RetryPolicy(backoff_s=0.0).backoff(4) == 0.0


@pytest.mark.parametrize("specs", [
    ["3:solve", "0:capture:2"],
    ["2:burst"],
    ["1:admit:2", "4:ingest", "7:retire:3", "2:burst:0"],
    ["5:pack", "5:apply:1"]])
def test_fault_plan_parse_and_check(specs):
    p, r = port.FaultPlan.parse(specs), ref.FaultPlan.parse(specs)
    assert p.fail_at == r.fail_at
    points = sorted(p.fail_at) * 4
    fired = {"port": [], "ref": []}
    for layer, stage in points:
        for side, plan, exc in (("port", p, port.InjectedFailure),
                                ("ref", r, ref.InjectedFailure)):
            try:
                plan.check(layer, stage)
                fired[side].append(None)
            except exc as e:
                fired[side].append(str(e))
    assert fired["port"] == fired["ref"]
    assert p.fired == r.fired and p.fail_at == r.fail_at
    assert all(v == 0 for v in p.fail_at.values())  # counts exhausted


def test_fault_plan_batch_keys_and_refusals():
    plan = port.FaultPlan.parse(["3:solve", "0:capture:2"])
    assert plan.fail_at == {(3, "solve"): 1, (0, "capture"): 2}
    for _ in range(2):
        with pytest.raises(port.InjectedFailure):
            plan.check(0, "capture", batch=0)
    plan.check(0, "capture", batch=0)  # count exhausted: no longer armed
    assert [f["layer"] for f in plan.fired] == [0, 0]
    # batch-specific keys outrank the layer-wide key
    plan2 = port.FaultPlan({(1, "apply", 2): 1})
    plan2.check(1, "apply", batch=0)
    with pytest.raises(port.InjectedFailure):
        plan2.check(1, "apply", batch=2)
    assert port.STAGES == ref.STAGES
    assert port.SERVE_STAGES == ref.SERVE_STAGES
    with pytest.raises(ValueError, match="unknown stage"):
        port.FaultPlan({(0, "bogus"): 1})
    with pytest.raises(ValueError, match="LAYER:STAGE"):
        port.FaultPlan.parse(["nope"])


def test_event_log_records_and_forwards():
    seen = []
    log = port.EventLog(seen.append, verbose=False)
    ev = log.emit("burst_retry", round=3, attempt=1)
    assert ev["kind"] == "burst_retry" and ev["round"] == 3
    assert seen == [ev] and list(log) == [ev]
    assert log.kinds() == ["burst_retry"]
