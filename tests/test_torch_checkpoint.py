"""The port's crash-safe checkpoints (``checkpoint/checkpoint.py``): the
counterparts of the reference's ``tests/test_checkpoint.py`` (round trip
and latest-k retention, the asynchronous save, no partial directories, a
half-written step ignored, restore of a given step), on trees of torch
tensors; the write-once parts that outlive the retention; and the reference's manager and the port's holding the same
values of one state."""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.checkpoint.checkpoint import CheckpointManager


@pytest.fixture
def state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.arange(4, dtype=torch.bfloat16)},
            "opt": [torch.ones(3), {"v": torch.zeros(2, dtype=torch.int32)}],
            "step": 7}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) and x.dtype == y.dtype
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def test_roundtrip_and_retention(tmp_path, state):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        cm.save(s, state, extra={"loader": {"step": s}}, blocking=True)
    assert cm.all_steps() == [20, 30]
    step, restored, extra = cm.restore()
    assert step == 30 and extra["loader"]["step"] == 30
    assert _same(state, restored)
    assert restored["params"]["w"].device.type == "cpu"


def test_async_save(tmp_path, state):
    """The save returns before the files are written; ``wait`` joins it,
    and a later change to the caller's tensors does not reach the saved
    copy (taken on the caller's thread)."""
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(1, state)
    state["params"]["w"].add_(1.0)
    cm.wait()
    assert cm.latest_step() == 1
    _, restored, _ = cm.restore()
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_async_save_error_surfaces_at_wait(tmp_path, state):
    cm = CheckpointManager(tmp_path / "d", keep=3)
    (tmp_path / "d").rmdir()
    (tmp_path / "d").write_text("not a directory")
    cm.save(1, state)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        cm.wait()


def test_atomicity_no_partial_dirs(tmp_path, state):
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(5, state, blocking=True)
    assert not list(tmp_path.glob("tmp.*"))
    d = tmp_path / "step_0000000005"
    assert (d / "DONE").exists()
    assert not list(d.glob("*.tmp*"))


def test_half_written_step_is_ignored(tmp_path, state):
    """A step without its DONE marker (cut short mid-save) is invisible to
    ``latest_step`` and refused by ``restore``: recovery takes the step
    before it."""
    cm = CheckpointManager(tmp_path, keep=5)
    cm.save(1, state, blocking=True)
    cm.save(2, state, blocking=True)
    (tmp_path / "step_0000000002" / "DONE").unlink()
    assert cm.all_steps() == [1]
    assert cm.latest_step() == 1
    step, _, _ = cm.restore()
    assert step == 1
    with pytest.raises(FileNotFoundError, match="half-written"):
        cm.restore(2)
    (tmp_path / "step_0000000001" / "DONE").unlink()
    with pytest.raises(FileNotFoundError):
        cm.restore()


def test_restore_specific_step(tmp_path, state):
    cm = CheckpointManager(tmp_path, keep=5)
    cm.save(1, state, blocking=True)
    changed = dict(state, params={"w": state["params"]["w"] * 2,
                                  "b": state["params"]["b"]})
    cm.save(2, changed, blocking=True)
    _, s1, _ = cm.restore(1)
    _, s2, _ = cm.restore(2)
    assert torch.equal(s1["params"]["w"] * 2, s2["params"]["w"])


def test_holds_what_the_reference_holds(tmp_path):
    """One state saved by the reference's manager (numpy leaves) and by the
    port's (torch leaves): the same values back, step and extra."""
    rng = np.random.default_rng(0)
    arrays = {"solved": {"0": rng.standard_normal((4, 8)).astype(
        np.float32)}, "acts": [rng.standard_normal((2, 3)).astype(
            np.float32)]}
    extra = {"next": 1, "art_meta": {"layer0/mixer/wq": {"d_in": 4}}}
    ref = RefCheckpointManager(tmp_path / "ref")
    ref.save(1, arrays, extra=extra, blocking=True)
    port = CheckpointManager(tmp_path / "port")
    port.save(1, {"solved": {"0": torch.from_numpy(arrays["solved"]["0"])},
                  "acts": [torch.from_numpy(arrays["acts"][0])]},
              extra=extra, blocking=True)
    s_r, st_r, ex_r = ref.restore()
    s_p, st_p, ex_p = port.restore()
    assert (s_r, ex_r) == (s_p, ex_p)
    np.testing.assert_array_equal(np.asarray(st_r["solved"]["0"]),
                                  st_p["solved"]["0"].numpy())
    np.testing.assert_array_equal(np.asarray(st_r["acts"][0]),
                                  st_p["acts"][0].numpy())


def test_parts_written_once_and_kept(tmp_path, state):
    """A part is written beside its step, once, and the retention that
    removes the step keeps it; the parts are whole when the step is."""
    cm = CheckpointManager(tmp_path, keep=1)
    cm.save(1, {"acts": [torch.ones(2)]}, extra={"parts": ["a"]},
            parts={"a": state})
    cm.save(2, {"acts": [torch.zeros(2)]}, extra={"parts": ["a", "b"]},
            parts={"b": {"w": torch.arange(3)}}, blocking=True)
    assert cm.all_steps() == [2]
    assert sorted(p.name for p in (tmp_path / "parts").iterdir()) == \
        ["a.pt", "b.pt"]
    _, restored, extra = cm.restore()
    assert torch.equal(restored["acts"][0], torch.zeros(2))
    assert _same(cm.load_part("a"), state)
    assert torch.equal(cm.load_part(extra["parts"][1])["w"], torch.arange(3))
