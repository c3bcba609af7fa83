"""Resumable quantization (``core/resume.QuantizeRunner`` and the
schedulers' stage hooks): the counterparts of the reference's
``tests/test_resume.py`` but its mesh case.

A run killed at a stage point (mid-capture, mid-solve, mid-pack, under
either schedule) and resumed from its latest layer checkpoint by a fresh
pipeline and runner writes a packed artifact whose files are byte-
identical (SHA-256) to a run that never died: codes, scales, zeros, the
residual, the entries' order and the checksums in ``meta.json``.  Also:
the in-process retry, an unrecoverable error that propagates, the CLI's
refusals (an existing progress directory without ``--resume``, an
unsupported ``--kv-bits``), and a resumed artifact's codes against the
reference's uninterrupted run on the same weights.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import save_packed_artifact as ref_save_artifact
from repro.configs import get_config as ref_get_config
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.models import build_model
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           save_packed_artifact)
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.resume import QuantizeRunner
from repro_torch.launch.quantize import main as quantize_main
from repro_torch.models.lm import Model
from repro_torch.runtime.fault import FaultPlan, InjectedFailure, RetryPolicy

N_CALIB, SEQ, BATCH = 8, 32, 4
# the injection layer: > 0, so that a layer checkpoint exists to resume
# from.  The overlapped schedule issues layer i + 1's capture inside layer
# i's apply sweep, before layer i's commit, so its first capture point
# after a commit is layer 2's (during layer 1's sweep): a 3-layer stack
FAIL_LAYER = 1
STAGES = [("capture", 1), ("solve", None), ("pack", None)]
CAPTURE_LAYER = {"sequential": 1, "overlapped": 2}


def _rsq(scheduler, **kw):
    return RSQConfig(**{"bits": 4, "group_size": 32, "scheduler": scheduler,
                        "pack_output": True, **kw})


@pytest.fixture(scope="module")
def mp():
    """The reference's 3-layer tiny llama3 (d_model 64, vocab 256) and its
    weights in the port, with the calibration tokens."""
    cfg = dataclasses.replace(ref_get_config("llama3-8b").reduced(),
                              dtype="float32", n_layers=3, d_model=64,
                              vocab_size=256)
    ref_model = build_model(cfg)
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), pcfg,
                             device="cpu")
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                              (N_CALIB, SEQ))
    return {"model": Model(pcfg, "cpu"), "params": params,
            "calib": torch.from_numpy(calib), "ref_model": ref_model,
            "ref_params": ref_params, "np_calib": calib}


def _sha_dir(d: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(d).iterdir())}


@pytest.fixture(scope="module")
def baselines(tmp_path_factory, mp):
    """Uninterrupted runs' artifacts, one per schedule: {sched: (dir,
    shas)}."""
    out = {}
    for sched in ("sequential", "overlapped"):
        d = tmp_path_factory.mktemp(f"clean_{sched}")
        pipe = RSQPipeline(mp["model"], _rsq(sched))
        qp, _ = pipe.run(mp["params"], mp["calib"], batch_size=BATCH)
        save_packed_artifact(d, pipe.artifact, params=qp)
        out[sched] = (d, _sha_dir(d))
    return out


def _kill_then_resume(mp, sched, tmp, fault_key, **kw):
    """One killed run (max_restarts 0: the fault propagates), then a fresh
    pipeline and runner over the same progress directory: (the resumed
    runner, its artifact's directory, its report)."""
    prog = tmp / "progress"
    r1 = QuantizeRunner(RSQPipeline(mp["model"], _rsq(sched, **kw)),
                        CheckpointManager(prog),
                        policy=RetryPolicy(max_restarts=0))
    fault = FaultPlan({fault_key: 1})
    with pytest.raises(InjectedFailure):
        r1.run(mp["params"], mp["calib"], fault=fault, batch_size=BATCH)
    assert fault.fired and fault.fired[0]["layer"] == fault_key[0]
    assert CheckpointManager(prog).latest_step() is not None
    pipe2 = RSQPipeline(mp["model"], _rsq(sched, **kw))
    r2 = QuantizeRunner(pipe2, CheckpointManager(prog),
                        policy=RetryPolicy(max_restarts=0))
    qp, report = r2.run(mp["params"], mp["calib"], batch_size=BATCH)
    art = tmp / "artifact"
    save_packed_artifact(art, pipe2.artifact, params=qp)
    return r2, art, report


@pytest.mark.parametrize("sched", ["sequential", "overlapped"])
@pytest.mark.parametrize("stage,batch", STAGES, ids=[s for s, _ in STAGES])
def test_kill_resume_byte_identical(tmp_path, mp, baselines, sched, stage,
                                    batch):
    layer = CAPTURE_LAYER[sched] if stage == "capture" else FAIL_LAYER
    key = (layer, stage) if batch is None else (layer, stage, batch)
    r2, art, report = _kill_then_resume(mp, sched, tmp_path, key)
    assert "resume" in r2.events.kinds()
    # the solved prefix was taken from the checkpoint, not recomputed
    assert report["layers"]["layer0"].get("resumed") is True
    assert _sha_dir(art) == baselines[sched][1]


def test_overlapped_checkpoint_keeps_the_next_layers_hessians(tmp_path, mp,
                                                             baselines,
                                                             monkeypatch):
    """Under the overlapped schedule a commit holds the next layer's
    finished Hessians, and the resumed run does not capture that layer
    again: of the 3-layer stack killed at 1:solve, only layer 2's batches
    are captured, and the artifact is the same."""
    prog = tmp_path / "progress"
    r1 = QuantizeRunner(RSQPipeline(mp["model"], _rsq("overlapped")),
                        CheckpointManager(prog),
                        policy=RetryPolicy(max_restarts=0))
    with pytest.raises(InjectedFailure):
        r1.run(mp["params"], mp["calib"], batch_size=BATCH,
               fault=FaultPlan({(FAIL_LAYER, "solve"): 1}))
    _, state, extra = CheckpointManager(prog).restore()
    assert extra["hess_layer"] == FAIL_LAYER and extra["next"] == FAIL_LAYER
    assert set(state["hessians"][str(FAIL_LAYER)]) >= {"mixer/wq", "ffn/wd"}
    captured = []
    real = pipeline_mod.capture_block

    def counting(*args, **kw):
        captured.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(pipeline_mod, "capture_block", counting)
    pipe = RSQPipeline(mp["model"], _rsq("overlapped"))
    qp, _ = QuantizeRunner(pipe, CheckpointManager(prog),
                           policy=RetryPolicy(max_restarts=0)).run(
        mp["params"], mp["calib"], batch_size=BATCH)
    assert len(captured) == N_CALIB // BATCH  # layer 2's batches alone
    art = tmp_path / "artifact"
    save_packed_artifact(art, pipe.artifact, params=qp)
    assert _sha_dir(art) == baselines["overlapped"][1]


def test_each_solved_layer_is_written_once(tmp_path, mp, baselines):
    """A checkpoint a layer writes each layer's quantized block once: in a
    part of its own, which the later steps name and a restore joins.  No
    step holds a solved block, and the kept steps (latest 2) still resume
    from the parts of the steps that were removed."""
    prog = tmp_path / "progress"
    runner = QuantizeRunner(RSQPipeline(mp["model"], _rsq("sequential")),
                            CheckpointManager(prog, keep=2),
                            policy=RetryPolicy(max_restarts=0))
    runner.run(mp["params"], mp["calib"], batch_size=BATCH)
    ckpt = CheckpointManager(prog, keep=2)
    assert ckpt.all_steps() == [2, 3]
    names = [f"layers_{i:06d}_{i:06d}" for i in range(3)]
    assert sorted(p.stem for p in (prog / "parts").iterdir()) == names
    entries = []
    for i, name in enumerate(names):
        part = ckpt.load_part(name)
        assert list(part["solved"]) == [str(i)]
        assert part["art"] and all(n not in entries for n in part["art"])
        entries += list(part["art"])
    for step in (2, 3):
        _, state, extra = ckpt.restore(step)
        assert "solved" not in state and "art" not in state
        assert extra["parts"] == names[:step]
    assert entries == list(extra["art_meta"])
    # a fresh runner resumes from the complete step through the parts
    pipe = RSQPipeline(mp["model"], _rsq("sequential"))
    qp, report = QuantizeRunner(pipe, CheckpointManager(prog, keep=2)).run(
        mp["params"], mp["calib"], batch_size=BATCH)
    assert all(report["layers"][f"layer{i}"].get("resumed")
               for i in range(3))
    art = tmp_path / "artifact"
    save_packed_artifact(art, pipe.artifact, params=qp)
    assert _sha_dir(art) == baselines["sequential"][1]


@pytest.mark.parametrize("sched", ["sequential", "overlapped"])
def test_in_process_retry_recovers(tmp_path, mp, baselines, sched):
    """With restarts allowed, one runner survives the failure by itself:
    restore, re-entry mid-stack, the same artifact."""
    pipe = RSQPipeline(mp["model"], _rsq(sched))
    runner = QuantizeRunner(pipe, CheckpointManager(tmp_path / "progress"),
                            policy=RetryPolicy(max_restarts=2,
                                               backoff_s=0.001))
    qp, _ = runner.run(mp["params"], mp["calib"], batch_size=BATCH,
                       fault=FaultPlan({(FAIL_LAYER, "solve"): 1}))
    assert runner.restarts == 1
    kinds = runner.events.kinds()
    assert "restart" in kinds and "resume" in kinds
    restart = next(e for e in runner.events if e["kind"] == "restart")
    assert restart["attempt"] == 1 and "backoff_s" in restart
    assert runner.ckpt_overhead_s > 0
    art = tmp_path / "artifact"
    save_packed_artifact(art, pipe.artifact, params=qp)
    assert _sha_dir(art) == baselines[sched][1]


def test_unrecoverable_exception_propagates(tmp_path, mp):
    """A failure outside the policy's recoverable types is not retried."""
    runner = QuantizeRunner(RSQPipeline(mp["model"], _rsq("sequential")),
                            CheckpointManager(tmp_path / "p"),
                            policy=RetryPolicy(recoverable=(KeyError,),
                                               max_restarts=5))
    with pytest.raises(InjectedFailure):
        runner.run(mp["params"], mp["calib"], batch_size=BATCH,
                   fault=FaultPlan({(0, "solve"): 1}))
    assert runner.restarts == 0


def test_resumed_codes_match_reference_uninterrupted(tmp_path, mp):
    """No rotation, the paper's 3 bits and groups of 128: the reference's
    uninterrupted pipeline and the port's run killed at 1:solve and
    resumed give the same packed entries, bit for bit.  (At 4 bits and
    groups of 32 the two frameworks' uninterrupted runs already part on
    this random tiny model: codes on a rounding boundary flip in layer
    0's FFN, and the error feedback through the later layers moves more;
    the port's parent did the same.)"""
    ref_pipe = RefPipeline(mp["ref_model"], RefRSQConfig(
        bits=3, group_size=128, rotate=False, pack_output=True,
        scheduler="sequential"))
    ref_q, _ = ref_pipe.run(mp["ref_params"],
                            jnp.asarray(mp["np_calib"], jnp.int32),
                            batch_size=BATCH)
    ref_dir = tmp_path / "ref"
    ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
    _, art, _ = _kill_then_resume(mp, "overlapped", tmp_path,
                                  (FAIL_LAYER, "solve"), rotate=False,
                                  bits=3, group_size=128)
    ref_e, ref_meta = ref_load_artifact(ref_dir)
    port_e, port_meta = load_packed_artifact(art)
    assert set(port_e) == set(ref_e) and len(ref_e) == 21
    for name, e in ref_e.items():
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(port_e[name][field], e[field])
        assert port_meta["entries"][name]["loc"] == \
            ref_meta["entries"][name]["loc"]


def _cli(tmp_path, *extra):
    return quantize_main([
        "--device", "cpu", "--arch", "llama3-8b-smoke", "--n-calib", "4",
        "--calib-seq", "16", "--batch", "4", "--pack-out",
        str(tmp_path / "art"), *extra])


def test_cli_progress_dir_refusal_and_resume(tmp_path, capsys):
    """As the reference's CLI: a progress directory left by a run is
    refused without ``--resume``; with it the run goes on from there (here
    from the finished stack: every layer resumed) and writes the same
    artifact; ``--resume`` with no directory starts from scratch.  The
    artifact's meta records ``--kv-bits``."""
    first = _cli(tmp_path, "--save-every-layers", "1", "--kv-bits", "8")
    assert first["summary"]["fault_tolerance"]["events"] == [
        "checkpoint", "checkpoint"]
    shas = _sha_dir(tmp_path / "art")
    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["extra"]["kv_bits"] == 8
    assert (tmp_path / "art.progress").is_dir()
    with pytest.raises(SystemExit) as exc:
        _cli(tmp_path, "--save-every-layers", "1", "--kv-bits", "8")
    assert exc.value.code == 2
    assert "--resume" in capsys.readouterr().err
    again = _cli(tmp_path, "--resume", "--kv-bits", "8")
    assert all(rep.get("resumed") for rep in
               again["report"]["layers"].values())
    assert _sha_dir(tmp_path / "art") == shas
    fresh = _cli(tmp_path, "--resume", "--progress-dir",
                 str(tmp_path / "new"))
    assert not any(rep.get("resumed") for rep in
                   fresh["report"]["layers"].values())


def test_cli_refuses_unsupported_kv_bits(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        _cli(tmp_path, "--kv-bits", "4")
    assert exc.value.code == 2
    assert "--kv-bits 4 is not supported" in capsys.readouterr().err


def test_cli_fail_at_retries_in_process(tmp_path):
    out = _cli(tmp_path, "--fail-at", "1:solve", "--scheduler",
               "overlapped")
    ft = out["summary"]["fault_tolerance"]
    assert ft["restarts"] == 1 and "restart" in ft["events"]
    assert out["summary"]["scheduler"] == "overlapped"
