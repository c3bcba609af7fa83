"""The layer schedulers (``core/scheduler.py``) against each other and
the reference's registry.

The overlapped schedule only changes when the host issues each stage and
when it waits: the quantized params, each layer's report and the
artifact's entries must be the sequential schedule's bit for bit, for
GPTQ and for LDLQ, on a homogeneous stack, on a heterogeneous one (a
dense prefix, then MoE layers) and with an encoder stack before the
decoder (whose last encoder layer propagates).  The registry and the
"auto" choice follow the reference's (``tests/test_scheduler.py``), the
choice by the model's device where the reference's is by backend.
"""
import dataclasses

import pytest
import torch

from repro.core.scheduler import get_scheduler as ref_get_scheduler
from repro_torch.configs import get_config
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.scheduler import (OverlappedScheduler,
                                        SequentialScheduler, get_scheduler)
from repro_torch.device import generator
from repro_torch.models.lm import Model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _assert_same(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def _run(arch: str, sched: str, method: str, n_layers=None, **extra):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, "cpu")
    params = model.init(generator(0, "cpu"))
    g = torch.Generator().manual_seed(1)
    calib = torch.randint(2, cfg.vocab_size, (8, 32), generator=g)
    rsq = RSQConfig(bits=4, group_size=32, method=method, scheduler=sched,
                    pack_output=method == "gptq")
    kw = {k: torch.randn((8,) + shape, generator=g)
          for k, shape in extra.items()}
    pipe = RSQPipeline(model, rsq)
    q, report = pipe.run(params, calib, batch_size=4, **kw)
    return q, report, pipe.artifact


@pytest.mark.parametrize("method", ["gptq", "ldlq"])
@pytest.mark.parametrize("arch,n_layers", [("llama3-8b", 4),
                                           ("deepseek-v2-236b", None)],
                         ids=["homogeneous", "prefix_moe"])
def test_overlapped_bit_identical_to_sequential(arch, n_layers, method):
    q_seq, rep_seq, art_seq = _run(arch, "sequential", method, n_layers)
    q_ovl, rep_ovl, art_ovl = _run(arch, "overlapped", method, n_layers)
    assert rep_seq["scheduler"] == "sequential"
    assert rep_ovl["scheduler"] == "overlapped"
    _assert_same(q_seq, q_ovl)
    assert list(rep_seq["layers"]) == list(rep_ovl["layers"])
    for tag, rep in rep_seq["layers"].items():
        assert rep["weights"] == rep_ovl["layers"][tag]["weights"], tag
        # the sequential schedule times each stage; the overlapped one
        # never waits for the device, so it has no stage times
        assert {"capture_s", "solve_s", "apply_s"} <= set(rep)
        assert "solve_s" not in rep_ovl["layers"][tag]
    if method == "gptq":
        assert list(art_seq["entries"]) == list(art_ovl["entries"])
        _assert_same(art_seq["entries"], art_ovl["entries"])
        assert art_seq["meta"] == art_ovl["meta"]
    else:
        assert art_seq is None and art_ovl is None


def test_overlapped_encoder_decoder_bit_identical():
    """whisper's smoke model: the encoder stack (its last layer
    propagates: its outputs are the decoder's media), then the decoder."""
    shape = (24, get_config("whisper-medium").reduced().d_model)
    q_seq, rep_seq, art_seq = _run("whisper-medium", "sequential", "gptq",
                                   frames=shape)
    q_ovl, rep_ovl, art_ovl = _run("whisper-medium", "overlapped", "gptq",
                                   frames=shape)
    _assert_same(q_seq, q_ovl)
    _assert_same(art_seq["entries"], art_ovl["entries"])
    assert any(tag.startswith("enc") for tag in rep_ovl["layers"])
    for tag, rep in rep_seq["layers"].items():
        assert rep["weights"] == rep_ovl["layers"][tag]["weights"], tag


def test_scheduler_registry_and_auto():
    assert isinstance(get_scheduler("sequential"), SequentialScheduler)
    assert isinstance(get_scheduler("overlapped"), OverlappedScheduler)
    assert isinstance(get_scheduler(None, "cpu"), SequentialScheduler)
    assert isinstance(get_scheduler("auto", torch.device("cpu")),
                      SequentialScheduler)
    assert isinstance(get_scheduler(None, "cuda"), OverlappedScheduler)
    assert isinstance(get_scheduler("auto", "cuda:0"), OverlappedScheduler)
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("warp-speed")
    # the reference's names and errors are the same
    for name in ("sequential", "overlapped"):
        assert ref_get_scheduler(name).name == get_scheduler(name).name
    with pytest.raises(ValueError):
        ref_get_scheduler("warp-speed")


def test_auto_schedule_follows_the_model_device():
    """With no scheduler named, a CPU model runs the sequential schedule
    (the reference's auto on its CPU backend)."""
    _, report, _ = _run("llama3-8b", None, "gptq", 2)
    assert report["scheduler"] == "sequential"
    assert report["rsq"]["scheduler"] is None


@pytest.mark.parametrize("method", ["gptq", "ldlq"])
def test_failed_factorization_raises_at_the_read_back(method):
    """The solves factor H without a host check (``cholesky_ex``), so the
    overlapped schedule never waits on it; a damped H that is not positive
    definite still raises, at the layer's one read-back (and at once from
    the solvers called directly)."""
    from repro_torch.core.gptq import gptq_quantize
    from repro_torch.core.ldlq import ldlq_quantize
    from repro_torch.core.pipeline import (finalize_layer_report,
                                           quantize_layer_weights)

    w = torch.randn((16, 16), generator=torch.Generator().manual_seed(0))
    h = torch.full((16, 16), 5.0) - 4.0 * torch.eye(16)  # eigenvalue -4
    rsq = RSQConfig(method=method, group_size=16)
    with pytest.raises(torch.linalg.LinAlgError):
        quantize_layer_weights({"mixer": {"wq": w}}, {"mixer/wq": h}, rsq)
    _, pending = quantize_layer_weights({"mixer": {"wq": w}},
                                        {"mixer/wq": h}, rsq, defer=True)
    assert pending["info"].tolist() != [0]
    with pytest.raises(torch.linalg.LinAlgError):
        finalize_layer_report(pending["weights"], pending["info"])
    with pytest.raises(torch.linalg.LinAlgError):
        if method == "gptq":
            gptq_quantize(w, h, rsq.spec())
        else:
            ldlq_quantize(w, h)
