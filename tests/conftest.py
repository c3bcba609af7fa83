import dataclasses
import warnings

import jax
import pytest

from repro.configs import get_config


def pytest_configure(config):
    # XLA:CPU cannot donate buffers across executions, so every
    # donate_argnums jit (fused calibration step, scan decode) emits
    # "Some donated buffers were not usable" on CPU test runs.  Donation
    # is a no-op there, not a bug — silence the known-harmless noise.
    warnings.filterwarnings(
        "ignore", message="Some donated buffers were not usable")
    config.addinivalue_line(
        "filterwarnings",
        "ignore:Some donated buffers were not usable")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips without one")


@pytest.fixture(scope="session")
def tiny_cfg():
    return dataclasses.replace(
        get_config("llama3-8b").reduced(), dtype="float32",
        n_layers=2, d_model=64, vocab_size=256)


@pytest.fixture(scope="session")
def tiny_model_params(tiny_cfg):
    from repro.models import build_model

    model = build_model(tiny_cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    return model, params
