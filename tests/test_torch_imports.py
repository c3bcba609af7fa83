"""Static checks of the port's boundary, by reading the sources (AST):
no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
anything of the JAX reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_found():
    assert len(SOURCES) > 20 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("module", [
    "kernels/flash_decode/ops.py", "kernels/flash_decode/ref.py",
    "kernels/flash_decode/kernel.py", "serving/engine.py",
    "serving/paged.py", "serving/trace.py", "serving/sampling.py",
    "runtime/fault.py"])
def test_quantized_kv_serving_modules_are_checked(module):
    """The quantized-KV serving slice's modules are among the sources the
    boundary check reads."""
    assert ROOT / "src" / "repro_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "kernels/quant_matmul/ops.py", "kernels/quant_matmul/ref.py",
    "kernels/quant_matmul/kernel.py", "configs/deepseek_v3_671b.py",
    "models/attention.py", "checkpoint/packed.py", "convert.py"])
def test_mla_modules_are_checked(module):
    """The MLA slice's modules are among the sources the boundary check
    reads."""
    assert ROOT / "src" / "repro_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "kernels/hadamard/__init__.py", "kernels/hadamard/ops.py",
    "kernels/hadamard/ref.py", "kernels/hadamard/kernel.py"])
def test_hadamard_modules_are_checked(module):
    """The fast Walsh-Hadamard transform's modules are among the sources the
    boundary check reads."""
    assert ROOT / "src" / "repro_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "kernels/gptq_block/__init__.py", "kernels/gptq_block/ops.py",
    "kernels/gptq_block/ref.py", "kernels/gptq_block/kernel.py",
    "core/expansion.py", "core/importance.py", "core/gptq.py"])
def test_calibration_modules_are_checked(module):
    """The batched solve's kernel, the strategies and dataset expansion are
    among the sources the boundary check reads."""
    assert ROOT / "src" / "repro_torch" / module in SOURCES


@pytest.mark.parametrize("module", [
    "kernels/ldlq_block/__init__.py", "kernels/ldlq_block/ops.py",
    "kernels/ldlq_block/ref.py", "kernels/ldlq_block/kernel.py",
    "core/ldlq.py", "core/scheduler.py", "core/resume.py",
    "checkpoint/checkpoint.py"])
def test_ldlq_schedule_resume_modules_are_checked(module):
    """LDLQ's kernel, the layer schedulers and resumable quantization are
    among the sources the boundary check reads."""
    assert ROOT / "src" / "repro_torch" / module in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
