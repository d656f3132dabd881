"""Import hygiene of the PyTorch port: the package and chip_smoke.py run on
a machine that has torch but no JAX, flax, optax, h5py or PIL, so none of
the JAX stack may be imported, nor anything of the JAX package, and h5py
and PIL only inside the functions that need them."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "deepfluoro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepfluoro_tpu")
LAZY_ONLY = ("h5py", "PIL")


def _imports(node, at_import_time=False):
    """Yield (module name, import node) under ``node``; with
    ``at_import_time`` skip function bodies, which run only when called."""
    for child in ast.iter_child_nodes(node):
        if at_import_time and isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            for alias in child.names:
                yield alias.name.split(".")[0], child
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module.split(".")[0], child
        yield from _imports(child, at_import_time)


def _violations(source):
    tree = ast.parse(source)
    bad = ["line {}: {}".format(n.lineno, m) for m, n in _imports(tree) if m in FORBIDDEN]
    bad += ["line {}: {} at import time".format(n.lineno, m) for m, n in _imports(tree, True) if m in LAZY_ONLY]
    return bad


def test_checker_catches_violations():
    assert _violations("import jax.numpy as jnp") and _violations("from deepfluoro_tpu.ops import image")
    assert _violations("import h5py") and _violations("class A:\n    import h5py")
    assert not _violations("def f():\n    import h5py\n") and not _violations("import deepfluoro_tpu_torch.ops")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_stack_and_lazy_h5py(path):
    assert _violations(path.read_text()) == []


def test_kernel_is_built_with_nvcc_not_torch_extensions():
    assert len(FILES) > 20
    build = (ROOT / "deepfluoro_tpu_torch" / "ops" / "_build.py").read_text()
    assert "nvcc" in build and "sm_90a" in build
    for path in FILES:
        assert "cpp_extension" not in path.read_text(), path


def test_main_path_never_calls_the_yardstick():
    """grid_sample_warp is timed beside the kernel by chip_smoke.py; the
    augmentation and the training loop never reach it."""
    files = sorted((ROOT / "deepfluoro_tpu_torch" / "data").rglob("*.py"))
    files += sorted((ROOT / "deepfluoro_tpu_torch" / "train").rglob("*.py"))
    assert len(files) > 5
    for path in files:
        text = path.read_text()
        assert "grid_sample_warp" not in text and "grid_sample(" not in text, path
