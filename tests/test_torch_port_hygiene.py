"""Import hygiene of the PyTorch port: the package and chip_smoke.py run on
a machine that has torch but no JAX, flax, optax, h5py or vtk, so none of
the JAX stack may be imported, nor anything of the JAX package, and h5py,
PIL and vtk only inside the functions that need them."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "deepfluoro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepfluoro_tpu")
LAZY_ONLY = ("h5py", "PIL", "vtk")


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
    assert _violations("import h5py") and _violations("class A:\n    import h5py") and _violations("import vtk")
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


INFER_EVAL_MODULES = [
    "deepfluoro_tpu_torch.infer",
    "deepfluoro_tpu_torch.infer.ensemble",
    "deepfluoro_tpu_torch.eval",
    "deepfluoro_tpu_torch.eval.dice",
    "deepfluoro_tpu_torch.eval.landmarks",
    "deepfluoro_tpu_torch.cli.test_ensemble",
    "deepfluoro_tpu_torch.cli.est_lands_csv",
    "deepfluoro_tpu_torch.cli.compute_actual_dice_on_test",
    "deepfluoro_tpu_torch.data.preprocess",
    "deepfluoro_tpu_torch.infer.fullres",
    "deepfluoro_tpu_torch.cli.seg_fullres",
    "deepfluoro_tpu_torch.cli.preprocess_full_res",
    "deepfluoro_tpu_torch.infer.quantized",
    "deepfluoro_tpu_torch.ops.int8_conv",
    "deepfluoro_tpu_torch.utils.profiling",
]


TRAINING_MODULES = [
    "deepfluoro_tpu_torch.train",
    "deepfluoro_tpu_torch.train.checkpoint",
    "deepfluoro_tpu_torch.train.loop",
    "deepfluoro_tpu_torch.train.multifold",
    "deepfluoro_tpu_torch.data.pipeline",
    "deepfluoro_tpu_torch.data.hdf5",
    "deepfluoro_tpu_torch.compat.from_jax",
    "deepfluoro_tpu_torch.cli.train",
    "deepfluoro_tpu_torch.cli.train_folds",
    "deepfluoro_tpu_torch.parallel",
    "deepfluoro_tpu_torch.parallel.mesh",
    "deepfluoro_tpu_torch.parallel.multihost",
    "deepfluoro_tpu_torch.parallel.sharding",
]


def _modules_added_by_each_import(modules):
    """The top-level modules each of ``modules`` adds to ``sys.modules``,
    imported one after another in a fresh interpreter."""
    import subprocess
    import sys

    for mod in modules:
        path = ROOT / mod.replace(".", "/")
        assert path.with_suffix(".py") in FILES or path / "__init__.py" in FILES, mod
    code = (
        "import importlib, sys\n"
        "added = {{}}\n"
        "for mod in {!r}:\n"
        "    before = set(sys.modules)\n"
        "    importlib.import_module(mod)\n"
        "    added[mod] = sorted({{m.split('.')[0] for m in set(sys.modules) - before}})\n"
        "print(added)\n"
    ).format(modules)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_inference_and_eval_modules_import_no_jax_stack_or_h5py():
    """The modules of the inference slice and of full-res preprocessing
    and inference load nothing of the JAX stack, nothing of the JAX
    package, and no h5py or PIL (only the modules each import adds
    count)."""
    added = _modules_added_by_each_import(INFER_EVAL_MODULES)
    assert "torch" in added[INFER_EVAL_MODULES[0]]
    for mod, loaded in added.items():
        assert not set(loaded) & set(FORBIDDEN + LAZY_ONLY), (mod, loaded)


def test_training_modules_import_no_jax_stack_or_h5py():
    """The same for the training modules: resume, the streaming feed, the
    async checkpointer, fold training and both training CLIs."""
    added = _modules_added_by_each_import(TRAINING_MODULES)
    assert "torch" in added[TRAINING_MODULES[0]]
    for mod, loaded in added.items():
        assert not set(loaded) & set(FORBIDDEN + LAZY_ONLY), (mod, loaded)


HOST_LEFTOVER_MODULES = [
    "deepfluoro_tpu_torch.native",
    "deepfluoro_tpu_torch.native.chunkzip",
    "deepfluoro_tpu_torch.viz",
    "deepfluoro_tpu_torch.viz.overlays",
    "deepfluoro_tpu_torch.viz.examples",
    "deepfluoro_tpu_torch.viz.projective",
    "deepfluoro_tpu_torch.entry",
    "deepfluoro_tpu_torch.cli.overlay_est_ann",
    "deepfluoro_tpu_torch.cli.overlay_est_heat",
    "deepfluoro_tpu_torch.cli.make_preproc_overlays",
    "deepfluoro_tpu_torch.cli.make_full_res_overlays",
    "deepfluoro_tpu_torch.cli.full_res_3d_viz",
]


def test_host_leftover_modules_import_no_jax_stack_h5py_pil_or_vtk():
    """The codec, the overlays and geometry, their CLIs and the entry
    points load nothing of the JAX stack or package, and no h5py, PIL or
    vtk, when imported (the card's machine has no h5py and no vtk)."""
    added = _modules_added_by_each_import(HOST_LEFTOVER_MODULES)
    assert "torch" in added["deepfluoro_tpu_torch.viz"] and "numpy" in added[HOST_LEFTOVER_MODULES[0]]
    for mod, loaded in added.items():
        assert not set(loaded) & set(FORBIDDEN + LAZY_ONLY), (mod, loaded)


def test_wheel_ships_the_kernel_sources():
    """An installed package builds its kernels from csrc/*.cu and its host
    codec from csrc/*.cpp, so the package data must name them, and the
    globs must match every source."""
    import fnmatch
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert any(fnmatch.fnmatch("deepfluoro_tpu_torch", p) for p in conf["tool"]["setuptools"]["packages"]["find"]["include"])
    globs = conf["tool"]["setuptools"]["package-data"]["deepfluoro_tpu_torch"]
    sources = sorted(p.relative_to(ROOT / "deepfluoro_tpu_torch").as_posix() for p in (ROOT / "deepfluoro_tpu_torch" / "csrc").iterdir())
    assert sources and all(any(fnmatch.fnmatch(s, g) for g in globs) for s in sources), (sources, globs)


@pytest.mark.parametrize("layout", ["writable-checkout", "read-only-checkout", "installed"])
@pytest.mark.parametrize("xdg", [True, False], ids=["xdg-cache-home", "home-cache"])
def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch, layout, xdg):
    """The library goes to build/ of a writable checkout; beside an
    installed package, or in a checkout this user cannot write, to
    $XDG_CACHE_HOME/deepfluoro_tpu_torch, else ~/.cache/deepfluoro_tpu_torch.
    Nothing is built."""
    import os

    from deepfluoro_tpu_torch.ops import _build

    root = tmp_path / "root"
    root.mkdir()
    if layout != "installed":
        (root / "pyproject.toml").write_text("[project]\n")
    if layout == "read-only-checkout":
        real_access = os.access
        monkeypatch.setattr(_build.os, "access", lambda p, mode: False if pathlib.Path(p) == root else real_access(p, mode))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    want = {
        "writable-checkout": root / "build" / "deepfluoro_tpu_torch",
        "read-only-checkout": tmp_path / ("xdg" if xdg else "home/.cache") / "deepfluoro_tpu_torch",
        "installed": tmp_path / ("xdg" if xdg else "home/.cache") / "deepfluoro_tpu_torch",
    }[layout]
    assert _build.build_dir(root) == want
    assert not (tmp_path / "xdg").exists() and not (tmp_path / "home").exists() and not (root / "build").exists()
    assert _build.build_dir() == _build._ROOT / "build" / "deepfluoro_tpu_torch"
