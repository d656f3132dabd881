"""Build the package's native sources into plain shared libraries and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` is CUDA C++ for ``sm_90a``, built with ``nvcc``;
each ``csrc/<name>.cpp`` is host C++, built with ``g++`` (the HDF5 chunk
codec, ``native/chunkzip.py``). Every source has a plain C interface and
includes no PyTorch header, so one build takes seconds. The library goes to
``build/deepfluoro_tpu_torch/`` at the repository root (listed in
``.gitignore``) when the package sits in a writable checkout, and to the
per-user cache (``$XDG_CACHE_HOME/deepfluoro_tpu_torch``, else
``~/.cache/deepfluoro_tpu_torch``) when it is installed, under a name keyed
by a hash of the source and the flags: it is built at first use after each
source change and reused after that. A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_CXX = "g++"
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_LIBS = ("-lz", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}
# the compiler's output (nvcc with -Xptxas -v: registers, shared memory and
# spills per kernel) of each build this process ran, by source name
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under {}/bin".format(cuda_home))
    return nvcc


def find_cxx() -> str:
    cxx = shutil.which(HOST_CXX)
    if cxx is None:
        raise RuntimeError("host C++ compiler {!r} not found on PATH".format(HOST_CXX))
    return cxx


def build_dir(root: Path = _ROOT) -> Path:
    """``root/build/deepfluoro_tpu_torch`` when ``root``, the package's
    parent directory, is a checkout (it holds ``pyproject.toml``) that this
    user may write; otherwise the per-user cache, since an installed
    package's parent is a site-packages directory."""
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / "deepfluoro_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "deepfluoro_tpu_torch"


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or, for host code, ``csrc/<name>.cpp``."""
    cu = _CSRC / "{}.cu".format(name)
    return cu if cu.exists() else _CSRC / "{}.cpp".format(name)


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_CXX_FLAGS + HOST_LIBS


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return build_dir() / "{}_{}.so".format(name, digest)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) if its
    library is missing, then load it. Raises RuntimeError when the compiler
    is missing or fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        src = source_path(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
        if src.suffix == ".cu":
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        else:  # libraries after the source, as the linker resolves them
            cmd = [find_cxx(), *HOST_CXX_FLAGS, str(src), "-o", str(tmp), *HOST_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("{} failed for {}:\n{}".format(os.path.basename(cmd[0]), name, build_logs[name]))
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
