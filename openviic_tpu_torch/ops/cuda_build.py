"""Build the CUDA sources under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries go to ``openviic_tpu_torch/_build/``, or to the
build cache that ``utils.compile_cache`` sets (``set_build_dir``), named by
a hash of the sources and flags, at first use; ``build`` starts one nvcc
per source, all at once, and waits for them.  Each library is written to a
temporary name and renamed into place, so a process that shares the
directory never loads a half-written one.  ``defines`` (``-D`` flags) build a
variant of a source for measurement; the port's own libraries take none.
Nothing here runs at import."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_loaded: Dict[tuple, ctypes.CDLL] = {}
_build_dir: Optional[Path] = None  # the build cache, when one is set


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (None: ``BUILD_DIR``)."""
    global _build_dir
    _build_dir = None if path is None else Path(path)


def cache_dir() -> Optional[Path]:
    """The directory that ``set_build_dir`` set (None: none is set)."""
    return _build_dir


def build_dir() -> Path:
    """Where libraries are built and loaded from."""
    return BUILD_DIR if _build_dir is None else _build_dir


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        if path.suffix == ".cuh" or path.stem == name:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False,
          defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, or
    all of them with ``force``, each with the ``-D`` flags ``defines``; one
    nvcc process each, started together.  Returns each compiled source's
    ptxas report; raises if any fails."""
    names = list(sources() if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = None  # looked for only when a library must be compiled
    procs = {}
    for name in names:
        out = library_path(name, defines)
        if out.exists() and not force:
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        details = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    key = (name, *defines)
    lib = _loaded.get(key)
    if lib is None:
        path = library_path(name, defines)
        if not path.exists():
            build([name], defines=defines)
        lib = _loaded[key] = ctypes.CDLL(str(path))
    return lib


def current_stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``, as an int."""
    import torch

    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
