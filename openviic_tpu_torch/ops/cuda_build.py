"""Build the CUDA sources under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries go to ``openviic_tpu_torch/_build/``, named by a
hash of the sources and flags, at first use; ``build`` starts one nvcc per
source, all at once, and waits for them.  Nothing here runs at import."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        if path.suffix == ".cuh" or path.stem == name:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, or
    all of them with ``force``; one nvcc process each, started together.
    Returns each compiled source's ptxas report; raises if any fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
