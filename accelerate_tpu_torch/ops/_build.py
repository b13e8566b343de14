"""Builds the port's CUDA sources (``ops/csrc/*.cu``) and loads them with ctypes.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, for ``sm_90a`` (Hopper; the ``a`` keeps ``wgmma`` and
``setmaxnreg`` available). No PyTorch header is included, which keeps a
build to seconds. Libraries land in ``accelerate_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one is reused. The build happens at first use, never at
import. A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def _library_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` builds to (keyed by every csrc file and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one nvcc process per source, all started together. Each
    build's compiler output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as log_file:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                    stdout=log_file, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, out, log))
    failures = []
    for name, proc, tmp, out, log in running:
        if proc.wait() != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: _library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build([name])[name]))
    return _libraries[name]
