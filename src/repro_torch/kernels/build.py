"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library (no PyTorch headers: seconds per build, not
minutes).  The library lands in ``<repo>/build/repro_torch/<name>-<key>/``
(``build/`` is git-ignored; ``REPRO_TORCH_BUILD_DIR`` overrides the root),
where ``<key>`` hashes the source, the shared headers (``csrc/*.cuh``) and
the flags — a changed source or header builds anew, an unchanged one is
loaded as it is.

Nothing here runs at import time: this machine may have no ``nvcc`` and
no card, and the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas=-v"]
BUILD_TIMEOUT_S = 600


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the port's kernels are built on the machine with "
                       "the card")


def source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return src


def library_path(name: str) -> Path:
    """Where the named library lands: the key hashes the flags, the source
    and every shared header of ``csrc/`` (a source may include any of
    them), so a changed header builds anew too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source(name).read_bytes())
    for header in sorted(source(name).parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return build_root() / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Build the named kernel library unless it is built already, and
    return its path.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside the library as ``build.log``.
    Raises if ``nvcc`` fails."""
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        p = subprocess.run([nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                                    str(source(name))],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=BUILD_TIMEOUT_S)
        (so.parent / "build.log").write_text(p.stdout)
        if p.returncode != 0:
            raise RuntimeError(f"kernel build of {name} failed: nvcc exited "
                               f"{p.returncode}\n{p.stdout}")
        os.replace(tmp, so)            # atomic: a reader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_log(name: str) -> str:
    p = library_path(name).parent / "build.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
