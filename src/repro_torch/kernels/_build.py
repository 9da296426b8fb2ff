"""Build a kernel source with ``nvcc`` into a shared library and load it.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled for
Hopper (``sm_90a``) at first use into ``build/torch_kernels/`` at the root
of the checkout.  The library's name carries a hash of the source, the
headers it includes from its own directory and the flags, so an edited
source or header is rebuilt.  Nothing here runs at import time:
the CPU has no ``nvcc``, and the CPU route never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives: ``<stem>-<hash>.so``."""
    text = source.read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, flags=re.M)
    digest = hashlib.sha256(
        text + b"".join(source.with_name(h.decode()).read_bytes()
                        for h in headers)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(sources) -> None:
    """Compile every source whose library is not built yet, one ``nvcc``
    for each, all started together.  The compiler's report (``-Xptxas
    -v``: registers, spills) is kept beside each library as
    ``<name>.log``."""
    jobs = []
    for source in sources:
        path = library_path(source)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        jobs.append((source, path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, path, tmp, proc in jobs:
        out, err = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source.name}:\n{out}{err}")
                continue
            path.with_suffix(".log").write_text(out + err)
            os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path) -> ctypes.CDLL:
    """Load ``source``'s library, compiling it first if it is not built."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
