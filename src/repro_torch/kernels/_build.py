"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``kernels/_build/`` (listed in ``.gitignore``).  The library's file name
carries a digest of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing is built when
the module is imported: the CPU tests import every module on machines
without ``nvcc``.

:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them — the way a run that needs every kernel should build them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def kernel_sources() -> List[str]:
    """Names of every kernel source under ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the GPU")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, Path(tmp), proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel whose library is missing, one ``nvcc`` per
    source started together.  Returns ``{name: compiler output}`` for
    the ones it built (``-Xptxas -v``: registers, spills, shared memory)."""
    names = kernel_sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    logs = {}
    try:
        for n, out, tmp, proc in started:
            logs[n] = _finish(n, out, tmp, proc)
    finally:
        for _, _, tmp, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    if not library_path(name).exists():
        build_all([name])
    return ctypes.CDLL(str(library_path(name)))
