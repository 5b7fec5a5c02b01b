"""Build the port's CUDA kernels and load them with ``ctypes``.

All sources under ``pmpx_torch/csrc/`` go through one ``nvcc`` call into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), written to ``pmpx_torch/_build/``.  The library's name
carries a hash of the sources and flags: an edit to a source builds a new
library at its next use, and an unchanged tree reuses the old one.  The
build runs at the first launch of a kernel, never at import.

Pointers and the stream cross the C boundary as ``c_void_p`` (a plain int
would be cut to 32 bits); each entry point returns the launch's
``cudaError_t``, and :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["Built", "load", "check", "nvcc_path", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pmpx_linreg_rss": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "pmpx_linreg_rss_tile": [],
    "pmpx_fused_chain": (
        [_I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _I, _F, _F, _F, _F, _P]
    ),
}


@dataclasses.dataclass(frozen=True)
class Built:
    """The loaded library, where it lies, and what its build printed
    (``seconds`` is None when an earlier build was reused)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float | None
    log: str


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> tuple[float, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    res = subprocess.run(
        cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
    )
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}{res.stdout}"
        )
    log = res.stderr + res.stdout
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a reader never sees half a library
    return seconds, log


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (if the sources changed) and load the kernel library."""
    so = BUILD_DIR / f"libpmpx_torch_kernels_{_digest()}.so"
    seconds = None
    if so.exists():
        log_file = so.with_suffix(".log")
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmpx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pmpx_cuda_error_string.restype = ctypes.c_char_p
    return Built(lib=lib, path=so, seconds=seconds, log=log)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().lib.pmpx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
