"""Build the port's CUDA kernels and load them with ``ctypes``.

Each source under ``pmpx_torch/csrc/`` is compiled by its own ``nvcc -c``,
all started together, and one more ``nvcc`` links the objects into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), written to ``pmpx_torch/_build/``.  The library's name
carries a hash of the sources and flags: an edit to a source builds a new
library at its next use, and an unchanged tree reuses the old one.  The
build runs at the first launch of a kernel, never at import.

``load(stamps=True)`` builds a second library, only when asked: the chain
kernels of ``csrc/fused_chain.cu`` compiled with ``-DPMPX_CHAIN_STAMPS``,
which laps the SM clock at each phase of a superstep and exports
``pmpx_chain_stamps`` to read the sums after a launch.  The define is in
that library's hash; the default library never has it.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# the stamped library: its define, and the one source it compiles
STAMP_FLAGS = ("-DPMPX_CHAIN_STAMPS",)
STAMP_SOURCE = "fused_chain.cu"
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pmpx_linreg_rss": [_P, _P, _P, _P, _P, _I, _I, _P],
    "pmpx_linreg_rss_info": [_I, _I, _P],
    "pmpx_fused_chain": (
        [_I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _I, _F, _F, _F, _F, _P]
    ),
    "pmpx_lstm_fused": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pmpx_tree_positions": [_P, _P, _P, _I, _I, _I, _F, _P],
    "pmpx_tree_positions_inplace": [_P, _P, _I, _I, _I, _F, _P],
    "pmpx_tree_select": [_P] * 10 + [_I] * 6 + [_P],
    "pmpx_mamba2_ssd": [_P] * 7 + [_I] * 6 + [_P, _P],
}
_STAMP_SIGNATURES = {
    "pmpx_fused_chain": _SIGNATURES["pmpx_fused_chain"],
    "pmpx_chain_stamps": [_P, _P],
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


def _sources(stamps: bool = False) -> list[Path]:
    if stamps:
        return [CSRC / STAMP_SOURCE] + sorted(CSRC.glob("*.cuh"))
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _flags(stamps: bool) -> tuple:
    return NVCC_FLAGS + STAMP_FLAGS if stamps else NVCC_FLAGS


def _digest(stamps: bool = False) -> str:
    h = hashlib.sha256(" ".join(_flags(stamps) + LINK_FLAGS).encode())
    for src in _sources(stamps):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list) -> str:
    """Wait for every started ``nvcc``; raise on the first that failed."""
    logs, failed = [], None
    for cmd, proc in procs:
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        logs.append(err + out)
        if proc.returncode != 0 and failed is None:
            failed = RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{err}{out}"
            )
    if failed is not None:
        raise failed
    return "".join(logs)


def _start(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _compile(so: Path, stamps: bool) -> tuple[float, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    cu = [s for s in _sources(stamps) if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run([_start([nvcc_path(), *_flags(stamps), "-c", "-o",
                            str(obj), str(src)])
                    for src, obj in zip(cu, objs)])
        log += _run([_start([nvcc_path(), *LINK_FLAGS, "-o", str(tmp),
                             *map(str, objs)])])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a reader never sees half a library
    return seconds, log


@functools.lru_cache(maxsize=None)
def load(stamps: bool = False) -> Built:
    """Build (if the sources changed) and load the kernel library, or with
    ``stamps`` the stamped chain library (module docstring)."""
    stem = "libpmpx_torch_chain_stamps" if stamps else "libpmpx_torch_kernels"
    so = BUILD_DIR / f"{stem}_{_digest(stamps)}.so"
    seconds = None
    if so.exists():
        log_file = so.with_suffix(".log")
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _compile(so, stamps)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in (_STAMP_SIGNATURES if stamps
                           else _SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if not stamps:
        lib.pmpx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pmpx_cuda_error_string.restype = ctypes.c_char_p
    return Built(lib=lib, path=so, seconds=seconds, log=log)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().lib.pmpx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
