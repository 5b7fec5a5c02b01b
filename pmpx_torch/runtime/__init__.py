"""ctypes bindings for the native runtime (port of ``pmpx/runtime``).

The port keeps its own copy of the C++ source (``pmpx_rt.cpp``, a plain C
interface with no framework code).  At its first use, ``g++`` builds it
into ``pmpx_torch/_build/``, under a name that carries a hash of the
source and flags, so an edit builds a new library.  Where no compiler is
found, or the build fails, every facility falls back to ``pmpx``'s NumPy
implementation (:func:`native_available` says which one runs).  The files
are ``pmpx``'s: a trace or float file written by either package reads back
bit-equal through the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "TraceWriter",
    "autocov",
    "build",
    "discrete_sample",
    "mean_std",
    "native_available",
    "read_floats",
    "read_trace",
]

SOURCE = Path(__file__).resolve().parent / "pmpx_rt.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
BUILD_TIMEOUT_S = 300
_MAGIC = b"PMPX"
_HEADER_BYTES = 16  # magic, uint32 width, uint64 reserved

_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rt_read_floats": (ctypes.c_longlong,
                       [ctypes.c_char_p, _FP, ctypes.c_longlong]),
    "rt_trace_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_uint32]),
    "rt_trace_append": (None, [ctypes.c_void_p, _FP]),
    "rt_trace_flush": (ctypes.c_longlong, [ctypes.c_void_p]),
    "rt_trace_close": (ctypes.c_longlong, [ctypes.c_void_p]),
    "rt_trace_read": (ctypes.c_longlong,
                      [ctypes.c_char_p, _FP, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_uint32)]),
    "rt_discrete_sample": (None, [_DP, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_uint64]),
    "rt_autocov": (None, [_FP, ctypes.c_longlong, _DP, ctypes.c_int]),
    "rt_mean_std": (None, [_FP, ctypes.c_longlong, _DP, _DP]),
}


def library_path() -> Path:
    """Where the library of this source and these flags lies."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpmpx_torch_rt_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the library with ``g++`` (or ``c++``) unless it is built
    (``force=True`` compiles it again); True when it is there.  Concurrent
    builds each write their own file and rename it into place, so a
    process that has the old file loaded keeps it."""
    so = library_path()
    if so.exists() and not force:
        return True
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    if not build():
        return None
    lib = ctypes.CDLL(str(library_path()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def read_floats(path: str) -> np.ndarray:
    """Fast whitespace/comma-separated float file reader (the reference's
    ``get_data`` txt format, ``conv_mp.cu:62-79``) -> float32 (n,)."""
    lib = _load()
    if lib is None:
        # match the native parser's tolerance of comma separators
        with open(path) as f:
            toks = f.read().replace(",", " ").split()
        return np.asarray(toks, dtype=np.float32)
    n = lib.rt_read_floats(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty(n, np.float32)
    got = lib.rt_read_floats(path.encode(), _fptr(out), n)
    return out[:got]


class TraceWriter:
    """Crash-resilient per-iteration trace streaming (the reference streams
    beta0/beta1/sigma/time per iteration to txt from the host loop,
    ``conv_mp.cu:283-289``; this is the binary, background-thread version).
    Falls back to buffered NumPy writes when the native library is absent.
    """

    def __init__(self, path: str, width: int):
        self.path = path
        self.width = int(width)
        self._lib = _load()
        self._rows = 0
        if self._lib is not None:
            self._h = self._lib.rt_trace_open(path.encode(), self.width)
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._buf = []

    def append(self, row) -> None:
        row = np.ascontiguousarray(row, np.float32)
        if row.size != self.width:
            raise ValueError(f"a row of {row.size} floats in a trace of "
                             f"width {self.width}")
        self._rows += 1
        if self._lib is not None:
            self._lib.rt_trace_append(self._h, _fptr(row))
        else:
            self._buf.append(row.copy())

    def flush(self) -> int:
        if self._lib is not None:
            return int(self._lib.rt_trace_flush(self._h))
        self._np_write()
        return self._rows

    def close(self) -> int:
        if self._lib is not None:
            return int(self._lib.rt_trace_close(self._h))
        self._np_write()
        return self._rows

    def _np_write(self):
        arr = (np.stack(self._buf) if self._buf
               else np.zeros((0, self.width), np.float32))
        with open(self.path, "wb") as f:
            f.write(_MAGIC)
            f.write(np.uint32(self.width).tobytes())
            f.write(np.uint64(0).tobytes())
            f.write(arr.astype(np.float32).tobytes())


def read_trace(path: str) -> np.ndarray:
    """Read a TraceWriter file -> (rows, width) float32; a partial last
    row (a crash mid-write) is dropped."""
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise IOError(f"{path}: not a pmpx trace")
            width = int(np.frombuffer(f.read(4), np.uint32)[0])
            f.read(8)
            data = np.frombuffer(f.read(), np.float32)
        rows = data.size // width
        return data[: rows * width].reshape(rows, width)
    # width >= 1, so the rows fit in as many floats as the file holds
    cap = max(os.path.getsize(path) - _HEADER_BYTES, 0) // 4
    out = np.empty(max(cap, 1), np.float32)
    width = ctypes.c_uint32()
    rows = lib.rt_trace_read(path.encode(), _fptr(out), cap,
                             ctypes.byref(width))
    if rows < 0:
        raise IOError(f"{path}: not a pmpx trace")
    return out[: rows * width.value].reshape(rows, width.value)


def discrete_sample(weights: np.ndarray, n_draws: int, seed: int
                    ) -> np.ndarray:
    """mt19937 + std::discrete_distribution draws (the reference's host
    resampler, ``conv_mp.cu:253-259``); the NumPy fallback draws from the
    same distribution with another generator."""
    weights = np.ascontiguousarray(weights, np.float64)
    lib = _load()
    if lib is None:
        rng = np.random.default_rng(seed)
        p = weights / weights.sum()
        return rng.choice(len(weights), size=n_draws, p=p).astype(np.int32)
    out = np.empty(n_draws, np.int32)
    lib.rt_discrete_sample(
        weights.ctypes.data_as(_DP), len(weights),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_draws, seed)
    return out


def autocov(x: np.ndarray, maxlag: int) -> np.ndarray:
    """Direct-sum autocovariance oracle (float64 accumulation), lags
    0..maxlag."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        xc = x.astype(np.float64) - x.mean()
        n = len(x)
        return np.array(
            [np.dot(xc[: n - k], xc[k:]) / n for k in range(maxlag + 1)])
    out = np.empty(maxlag + 1, np.float64)
    lib.rt_autocov(_fptr(x), len(x), out.ctypes.data_as(_DP), maxlag)
    return out


def mean_std(x: np.ndarray):
    """(mean, population std) with float64 accumulation
    (``conv_mp.cu:38-53``)."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return float(x.mean()), float(x.std())
    m = ctypes.c_double()
    s = ctypes.c_double()
    lib.rt_mean_std(_fptr(x), len(x), ctypes.byref(m), ctypes.byref(s))
    return m.value, s.value
