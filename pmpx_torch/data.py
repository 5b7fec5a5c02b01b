"""MNIST and CIFAR-10 loading with a deterministic synthetic fallback (port
of ``pmpx/data.py``).

Loaders look for data on disk under ``$PMPX_DATA_DIR`` (default
``./data``), in the formats ``pmpx`` reads:

* ``mnist.npz`` / ``cifar10.npz`` with ``x_train/y_train/x_test/y_test``
  arrays;
* the MNIST IDX files torchvision leaves in ``MNIST/raw/``
  (``train-images-idx3-ubyte`` etc., plain or ``.gz``), also accepted
  directly in the data dir;
* the CIFAR-10 python pickle batches torchvision leaves in
  ``cifar-10-batches-py/`` (``data_batch_1..5``, ``test_batch``).

A file that is present but malformed fails loudly: it never falls back to
the synthetic stand-in.  Without data on disk, the loaders draw a
learnable stand-in with the dataset's shapes: class-prototype images plus
unit noise.  The law is ``pmpx``'s (``_synthetic_images``); the numbers
come from ``numpy.random.default_rng(seed)`` and are not ``pmpx``'s JAX
stream.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np
import torch

from pmpx_torch._device import resolve_device

__all__ = ["load_mnist", "load_cifar10", "dataset_presence"]

_IDX_NAMES = (
    "train-images-idx3-ubyte",
    "train-labels-idx1-ubyte",
    "t10k-images-idx3-ubyte",
    "t10k-labels-idx1-ubyte",
)
_MNIST_MEAN, _MNIST_STD = 0.1307, 0.3081


def _data_dir() -> str:
    return os.environ.get("PMPX_DATA_DIR", "./data")


def _try_npz(name: str):
    path = os.path.join(_data_dir(), name)
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
    except Exception as e:
        raise ValueError(
            f"{path}: not a readable npz archive ({e}); re-download or "
            f"regenerate it, or remove it to use the synthetic stand-in"
        ) from e
    keys = ("x_train", "y_train", "x_test", "y_test")
    missing = [k for k in keys if k not in z.files]
    if missing:
        raise ValueError(
            f"{path}: missing arrays {missing}; pmpx npz datasets need "
            f"all of {list(keys)} (found {z.files})"
        )
    x_tr, y_tr, x_te, y_te = (z[k] for k in keys)
    for split, x, y in (("train", x_tr, y_tr), ("test", x_te, y_te)):
        if len(x) != len(y):
            raise ValueError(
                f"{path}: x_{split} has {len(x)} images but y_{split} "
                f"has {len(y)} labels"
            )
    return x_tr, y_tr, x_te, y_te


def _read_idx(path: str) -> np.ndarray:
    """Parse one IDX-format file: magic ``0x00 0x00 <dtype> <ndim>``, then
    ``ndim`` big-endian u32 dims, then the raw u8 array.  Anything else is
    rejected loudly rather than misparsed."""
    opener = gzip.open if path.endswith(".gz") else open

    def read_exact(f, n, what):
        try:
            buf = f.read(n)
        except (OSError, EOFError) as e:
            raise ValueError(
                f"{path}: unreadable {what} ({e}); the file is likely a "
                f"truncated or corrupt download — re-fetch it"
            ) from e
        if len(buf) != n:
            raise ValueError(
                f"{path}: truncated {what} (wanted {n} bytes, got "
                f"{len(buf)}); re-download the file"
            )
        return buf

    with opener(path, "rb") as f:
        zero, dtype, ndim = struct.unpack(
            ">HBB", read_exact(f, 4, "IDX magic header")
        )
        if zero != 0 or dtype != 0x08:
            raise ValueError(
                f"{path}: not a u8 IDX file "
                f"(magic {zero:#06x} dtype {dtype:#04x})"
            )
        dims = struct.unpack(
            f">{ndim}I", read_exact(f, 4 * ndim, "IDX dimension header")
        )
        try:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        except (OSError, EOFError) as e:
            raise ValueError(
                f"{path}: unreadable payload ({e}); truncated or corrupt "
                f"download — re-fetch it"
            ) from e
    if data.size != int(np.prod(dims)):
        raise ValueError(
            f"{path}: payload has {data.size} bytes but the header "
            f"promises dims {tuple(dims)} = {int(np.prod(dims))}; the "
            f"file is truncated or corrupt — re-download it"
        )
    return data.reshape(dims)


def _find_idx(name: str):
    """An MNIST IDX file in the data dir or torchvision's ``MNIST/raw/``,
    plain or gzipped."""
    for sub in ("", "MNIST/raw"):
        for ext in ("", ".gz"):
            p = os.path.join(_data_dir(), sub, name + ext)
            if os.path.exists(p):
                return p
    return None


def _try_mnist_idx():
    paths = [_find_idx(n) for n in _IDX_NAMES]
    if any(p is None for p in paths):
        return None
    x_tr, y_tr, x_te, y_te = (_read_idx(p) for p in paths)
    for split, x, y, xp, yp in (
        ("train", x_tr, y_tr, paths[0], paths[1]),
        ("test", x_te, y_te, paths[2], paths[3]),
    ):
        if x.ndim != 3:
            raise ValueError(
                f"{xp}: expected a 3-D image tensor (N, rows, cols), got "
                f"header dims {x.shape} — is this really the MNIST "
                f"{split}-images file?"
            )
        if y.ndim != 1:
            raise ValueError(
                f"{yp}: expected a 1-D label vector, got header dims "
                f"{y.shape} — is this really the MNIST {split}-labels "
                f"file?"
            )
        if len(x) != len(y):
            raise ValueError(
                f"MNIST {split} split mismatch: {xp} has {len(x)} images "
                f"but {yp} has {len(y)} labels — the files are from "
                f"different downloads or one is truncated"
            )
    return x_tr, y_tr, x_te, y_te


def dataset_presence() -> dict:
    """Which real-dataset formats the loaders would find right now, probed
    on the paths they read (the keys of ``pmpx``'s, CIFAR-10's included)."""
    d = _data_dir()
    cifar_root = os.path.join(d, "cifar-10-batches-py")
    return {
        "data_dir": d,
        "mnist_npz": os.path.exists(os.path.join(d, "mnist.npz")),
        "mnist_idx": all(_find_idx(n) is not None for n in _IDX_NAMES),
        "cifar10_npz": os.path.exists(os.path.join(d, "cifar10.npz")),
        "cifar10_batches": all(
            os.path.exists(os.path.join(cifar_root, n))
            for n in [f"data_batch_{i}" for i in range(1, 6)]
            + ["test_batch"]
        ),
    }


def _synthetic(seed: int, n_train: int, n_test: int, class_sep: float,
               classes: int = 10, shape=(28, 28)):
    """Class prototypes x ``class_sep`` plus unit noise, uniform labels."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((classes,) + shape, np.float32) * class_sep
    y_tr = rng.integers(0, classes, n_train)
    y_te = rng.integers(0, classes, n_test)
    x_tr = protos[y_tr] + rng.standard_normal((n_train,) + shape, np.float32)
    x_te = protos[y_te] + rng.standard_normal((n_test,) + shape, np.float32)
    return x_tr, y_tr, x_te, y_te


def _flip_labels(y: np.ndarray, frac: float, rng, classes: int = 10):
    """Replace a ``frac`` fraction of labels with uniform random ones: a
    ceiling below 100% on every sampler's accuracy."""
    flip = rng.random(y.shape) < frac
    return np.where(flip, rng.integers(0, classes, y.shape), y)


def load_mnist(
    n_train: int = 60000,
    n_test: int = 10000,
    seed: int = 0,
    class_sep: float = 1.5,
    label_noise: float = 0.0,
    device=None,
):
    """(x_train, y_train, x_test, y_test) on ``device`` (CUDA unless
    given): images (N, 28, 28) float32, normalised; labels int64.

    Reads ``mnist.npz`` or the IDX files from the data dir when present
    (normalised with MNIST's mean 0.1307 and std 0.3081, then sliced to
    ``n_train``/``n_test``), else draws the synthetic stand-in
    (``class_sep`` sets its difficulty).  ``label_noise`` flips that
    fraction of train and test labels, drawn from ``seed + 7919``.
    """
    dev = resolve_device(device)
    found = _try_npz("mnist.npz") or _try_mnist_idx()
    if found is not None:
        x_tr, y_tr, x_te, y_te = found
        norm = lambda x: (  # noqa: E731
            (x.astype(np.float32) / np.float32(255.0)
             - np.float32(_MNIST_MEAN)) / np.float32(_MNIST_STD))
        x_tr, x_te = norm(x_tr[:n_train]), norm(x_te[:n_test])
        y_tr, y_te = y_tr[:n_train], y_te[:n_test]
    else:
        x_tr, y_tr, x_te, y_te = _synthetic(seed, n_train, n_test, class_sep)
    return _finish((x_tr, y_tr, x_te, y_te), label_noise, seed, dev)


def _finish(data, label_noise: float, seed: int, dev):
    """Label noise (drawn from ``seed + 7919``), then the arrays on
    ``dev``: images float32, labels int64."""
    x_tr, y_tr, x_te, y_te = data
    if label_noise > 0.0:
        rng = np.random.default_rng(seed + 7919)
        y_tr = _flip_labels(y_tr, label_noise, rng)
        y_te = _flip_labels(y_te, label_noise, rng)
    as_x = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    as_y = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int64)).to(dev)
    return as_x(x_tr), as_y(y_tr), as_x(x_te), as_y(y_te)


def _try_cifar_batches():
    """torchvision's on-disk CIFAR-10: ``cifar-10-batches-py/`` python
    pickles with ``data`` (N, 3072) u8 rows in CHW order and ``labels``."""
    root = os.path.join(_data_dir(), "cifar-10-batches-py")
    train_names = [f"data_batch_{i}" for i in range(1, 6)]
    if not all(os.path.exists(os.path.join(root, n))
               for n in train_names + ["test_batch"]):
        return None

    def read(name):
        p = os.path.join(root, name)
        try:
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
        except Exception as e:
            raise ValueError(
                f"{p}: not a readable CIFAR-10 pickle batch ({e}); the "
                f"file is likely truncated or corrupt: re-download it"
            ) from e
        if not isinstance(d, dict) or b"data" not in d or b"labels" not in d:
            keys = list(d.keys()) if isinstance(d, dict) else type(d)
            raise ValueError(
                f"{p}: CIFAR-10 batch pickles must be dicts with b'data' "
                f"and b'labels' keys (found {keys})"
            )
        x = np.asarray(d[b"data"], dtype=np.uint8)
        if x.ndim != 2 or x.shape[1] != 3072:
            raise ValueError(
                f"{p}: b'data' rows must be 3072-byte CHW images, got "
                f"shape {x.shape}"
            )
        y = np.asarray(d[b"labels"], dtype=np.int64)
        if len(x) != len(y):
            raise ValueError(f"{p}: {len(x)} image rows but {len(y)} labels")
        return x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), y  # NHWC

    parts = [read(n) for n in train_names]
    x_te, y_te = read("test_batch")
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), x_te, y_te)


def load_cifar10(
    n_train: int = 50000,
    n_test: int = 10000,
    seed: int = 1,
    class_sep: float = 1.5,
    label_noise: float = 0.0,
    device=None,
):
    """(x_train, y_train, x_test, y_test) on ``device`` (CUDA unless
    given): images (N, 32, 32, 3) float32 (NHWC, pixels / 255 as
    ``pmpx`` scales them), labels int64.

    Reads ``cifar10.npz`` or torchvision's ``cifar-10-batches-py/`` pickles
    from the data dir when present (sliced to ``n_train``/``n_test``), else
    draws the synthetic stand-in of shape (32, 32, 3) from
    ``numpy.random.default_rng(seed)``.  ``label_noise`` flips that
    fraction of train and test labels, drawn from ``seed + 7919``.
    """
    dev = resolve_device(device)
    found = _try_npz("cifar10.npz") or _try_cifar_batches()
    if found is not None:
        x_tr, y_tr, x_te, y_te = found
        scale = lambda x: x.astype(np.float32) / np.float32(255.0)  # noqa
        data = (scale(x_tr[:n_train]), y_tr[:n_train],
                scale(x_te[:n_test]), y_te[:n_test])
    else:
        data = _synthetic(seed, n_train, n_test, class_sep,
                          shape=(32, 32, 3))
    return _finish(data, label_noise, seed, dev)
