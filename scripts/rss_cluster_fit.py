"""Time ``linreg_rss`` at every cluster size and fit its launch's prices.

``pmpx_torch/csrc/linreg_rss.cu`` picks the cluster size of its launch by
pricing each size (``geometry()``: ``kPairNs`` a pair on one SM, and
``kClusterNs`` for a cluster of more than one block).  This script builds
that source into a library of its own with one more entry point, which
launches at a cluster size the caller names; it times every size whose
clusters the card holds at once, at each (P, n) of ``SHAPES`` (a CUDA
graph of 200 calls, ``pmpx_torch.bench.graph_us``), checks each against
the plain version, and fits by least squares

    us = fixed + kPairNs * kPPT * ceil(n / cs) / 1e3
               + kClusterNs * (cs > 1) / 1e3.

It prints one JSON line per (P, n, cs), with the size the shipped
``geometry()`` picks marked, and a last line with the fit.  Its library
goes to ``pmpx_torch/_build/``.  On a machine with a CUDA card, from the
root of the repo:

    python scripts/rss_cluster_fit.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pmpx_torch import _build  # noqa: E402
from pmpx_torch.bench import graph_us, rss_inputs  # noqa: E402
from pmpx_torch.kernels.linreg import (  # noqa: E402
    batched_rss_ref, kernel_info,
)

SHAPES = [(P, n) for P in (8, 64, 512, 1024)
          for n in (500, 16_384, 100_000, 250_000)]
KPPT = 8  # the source's kPPT: proposals a cluster
SHIM = """#include "linreg_rss.cu"

extern "C" int rss_fit_at(const float* b0, const float* b1, const float* x,
                          const float* y, float* out, int P, int n, int cs,
                          void* stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry geo = {(P + kPPT - 1) / kPPT, cs, resident_clusters(dev, cs)};
  return static_cast<int>(launch(geo, b0, b1, x, y, out, P, n,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int rss_fit_resident(int cs) {
  int dev = 0;
  if (current_device(&dev) != cudaSuccess) return -1;
  return resident_clusters(dev, cs);
}
"""


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "rss_cluster_fit.cu"
    so = _build.BUILD_DIR / "librss_cluster_fit.so"
    src.write_text(SHIM)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.rss_fit_at.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, P_]
    lib.rss_fit_resident.argtypes = [I_]
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rss_cluster_fit: no CUDA device")
    lib = build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    rows = []
    for P, n in SHAPES:
        t, b0, b1 = rss_inputs(P, n, dev)
        Pp = b0.shape[0]
        clusters = -(-Pp // KPPT)
        want = batched_rss_ref(b0, b1, t.x2d, t.y2d, n_valid=n)
        scale = want.abs().max().item()
        picked = kernel_info(Pp, n)["cluster_size"]
        for cs in range(1, 9):
            if clusters * cs > sms or clusters > lib.rss_fit_resident(cs):
                continue
            out = torch.empty_like(want)

            def call(cs=cs, out=out):
                _build.check(lib.rss_fit_at(
                    b0.data_ptr(), b1.data_ptr(), t.x2d.data_ptr(),
                    t.y2d.data_ptr(), out.data_ptr(), Pp, n, cs,
                    torch.cuda.current_stream().cuda_stream), "rss_fit_at")

            row = {"P": P, "n": n, "clusters": clusters, "cluster_size": cs,
                   "picked": cs == picked, "device_us": graph_us(call),
                   "rel_err": (out - want).abs().max().item() / scale,
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    A = np.array([[1.0, KPPT * -(-r["n"] // r["cluster_size"]) / 1e3,
                   float(r["cluster_size"] > 1) / 1e3] for r in rows])
    us = np.array([r["device_us"] for r in rows])
    (fixed, pair_ns, cluster_ns), *_ = np.linalg.lstsq(A, us, rcond=None)
    best = {}
    for r in rows:
        key = (r["P"], r["n"])
        if key not in best or r["device_us"] < best[key]["device_us"]:
            best[key] = r
    excess = {f"P{P}_n{n}": next(r["device_us"] for r in rows
                                 if (r["P"], r["n"]) == (P, n)
                                 and r["picked"]) - best[(P, n)]["device_us"]
              for P, n in SHAPES}
    print(json.dumps({
        "fit": {"fixed_us": fixed, "kPairNs": pair_ns,
                "kClusterNs": cluster_ns},
        "residual_us_max": float(np.abs(A @ [fixed, pair_ns, cluster_ns]
                                        - us).max()),
        "picked_minus_fastest_us": excess,
        "max_rel_err": max(r["rel_err"] for r in rows), "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
