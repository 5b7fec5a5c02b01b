"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything that belongs to one cell lies in files found by name:

* ``BENCHMARK.json`` names the cell's configuration and traffic, and the
  metrics each cell reports;
* ``benchmark/configs/<config>.json``: the configuration's sizes; its
  ``model`` names ``benchmark/models/<model>.py`` (inputs from the seed,
  the program's target, the check) and ``benchmark/reference/<model>.py``
  (the plain reference);
* ``benchmark/traffic/<traffic>.json``: how the run drives the program,
  its ``path`` naming ``benchmark/paths/<path>.py``;
* ``benchmark/counts/<config>.py``: the operations and bytes of its work;
* ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(rec)``
  -> a number, or None where the run holds nothing to read (``rec``: the
  run's ``config``, ``traffic``, ``counts`` module, ``peaks`` row,
  ``window_s``, ``supersteps``, ``setup_s``, ``outputs`` and, traced,
  ``segment``);
* ``benchmark/limits/<cell>.json``: the limit of each number compared.

A run: set-up (import, CUDA, the kernels' library, inputs, the program's
runner with its warm-up and burn-in) is timed from the process's start;
then launches go to the card for ``--seconds``, with at most
``IN_FLIGHT`` launches queued ahead of it, and the window ends at the
sync after the last one.  With ``--trace 1`` a segment of
``trace_launches`` launches then runs under ``torch.profiler``; its
device operations give ``busy_s`` and its wall time ``window_s``.  The
device's peak memory is read, the program's state freed, and the check
compares the window's outputs with the reference.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pmpx")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
# launches queued ahead of the card in the window
IN_FLIGHT = 3

__all__ = ["Cell", "load_cell", "run_cell", "main", "forbidden_modules"]


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = root / "benchmark"
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                           f" (there are {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = self.entry["chips"]
        self.config_name = self.entry["config"]
        self.config = json.loads(
            (bench / "configs" / f"{self.config_name}.json").read_text())
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        limits = bench / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.bench = bench

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` under the cell's root, else
        beside this harness."""
        for base in (self.bench, BENCH):
            path = base / kind / f"{name}.py"
            if path.exists():
                return _load(path, f"benchmark_{kind}_{name}")
        raise FileNotFoundError(f"benchmark/{kind}/{name}.py")

    def counts(self):
        try:
            return self.module("counts", self.config_name)
        except FileNotFoundError:
            return None


def load_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(name, root)


def _load(path: Path, key: str):
    key = key.replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``pmpx_torch`` is not ``pmpx``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seed(seed: int, stream: int) -> int:
    """The seed of one of a run's streams (0 inputs, 1 the chain, 2 the
    check's sample), below 2**63."""
    return (int(seed) * 7 + stream) % (2**63 - 1)


def _window(run, seconds: float, device) -> tuple:
    """Launch for ``seconds`` with at most ``IN_FLIGHT`` launches queued;
    returns (supersteps, launches, seconds to the sync after the last)."""
    events = collections.deque()
    steps = launches = 0
    t0 = time.perf_counter()
    while True:
        steps += run.launch()
        launches += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > IN_FLIGHT:
                events.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return steps, launches, time.perf_counter() - t0


def _segment(run, launches: int, device) -> dict:
    """``launches`` launches under ``torch.profiler`` (the device's
    operations and the host's)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced = sum(run.launch() for _ in range(launches))
        _sync(device)
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = [(e["name"], float(e["dur"]), float(e["ts"]), e["cat"])
           for e in events
           if e.get("cat") in DEVICE_OPS and e.get("ph") == "X"]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
            and e.get("ph") == "X"]
    return {"supersteps": traced, "wall_s": wall_s, "ops": ops,
            "host": host}


def _breakdown(seg: dict) -> dict:
    by_name = collections.defaultdict(float)
    for name, dur, _, _ in seg["ops"]:
        by_name[name] += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = sorted(seg["ops"], key=lambda o: o[2])
    gaps = []
    for a, b in zip(ops, ops[1:]):
        gap = b[2] - (a[2] + a[1])
        if gap > 0:
            gaps.append((gap, a[2] + a[1]))
    gaps = sorted(gaps, reverse=True)[:10]
    host = sorted(seg["host"], key=lambda h: h[1])
    labelled = []
    for gap, t in gaps:
        live = [h for h in host if h[1] <= t < h[1] + h[2]]
        name = min(live, key=lambda h: h[2])[0] if live else "host idle"
        labelled.append([name[:120], gap / 1e6])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in top],
            "idle_gaps": labelled}


def _busy_s(ops: list) -> float:
    """Seconds in which some device operation ran (the union of their
    intervals)."""
    busy, end = 0.0, -math.inf
    for _, dur, ts, _ in sorted(ops, key=lambda o: o[2]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy / 1e6


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, overrides=None) -> dict:
    """One run of ``cell``.  Returns ``{"result": the result line's dict,
    "split": set-up by part, "window_s", "launches", "outputs": the
    window's outputs}``.

    ``overrides`` ({"config": {...}, "traffic": {...}}) change sizes for
    a rehearsal.  On a CPU device the run reports no metric."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    config = dict(cell.config, **(overrides or {}).get("config", {}))
    traffic = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    split = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    split["import_s"] = mark - t_start
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    lap("cuda_init_s")
    if cuda:
        from pmpx_torch import _build

        _build.load()
    lap("library_s")
    model = cell.module("models", config["model"])
    path = cell.module("paths", traffic["path"])
    inp = model.inputs(config, _seed(seed, 0), device)
    _sync(device)
    lap("data_s")
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 1))
    run = path.Run(model, config, traffic, inp, gen, device)
    _sync(device)
    lap("warm_up_s")
    setup_s = time.perf_counter() - t_start
    steps, launches, window_s = _window(run, seconds, device)
    out = run.outputs()
    run.keep = False
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = {"config": config, "traffic": traffic, "counts": cell.counts(),
           "peaks": _peaks(device), "window_s": window_s,
           "supersteps": steps, "setup_s": setup_s, "outputs": out,
           "segment": None}
    seg = None
    if trace and cuda:
        seg = _segment(run, traffic["trace_launches"], device)
        rec["segment"] = seg
    del run
    if cuda:
        torch.cuda.empty_cache()
    metrics = {}
    if cuda:
        wanted = cell.per_layer if trace else cell.end_to_end
        for m in wanted:
            value = cell.module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = _nonfinite(out)
    check_gen = torch.Generator(device=device)
    check_gen.manual_seed(_seed(seed, 2))
    numbers = model.check(config, traffic, inp, out, check_gen)
    check = {}
    for name, value in numbers.items():
        limit = cell.limits.get(name, {}).get("limit", math.nan)
        check[name] = {"value": value, "limit": limit}
    correct = bool(check) and failed == 0 and all(
        c["value"] <= c["limit"] for c in check.values())
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": _device(device, cell, peak)}
    if seg is not None:
        result["device"]["busy_s"] = _busy_s(seg["ops"])
        result["device"]["window_s"] = seg["wall_s"]
        result["breakdown"] = _breakdown(seg)
    result["check"] = check
    return {"result": result, "split": split, "window_s": window_s,
            "launches": launches, "outputs": out}


def _nonfinite(out: dict) -> int:
    """Supersteps whose state or log-density is not finite."""
    bad = ~torch.isfinite(out["draws"]).all(dim=-1)
    if "logp" in out:
        bad |= ~torch.isfinite(out["logp"])
    return int(bad.sum())


def _peaks(device) -> dict | None:
    if device.type != "cuda":
        return None
    table = json.loads((BENCH / "peaks.json").read_text())
    name = torch.cuda.get_device_name(device)
    for row in table["cards"]:
        if row["match"] in name:
            return row
    return None


def _device(device, cell, peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": int(peak)}


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps({"setup_split": out["split"],
                      "window_s": out["window_s"],
                      "launches": out["launches"]}), flush=True)
    for name, c in out["result"]["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(out["result"]), allow_nan=False), flush=True)
    return 0


def _finite(obj):
    """The result with every infinite number written as +-1e300 and NaN as
    null, so that the line is JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None if math.isnan(obj) else math.copysign(1e300, obj)
    return obj
