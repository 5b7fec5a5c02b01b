"""The check's controls: what the numbers that decide ``correct`` read when
the cell computes in the precision below its configuration's (bfloat16
for float32).  Each must fail the cell's limits.

    python3 benchmark/controls.py --workload <name> --seeds 1 2 3

on a machine with a card prints one JSON line a seed with the numbers
compared.  The benchmark's own runs never run a control.  A model module
either computes its control itself (``control``: for linreg, the
reference's sampler in bfloat16 in the program's place), or names the
dtype in which the program itself is the control (``CONTROL_DTYPE``: the
LSTM's bfloat16 ``lstm_fused``), run for a short window at the cell's
load.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402

__all__ = ["control"]


def control(cell, seed: int, device, seconds: float = 5.0,
            overrides=None) -> dict:
    """The numbers the cell's check compares, read from its control."""
    ov = overrides or {}
    config = dict(cell.config, **ov.get("config", {}))
    traffic = dict(cell.traffic, **ov.get("traffic", {}))
    model = cell.module("models", config["model"])
    if hasattr(model, "control"):
        inp = model.inputs(config, H._seed(seed, 0), device)
        gen = torch.Generator(device=device)
        gen.manual_seed(H._seed(seed, 1))
        check_gen = torch.Generator(device=device)
        check_gen.manual_seed(H._seed(seed, 2))
        return model.control(config, traffic, inp, gen, check_gen)
    ov = {"config": dict(ov.get("config", {}), dtype=model.CONTROL_DTYPE),
          "traffic": ov.get("traffic", {})}
    out = H.run_cell(cell, seed, seconds, False, device, overrides=ov)
    return {k: v["value"] for k, v in out["result"]["check"].items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 benchmark/controls.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    cell = H.load_cell(args.workload)
    for seed in args.seeds:
        numbers = control(cell, seed, torch.device("cuda"), args.seconds)
        limits = {k: cell.limits.get(k, {}).get("limit") for k in numbers}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "limits": limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
