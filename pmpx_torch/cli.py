"""pmpx_torch command-line interface (port of ``pmpx/cli.py``'s ``list``
and ``run``):

    python -m pmpx_torch.cli list
    python -m pmpx_torch.cli run time_analysis --method fused_chain \
        --include_conv_pmp true
    python -m pmpx_torch.cli run time_analysis --method sweep --device cpu
    python -m pmpx_torch.cli run cores_sweep --method fused_chain --algo mp
    python -m pmpx_torch.cli run mnist --model LSTM --algo pmp --N 7 \
        --lstm_kernel true --scale paper --num_steps 1000

Arbitrary ``--key value`` pairs are forwarded to the experiment's ``run()``
(ints/floats/bools/tuples parsed from the string).  ``--device`` names the
device (CUDA unless given).  Results print as one JSON object.  The
``convert``, ``plot`` and ``doctor`` subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from pmpx_torch.experiments import EXPERIMENTS


def _parse_value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if "," in v:
        return tuple(_parse_value(p) for p in v.split(",") if p)
    return v


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m pmpx_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list experiments")
    runp = sub.add_parser("run", help="run an experiment")
    runp.add_argument("experiment", choices=EXPERIMENTS)
    runp.add_argument("--device", default=None,
                      help="torch device (default: cuda)")
    args, extra = parser.parse_known_args(argv)

    if args.cmd == "list":
        for e in EXPERIMENTS:
            mod = importlib.import_module(f"pmpx_torch.experiments.{e}")
            doc = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"{e:16s} {doc}")
        return 0

    overrides = {}
    it = iter(extra)
    for tok in it:
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument {tok!r}")
        key = tok[2:].replace("-", "_")
        try:
            val = next(it)
        except StopIteration:
            raise SystemExit(f"missing value for {tok!r}")
        overrides[key] = _parse_value(val)
    if args.device is not None:
        overrides["device"] = args.device

    mod = importlib.import_module(f"pmpx_torch.experiments.{args.experiment}")
    result = mod.run(**overrides)
    print(json.dumps(result, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
