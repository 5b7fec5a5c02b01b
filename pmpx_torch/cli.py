"""pmpx_torch command-line interface (port of ``pmpx/cli.py``: ``list``,
``run``, ``convert``, ``plot`` and ``doctor``):

    python -m pmpx_torch.cli list
    python -m pmpx_torch.cli run time_analysis --method fused_chain \
        --include_conv_pmp true
    python -m pmpx_torch.cli run error_boxplot --times 5 --device cpu
    python -m pmpx_torch.cli run multichain --mode sweep --path fused
    python -m pmpx_torch.cli run mnist --model LSTM --algo pmp --N 7 \
        --lstm_kernel true --scale paper --num_steps 1000
    python -m pmpx_torch.cli run cifar_hmc --algo pmp_hmc --scale paper \
        --num_steps 500 --chunk_steps 100 --resume true
    python -m pmpx_torch.cli run bnn --algo pmp_hmc --n 2 --scale paper
    python -m pmpx_torch.cli run resilience --kills 2 --kill_mode sigkill
    python -m pmpx_torch.cli convert trace.pmpx --out trace.npy
    python -m pmpx_torch.cli plot results/mnist/run.npz --out run.pdf
    python -m pmpx_torch.cli doctor --probe-timeout 60

Arbitrary ``--key value`` pairs are forwarded to the experiment's ``run()``
(ints/floats/bools/tuples parsed from the string).  ``--device`` names the
device (CUDA unless given).  Results print as one JSON object.
``convert`` turns a ``TraceWriter`` file into ``.npy`` (through
:mod:`pmpx_torch.runtime`); ``plot`` draws a saved trace's loss and
accuracy on twin axes (it needs matplotlib).  ``doctor`` prints the
environment and a bounded probe of the device (``--device``, CUDA unless
given; :mod:`pmpx_torch.transport`) and exits 0 when the device answered,
1 when it did not.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np

from pmpx_torch.experiments import EXPERIMENTS
from pmpx_torch.experiments._common import maybe_plot
from pmpx_torch.runtime import read_trace


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


def _plot_loss_acc(plt, npz: str, out: str) -> bool:
    """The loss (left axis) and train/test accuracy (right axis) of a
    recorder .npz against the iteration, saved to ``out``."""
    z = np.load(npz)
    fig, ax1 = plt.subplots()
    if "loss" in z:
        ax1.plot(z["loss"], color="tab:red", label="loss")
        ax1.set_ylabel("loss", color="tab:red")
    ax2 = ax1.twinx()
    for k, c in (("train_acc", "tab:blue"), ("test_acc", "tab:green")):
        if k in z:
            ax2.plot(z[k], color=c, label=k)
    ax2.set_ylabel("accuracy")
    ax1.set_xlabel("iteration")
    fig.legend()
    fig.savefig(out)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m pmpx_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list experiments")
    runp = sub.add_parser("run", help="run an experiment")
    runp.add_argument("experiment", choices=EXPERIMENTS)
    runp.add_argument("--device", default=None,
                      help="torch device (default: cuda)")
    convp = sub.add_parser(
        "convert", help="convert a pmpx binary trace to .npy "
        "(the reference's data_trans.py txt->npy step)"
    )
    convp.add_argument("trace", help="path to a TraceWriter file")
    convp.add_argument("--out", default=None, help="output .npy path")
    plotp = sub.add_parser(
        "plot", help="twin-axis loss/accuracy plot from a saved trace "
        "(the reference's look_data.py)"
    )
    plotp.add_argument("npz", help="recorder .npz with loss/acc arrays")
    plotp.add_argument("--out", default=None, help="output .pdf path")
    docp = sub.add_parser(
        "doctor", help="bounded environment/device health report "
        "(never hangs on a wedged device)"
    )
    docp.add_argument(
        "--probe-timeout", type=float, default=120.0,
        help="seconds to wait for the device probe subprocess",
    )
    docp.add_argument("--device", default=None,
                      help="torch device to probe (default: cuda)")
    args, extra = parser.parse_known_args(argv)

    if args.cmd == "doctor":
        from pmpx_torch.transport import doctor_report

        report = doctor_report(probe_timeout_s=args.probe_timeout,
                               device=args.device)
        print(json.dumps(report, indent=2))
        return 0 if report["device"]["ok"] else 1

    if args.cmd == "convert":
        arr = read_trace(args.trace)
        out = args.out or (args.trace.rsplit(".", 1)[0] + ".npy")
        np.save(out, arr)
        print(json.dumps({"out": out, "shape": list(arr.shape)}))
        return 0

    if args.cmd == "plot":
        out = args.out or (args.npz.rsplit(".", 1)[0] + ".pdf")
        if maybe_plot(lambda plt: _plot_loss_acc(plt, args.npz, out)) is None:
            raise SystemExit("plot needs matplotlib, which is not "
                             "installed")
        print(json.dumps({"out": out}))
        return 0

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
