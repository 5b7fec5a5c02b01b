"""Profile the small-P fixed cost: the kernel breakdown of the PMP
n=500 / P=4 superstep (the weakest cell of the headline table) on the
CUDA card (the port of ``scripts/profile_smallp.py``).

Usage: python scripts/profile_smallp_torch.py [P] [n_data] [iters] \
           [method] [--device cpu]

``method`` is ``BayesLinReg``'s (``sweep``, the ``linreg_rss`` kernel, by
default).  Prints the wall µs per superstep of the compiled chain (its
capturing first run outside the timed window), then the device µs per
superstep of a traced run and its top 25 kernels by name; on the CPU the
table is of the host's ops.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(P: int = 4, n_data: int = 500, iters: int = 2000,
         method: str = "sweep", device=None) -> dict:
    """Returns the wall µs and the traced µs per superstep, the table of
    ``(name, µs per superstep)`` and the kernels' launches in the timed
    run."""
    import torch

    from pmpx_torch import tree
    from pmpx_torch._device import resolve_device
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.kernels import launches
    from pmpx_torch.profiling import device_time_us, trace
    from pmpx_torch.samplers.base import compile_chain
    from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def generator(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    x, y = make_synthetic_linreg(generator(0), n_data)
    target = BayesLinReg(x, y, temper=0.1, method=method, device=dev)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    spec = SamplerSpec(
        algo="pmp", N=1, depth=tree.binary_depth(P), step_size=0.02,
        selection="all_first",
    )
    superstep = spec.build(target)
    chain = compile_chain(superstep, generator(1), theta0,
                          collect=lambda th, o: o["root_index"])

    def run(seed):
        with torch.no_grad():
            _, roots = chain.run(generator(seed), theta0, iters)
        if cuda:
            torch.cuda.synchronize(dev)
        return roots

    run(1)  # the capture and the kernels' build, outside the clock

    before = dict(launches)
    t0 = time.perf_counter()
    run(2)
    wall = (time.perf_counter() - t0) / iters * 1e6
    timed = {k: v - before[k] for k, v in launches.items() if v != before[k]}
    print(f"wall us/iter: {wall:.2f}")

    # the card's kernels; a CPU trace has none, so there the host's ops
    category = "kernel" if cuda else "cpu_op"
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            run(3)
        ops = device_time_us(log_dir, category=category)
    total = sum(ops.values())
    what = "device" if cuda else "host-op"
    print(f"{what} total us/iter: {total / iters:.2f}  "
          f"({len(ops)} {category} names)")
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:25]
    for name, us in top:
        print(f"  {us / iters:8.3f} us/iter  {name}")
    return {"wall_us_per_iter": wall, "traced_us_per_iter": total / iters,
            "category": category,
            "top": [(name, us / iters) for name, us in top],
            "launches": timed, "iters": iters}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("P", nargs="?", type=int, default=4)
    ap.add_argument("n_data", nargs="?", type=int, default=500)
    ap.add_argument("iters", nargs="?", type=int, default=2000)
    ap.add_argument("method", nargs="?", default="sweep")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.P, args.n_data, args.iters, args.method, args.device)
