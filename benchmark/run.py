"""Run one cell of the benchmark once on the card this process finds.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints a line that splits the set-up, then,
as its last line, the result: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (``breakdown`` with ``--trace 1``) and ``check``,
each number compared beside its limit (also the last lines on standard
error).  Exits non-zero, with no result, without enough CUDA devices or
when JAX or the JAX package was loaded.  See ``benchmark/harness.py``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
