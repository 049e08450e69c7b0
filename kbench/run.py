"""The benchmark's entry: one run of one cell of ``BENCHMARK.json``.

    python3 -m kbench.run --workload sweep.table4 --seed 12345 \\
        --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA cards.
It puts ``src/`` on ``sys.path``, measures ``repro_torch`` and prints, as
its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each number compared with its limit; the
same numbers close its standard error. It exits non-zero, printing no
result, without the cards, without the program, or if JAX or the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(prog="kbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from kbench import harness

    return harness.main(args, ROOT, T0)


if __name__ == "__main__":
    sys.exit(main())
