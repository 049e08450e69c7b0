"""The readings the check's limits are set from, on the chip.

    python3 -m kbench.control --workload sweep.table4 --seeds 1,2,3 \\
        --seconds 2 [--program-only]

For each seed, one process runs the cell's set-up and a short window at
the cell's own size, frees the program's state, then prints one JSON line
of the compared numbers: the program against the reference as stated, the
control (the reference one precision lower, in the program's place) and,
for training, each planted fault (see ``kbench/reference/ppo.py``); with
``--program-only`` the program's numbers alone. Not run by the
benchmark's own runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program-only", action="store_true")
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from kbench import harness
    from kbench.manifest import Bench

    if not torch.cuda.is_available():
        print("kbench.control: no CUDA device", file=sys.stderr)
        return 3
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = harness.loop_for(bench, cell, seed, device)
        loop.setup()
        loop.window(args.seconds)
        loop.release()
        out = loop.readings(controls=not args.program_only)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "readings": out}), flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
