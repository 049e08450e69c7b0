"""One run of one cell: set-up, the measured window, the traced slice, the
check of the outputs against the plain reference, and the result line.

A loop (``kbench/loops/<kind>.py``, the kind named by the cell's
traffic file) owns what is particular to a kind of traffic. Its
``Loop(config, traffic, seed, device)`` offers:

  * ``setup()``: build and warm everything the window uses;
  * ``window(seconds) -> {metric: value}``: the end-to-end metrics;
  * ``traced() -> trace.Slice``: a profiled slice after the window;
  * ``context()``: what the per-layer readers read beside the slice;
  * ``release()``: drop the program's state before the reference runs;
  * ``check() -> [Check]``: the numbers compared, each with its limit;
  * ``readings()``: the same numbers for the program, the control and any
    planted fault (``kbench/control.py`` prints them);
  * ``attempted``, ``failed`` and ``info`` (a dict for the log lines).
"""
from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple

from kbench import trace
from kbench.manifest import Bench

#: Top-level module names that no run may load: the JAX package this port
#: was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Check(NamedTuple):
    """One number compared, its limit, and whether it held."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_facts(device) -> Dict:
    """The card's name, and its power limit as ``nvidia-smi`` reads it."""
    import torch

    facts = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        facts["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        facts["nvidia_smi"] = f"unavailable: {exc}"
    return facts


def log(tag: str, payload: Dict) -> None:
    """An earlier output line (the last line is the result)."""
    print(f"kbench.{tag} " + json.dumps(payload, sort_keys=True), flush=True)


def loop_for(bench: Bench, cell: Dict, seed: int, device):
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    module = importlib.import_module(f"kbench.loops.{traffic['kind']}")
    return module.Loop(config, traffic, seed, device)


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device, t0: float) -> Dict:
    """Run the cell and return the result object (without printing it)."""
    import torch

    cell = bench.cell(name)
    on_card = device.type == "cuda"
    loop = loop_for(bench, cell, seed, device)
    loop.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    e2e = loop.window(seconds)
    e2e["setup_s"] = setup_s
    sl = loop.traced() if traced else None
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    ctx = loop.context()
    loop.release()
    t_check = time.perf_counter()
    checks = loop.check()
    loop.info["check_s"] = time.perf_counter() - t_check

    units = {m["name"]: m["unit"] for m in bench.data["end_to_end"]
             + bench.data["per_layer"]}
    metrics = {}
    if not traced:
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(sl, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": int(loop.attempted), "failed": int(loop.failed),
              "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = trace.busy_seconds(sl)
        dev["window_s"] = sl.wall_s
        result["breakdown"] = {"device_ops": trace.top_ops(sl),
                               "idle_gaps": trace.idle_by_span(sl)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    log("info", dict(loop.info, workload=name, seed=seed, trace=int(traced),
                     window_metrics=e2e))
    return result


def main(args, root, t0: float) -> int:
    bench = Bench(root)
    try:
        cell = bench.cell(args.workload)
    except KeyError as exc:
        print(f"kbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"kbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        importlib.import_module("repro_torch")
    except ImportError as exc:
        print(f"kbench: the program under test (src/repro_torch) does not "
              f"import: {exc}", file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    log("card", card_facts(device))
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f"kbench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"kbench.check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
