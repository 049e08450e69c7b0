"""A copy of the benchmark's data at a size the CPU runs in a second: the
manifest, the traffic files and the layer readers as they are, the
configurations and the mixes shrunk. The loops are the package's own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def shrink_config(c: dict) -> dict:
    c = dict(c)
    c.update(num_markets=8, num_agents=16, num_levels=16, num_steps=24)
    return c


def shrink_traffic(name: str, t: dict) -> dict:
    t = json.loads(json.dumps(t))
    if t["kind"] == "sweep":
        t.update(chunk=8, rows_checked=8, slice_seconds=0.1)
    elif t["kind"] == "ppo":
        for b in t["blocks"]:
            b["markets"] = 4
            if "shock_step" in b["market"]:
                b["market"]["shock_step"] = 4
        t["ppo"].update(rollout_len=8, num_minibatches=2)
        t["updates_per_call"] = 2
    return t


def make(dst: Path) -> Path:
    """The shrunk copy under ``dst``; returns ``dst``."""
    (dst / "kbench" / "configs").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "kbench" / "layers", dst / "kbench" / "layers")
    (dst / "kbench" / "traffic").mkdir()
    for f in (ROOT / "kbench" / "traffic").glob("*.json"):
        t = shrink_traffic(f.stem, json.loads(f.read_text()))
        (dst / "kbench" / "traffic" / f.name).write_text(json.dumps(t))
    for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]:
        cfg = shrink_config(json.loads((ROOT / c["file"]).read_text()))
        (dst / c["file"]).write_text(json.dumps(cfg))
    return dst
