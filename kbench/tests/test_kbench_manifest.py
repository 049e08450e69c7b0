"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
import time

import torch

from kbench import harness
from kbench.manifest import Bench
from kbench.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(b["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in b[kind]}) == len(b[kind])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


def test_every_cell_has_its_files_and_metrics():
    bench = Bench(ROOT)
    b = bench.data
    used = set()
    for w in b["workloads"]:
        cfg = bench.config(w["config"])
        used.add(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert (ROOT / "kbench" / "loops" / f"{traffic['kind']}.py") \
            .is_file()
        e2e = [m["name"] for m in bench.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.per_layer(w["name"])
        assert layers
        for m in layers:
            assert callable(bench.reader(m["name"]))
            assert m["moves"] in e2e
        assert cfg["num_markets"] > 0
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("kbench/") for f in files)


def test_a_new_config_cell_and_metric_need_no_edit(tmp_path):
    """A throwaway configuration, cell and per-layer reader, added as new
    files and entries, run with every existing file as it is."""
    root = tiny.make(tmp_path)
    cfg = json.loads((ROOT / "kbench/configs/table4.json").read_text())
    cfg = tiny.shrink_config(cfg)
    cfg.update(name="throwaway", num_agents=24, num_levels=32,
               market=dict(cfg["market"], alpha_hft=0.1, alpha_whale=0.1))
    (root / "kbench/configs/throwaway.json").write_text(json.dumps(cfg))
    (root / "kbench/layers/throwaway_count.py").write_text(
        "def read(sl, ctx):\n    return ctx.ensembles_in_slice + 1.0\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "throwaway", "source": "a test",
                         "file": "kbench/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "sweep.throwaway", "config": "throwaway",
                           "traffic": "sweep", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m and "sweep.table4" in m["workloads"]:
            m["workloads"].append("sweep.throwaway")
    b["per_layer"].append({"name": "throwaway_count", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "agent_events_per_s",
                           "workloads": ["sweep.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    bench = Bench(root)
    r = harness.run_cell(bench, "sweep.throwaway", 5, 0.2, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"agent_events_per_s", "ensemble_ms_p95",
                                 "setup_s"}
    assert list(r)[-1] == "checks"
    assert "throwaway_count" in [m["name"] for m in
                                 bench.per_layer("sweep.throwaway")]
    assert bench.reader("throwaway_count")(None, type(
        "C", (), {"ensembles_in_slice": 2})) == 3.0
