"""The readers of the program's spans (``runners_built_per_ensemble.sweep``,
``open_ms_per_ensemble.sweep``, ``to_host_gb_per_s.sweep``) on hand-made
span lists, and on a traced slice of the shrunk sweep on the CPU."""
import importlib.util

import pytest
import torch

from kbench import harness
from kbench.manifest import Bench
from kbench.tests import tiny
from repro_torch.ops.trace import Record

READERS = ("runners_built_per_ensemble.sweep", "open_ms_per_ensemble.sweep",
           "to_host_gb_per_s.sweep")


def reader_module(name):
    path = tiny.ROOT / "kbench" / "layers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kbench_layers_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rec(name, start_us, end_us, parent=None, **attrs):
    return Record(name, parent, 1, int(start_us * 1e3), int(end_us * 1e3),
                  attrs)


#: Two ensembles: the first builds its runner, the second finds it.
SPANS = [
    rec("open.runner.build", 10, 400, "open.runner"),
    rec("open.runner", 5, 410, "open", hit=False),
    rec("open.state", 410, 500, "open"),
    rec("open", 0, 4000),
    rec("dispatch", 4000, 4100, kind="chunk", steps=64, chunk=64),
    rec("to_host.wait", 4100, 9000, "to_host"),
    rec("to_host.copy", 9000, 19000, "to_host", bytes=30_000_000),
    rec("to_host", 4100, 19000),
    rec("open.runner", 20000, 20010, "open", hit=True),
    rec("open", 20000, 22000),
    rec("to_host.copy", 23000, 28000, "to_host", bytes=20_000_000),
]


@pytest.mark.parametrize("name", READERS)
def test_no_spans_give_nothing(name):
    assert reader_module(name).value([]) is None


@pytest.mark.parametrize("name,want", [
    ("runners_built_per_ensemble.sweep", 0.5),
    ("open_ms_per_ensemble.sweep", 3.0),
    # 50 MB in 15 ms of copies: the wait is not in the rate
    ("to_host_gb_per_s.sweep", 50e6 / 15e-3 / 1e9),
])
def test_readers_on_a_hand_made_slice(name, want):
    assert reader_module(name).value(SPANS) == pytest.approx(want)


@pytest.mark.parametrize("name,spans", [
    ("runners_built_per_ensemble.sweep", [rec("open.runner.build", 0, 1)]),
    ("open_ms_per_ensemble.sweep", [rec("dispatch", 0, 1)]),
    ("to_host_gb_per_s.sweep", [rec("to_host.wait", 0, 1)]),
])
def test_spans_without_the_metric_give_nothing(name, spans):
    assert reader_module(name).value(spans) is None


def test_every_build_counts():
    spans = [rec("open", 0, 1000), rec("open.runner.build", 0, 10),
             rec("open.runner.build", 10, 20)]
    assert reader_module("runners_built_per_ensemble.sweep").value(
        spans) == 2.0


def test_a_traced_sweep_slice_on_the_cpu(tmp_path, monkeypatch):
    """The shrunk Table IV sweep, traced on the CPU: every ensemble of the
    slice opens a new seed and builds its runner, and each reader finds its
    spans in what the slice's profiler recorded."""
    from repro_torch.ops import trace as program_trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    program_trace.clear()
    bench = Bench(tiny.make(tmp_path))
    loop = harness.loop_for(bench, bench.cell("sweep.table4"), 7,
                            torch.device("cpu"))
    loop.setup()
    loop.window(0.05)
    assert program_trace.spans() == []
    sl = loop.traced()
    n = loop.info["slice_ensembles"]
    values = {m: bench.reader(m)(sl, None) for m in READERS}
    assert values["runners_built_per_ensemble.sweep"] == 1.0
    assert values["open_ms_per_ensemble.sweep"] > 0
    assert values["to_host_gb_per_s.sweep"] > 0
    opens = [r for r in program_trace.spans() if r.name == "open"]
    assert len(opens) == n
    copies = [r for r in program_trace.spans() if r.name == "to_host.copy"]
    assert all(r.attrs["bytes"] == 3 * 8 * 24 * 4 for r in copies)
    program_trace.clear()
    assert all(bench.reader(m)(sl, None) is None for m in READERS)
    assert all(bench.reader(m)(None, None) is None for m in READERS)
