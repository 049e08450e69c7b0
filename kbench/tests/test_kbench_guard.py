"""What a run loads, and how it refuses to run.

In fresh interpreters: every module of the harness, and a cell's set-up
path through the program (on the CPU, at a tiny size), load no module whose
top-level name, compared whole, is ``jax``, ``jaxlib``, ``flax`` or
``repro`` (the port ``repro_torch`` starts with ``repro``: the names are
compared whole); the references load nothing of ``repro_torch`` either.
Without a card the entry exits non-zero and prints no result, and so it
does in a directory that holds only the benchmark's files."""
import json
import os
import shutil
import subprocess
import sys

from kbench.tests import tiny

ROOT = tiny.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded(code: str, tmp_path=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    prog = code + ("\nimport sys, json\nprint(json.dumps(sorted({m.split('.')"
                   "[0] for m in list(sys.modules)})))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path or ROOT),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_set_up_path_load_no_jax(tmp_path):
    tiny.make(tmp_path / "t")
    names = loaded(
        "import pkgutil, importlib, kbench, time, torch\n"
        "for m in pkgutil.walk_packages(kbench.__path__, 'kbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "from kbench import harness\n"
        "from kbench.manifest import Bench\n"
        f"b = Bench({str(tmp_path / 't')!r})\n"
        "for cell in ('sweep.table4', 'sweep.wide_book', 'train.table4'):\n"
        "    d = harness.loop_for(b, b.cell(cell), 1, torch.device('cpu'))\n"
        "    d.setup()\n")
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_references_load_nothing_of_the_program():
    names = loaded("import kbench.reference.market, kbench.reference.ppo, "
                   "kbench.count, kbench.trace")
    assert not names & (FORBIDDEN | {"repro_torch"})


def run_entry(cwd):
    return subprocess.run(
        [sys.executable, "-m", "kbench.run", "--workload", "sweep.table4",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(cwd), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_entry_refuses_without_a_card():
    out = run_entry(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_entry_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_entry(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_entry_refuses_without_the_program(tmp_path):
    """Past the look for a card (faked here), a checkout without ``src/``
    exits non-zero with no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['kbench.run', '--workload', 'sweep.table4', "
            "'--seed', '1', '--seconds', '1']\n"
            "runpy.run_module('kbench.run', run_name='__main__')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(tmp_path), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 4, out.stderr[-2000:]
    assert out.stdout.strip() == "" and "repro_torch" in out.stderr
