"""Guards of the port's boundary: it imports neither JAX nor the JAX
package, and it never moves work to the CPU behind the caller's back."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.kernels.ops, repro_torch.convert, "
            "repro_torch.env.actions, repro_torch.env, "
            "repro_torch.kernels.ref, "
            "repro_torch.kernels.naive_clearing, "
            "repro_torch.core.torch_backend, repro_torch.serve, "
            "repro_torch.serve.transport, repro_torch.ops, "
            "repro_torch.ops.chaos, repro_torch.checkpoint, "
            "repro_torch.scenario, repro_torch.scenario.validate, "
            "repro_torch.core.numpy_backend, repro_torch.core.sequential, "
            "repro_torch.train, repro_torch.train.loop; "
            "repro_torch.core.session.backends(); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_import_scan_covers_every_subpackage():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for p in PORT_FILES if "repro_torch" in p.parts}
    for sub in ("core", "kernels", "env", "serve", "ops", "checkpoint",
                "scenario", "train"):
        assert sub in scanned, sub


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.session import Engine

    with pytest.raises(RuntimeError, match="cuda"):
        Engine("cuda-kinetic")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine("cuda-kinetic", device="cuda:0")


@pytest.mark.parametrize("backend", ["numpy", "numpy-splitmix64",
                                     "numpy-pcg64"])
def test_numpy_family_runs_on_the_host_only(backend):
    """The CPU reference family takes only ``device="cpu"``; any other
    device raises ``ValueError`` naming the backend, card or no card."""
    from repro_torch.core.session import Engine

    for device in ("cuda", "cuda:0", None, torch.device("cuda")):
        with pytest.raises(ValueError, match=backend):
            Engine(backend, device=device)
    with pytest.raises(ValueError, match=backend):
        Engine(backend)
    assert Engine(backend, device="cpu").device.type == "cpu"


def test_gateway_and_warm_without_a_card_raise():
    """The serving entry points default to the card too: a gateway and a
    warm start with no card raise instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.session import Engine
    from repro_torch.serve import Gateway, parked_template

    tpl = parked_template(slots=2, num_agents=4, num_levels=8, num_steps=8)
    for backend in ("cuda-kinetic", "torch-scan"):
        with pytest.raises(RuntimeError, match="cuda"):
            Gateway(tpl, backend=backend)
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(backend).warm(MarketConfig(num_markets=2, num_agents=4,
                                              num_levels=8, num_steps=8))
    with pytest.raises(RuntimeError, match="cuda"):
        Gateway(tpl, engine_opts={"device": "cuda"})


def test_trainer_without_a_card_raises():
    """The trainer's entry points default to the card too: with no card
    ``Engine(...).trainer``, the param init and the param conversion raise
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np

    from repro_torch.convert import actor_critic_from_numpy
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.session import Engine
    from repro_torch.train import init_actor_critic

    cfg = MarketConfig(num_markets=2, num_agents=4, num_levels=8, num_steps=8)
    for backend in ("cuda-kinetic", "torch-scan"):
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(backend).trainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_actor_critic(0, 5, 7)
    tree = {"torso": ((np.zeros((5, 4), np.float32),
                       np.zeros(4, np.float32)),),
            "pi": (np.zeros((4, 7), np.float32), np.zeros(7, np.float32)),
            "v": (np.zeros((4, 1), np.float32), np.zeros(1, np.float32))}
    with pytest.raises(RuntimeError, match="cuda"):
        actor_critic_from_numpy(tree)
    assert Engine("torch-scan", device="cpu").trainer(cfg).device.type \
        == "cpu"


def _constructors():
    from repro_torch.core import params, stats, step
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    cfg = MarketConfig(num_markets=2, num_agents=4, num_levels=8, num_steps=2)
    spec = EnsembleSpec.homogeneous(cfg)
    cols = params.pack_params(spec.params, "cpu").columns()
    return {
        "initial_state": lambda: step.initial_state(spec),
        "init_stats": lambda: stats.init_stats(2),
        "spec.initial_books": spec.initial_books,
        "cfg.initial_books": cfg.initial_books,
        "scalar_params": lambda: params.scalar_params(cfg),
        "agent_types": lambda: params.agent_types(cols, 4),
    }


@pytest.mark.parametrize("name", ["initial_state", "init_stats",
                                  "spec.initial_books", "cfg.initial_books",
                                  "scalar_params", "agent_types"])
def test_constructors_default_to_the_card(name):
    """Every tensor constructor defaults to ``cuda``: with no card it raises
    instead of building CPU tensors the wrapper would then run plainly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _constructors()[name]()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package it cannot run."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(lone)],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_failed_build_is_reported_by_backend_available(monkeypatch):
    from repro_torch.core import session
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import ops

    def broken():
        raise RuntimeError("nvcc failed for kinetic_clearing.cu")

    monkeypatch.setattr(kc, "_load_library", broken)
    monkeypatch.setattr(session, "_FAILED", {})
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=2, num_agents=4, num_levels=8, num_steps=2))
    # The build is attempted before anything touches the device.
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.KineticChunkRunner(spec, 2, torch.device("cuda"))
    assert "nvcc failed" in session.backend_available("cuda-kinetic")


def test_failed_naive_build_is_reported_by_backend_available(monkeypatch):
    from repro_torch.core import session
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.kernels import ops

    def broken():
        raise RuntimeError("nvcc failed for naive_clearing.cu")

    monkeypatch.setattr(nc, "_load_library", broken)
    monkeypatch.setattr(session, "_FAILED", {})
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=2, num_agents=4, num_levels=8, num_steps=2))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.NaiveChunkRunner(spec, 2, torch.device("cuda"))
    assert "nvcc failed" in session.backend_available("cuda-naive")
    assert session.backend_available("cuda-kinetic") is True
