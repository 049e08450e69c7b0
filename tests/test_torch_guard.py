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
            "repro_torch.core.host.step, repro_torch.core.host.sequential, "
            "repro_torch.train, repro_torch.train.loop, "
            "repro_torch.launch, repro_torch.launch.mesh, "
            "repro_torch.launch.roofline, repro_torch.launch.sharding; "
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
                "scenario", "train", "launch"):
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


HOST_FILES = sorted((ROOT / "src" / "repro_torch" / "core" / "host")
                    .glob("*.py"))


@pytest.mark.parametrize("path", HOST_FILES, ids=lambda p: p.name)
def test_the_host_step_imports_numpy_only(path):
    """The CPU reference family's step imports numpy and its own modules:
    no torch, no JAX, nothing of either package's torch or JAX code."""
    allowed = {"__future__", "typing", "numpy"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name in allowed or name == "repro_torch.core.host" \
                or name.startswith("repro_torch.core.host."), \
                f"{path.name}:{node.lineno} imports {name}"


def test_the_host_scan_covers_every_module():
    assert {p.stem for p in HOST_FILES} >= {
        "__init__", "rng", "auction", "agents", "stats", "step",
        "sequential"}


def _aten_ops(fn) -> int:
    """The number of aten ops ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@pytest.mark.parametrize("stats_only", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "numpy-splitmix64",
                                     "numpy-pcg64", "torch-scan"])
def test_the_numpy_family_steps_without_torch(backend, stats_only):
    """A ``run(n)`` of the numpy family makes as many torch ops for n=8 as
    for n=2: only the conversions at the chunk's edges are torch, never the
    step. ``torch-scan`` on the CPU, whose step is torch, is the contrast."""
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.session import Engine

    cfg = MarketConfig(num_markets=4, num_agents=16, num_levels=16,
                       num_steps=40, seed=3, alpha_maker=0.15)
    sess = Engine(backend, device="cpu", stats_only=stats_only).open(
        cfg, chunk_size=8)
    short, long = (_aten_ops(lambda: sess.run(n)) for n in (2, 8))
    if backend == "torch-scan":
        assert long > short > 0
    else:
        assert long == short


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
        "cfg.agent_types": cfg.agent_types,
        "params.asarray": spec.params.asarray,
    }


@pytest.mark.parametrize("name", ["initial_state", "init_stats",
                                  "spec.initial_books", "cfg.initial_books",
                                  "scalar_params", "agent_types",
                                  "cfg.agent_types", "params.asarray"])
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


# ---------------------------------------------------------------------------
# repro's public names: the port has every one, or says why not.
# ---------------------------------------------------------------------------

#: ``repro`` modules whose counterpart has another name.
MODULE_MAP = {"core.jax_backend": "core.torch_backend",
              "launch.hlo_analysis": "launch.roofline"}
#: Parameters that name a JAX device or array module: the port's
#: counterpart is ``device=``, or nothing.
IGNORED_PARAMS = {"xp", "interpret", "device"}

_TPU = ("a TPU device: the port bins with scatter_add_ and shared-memory "
        "atomicAdd, and its launch shape is a TileChoice of warps a market, "
        "markets a CTA and an agent mode, with no VMEM, sublane padding or "
        "agent chunks")
_TILE = ("the launch shape is tile= (a TileChoice), the counterpart of mb=; "
         "agents= pins the agent mode, the counterpart of agent_chunk=")
_JAX_RUNNER = ("a JAX-only runner: its backends (jax-scan, jax-per-step, "
               "pallas-*) are torch-scan, torch-per-step and the CUDA "
               "kernels' ClearingChunkRunner in the port")
_XP = ("the array module or jit flag of the JAX package: the port's code is "
       "written on torch tensors and has no jit")
_ARCHETYPES = "the kernels hard-code the eight archetypes"
_KEY = ("the port's init takes an int seed (a torch.Generator), where repro "
        "takes a jax.random key")
_ROWS = "the port names it num_markets"
_KWARGS = "the engine's options are spelt **backend_opts in the port"
_HLO = ("the port's roofline counts what runs, at run time: PyTorch eager "
        "has no HLO text to parse")
_COMPAT = "a shim for old JAX versions' mesh construction"
_REIMPORT = ("an incidental re-import of the kernel module's constant, which "
             "the port keeps in kernels.kinetic_clearing")
_ENQUEUE = ("a rate of steps over dispatch times, which do not wait for the "
            "card: the port's spans and the benchmark measure the rate")
_ONE_HOOK = ("a runner places a snapshot's stats with to_device, which "
             "takes any namedtuple of columns")

#: What the port lacks by design, each with its reason (README.md's "Not
#: ported" list gives the same reasons). Keys: ``module:name``,
#: ``module:Class.member`` or ``module:function(parameter)``.
NOT_PORTED = {
    "core.step:bin_orders_onehot": _TPU,
    "core.step:simulate_step(bin_orders)": _TPU,
    "core.step:simulate_step(agent_chunk)": _TPU,
    "core.jax_backend:open_chunk_runner(binning)": _TPU,
    "core.jax_backend:simulate(binning)": _TPU,
    "kernels.autotune:SUBLANES": _TPU,
    "kernels.autotune:default_agent_chunk": _TPU,
    "kernels.autotune:estimate_vmem_bytes": _TPU,
    "kernels.autotune:pad_to_multiple": _TPU,
    "kernels.kinetic_clearing:pad_params": _TPU,
    "kernels.kinetic_clearing:pick_tile": _TPU,
    "kernels.autotune:TileChoice.mb": _TPU,
    "kernels.autotune:TileChoice.agent_chunk": _TPU,
    "kernels.autotune:TileChoice.m_padded": _TPU,
    "kernels.autotune:auto_tile(target)": _TPU,
    "kernels.autotune:candidate_tiles(target)": _TPU,
    "kernels.autotune:autotune_tile(num_markets)": _TPU,
    "kernels.autotune:candidate_tiles(agent_chunk)": _TILE,
    "kernels.kinetic_clearing:kinetic_clearing(mb)": _TILE,
    "kernels.kinetic_clearing:kinetic_clearing_chunk(mb)": _TILE,
    "kernels.kinetic_clearing:kinetic_clearing_chunk(agent_chunk)": _TILE,
    "kernels.naive_clearing:naive_clearing(mb)": _TILE,
    "kernels.naive_clearing:naive_clearing_chunk(mb)": _TILE,
    "kernels.naive_clearing:naive_clearing_chunk(agent_chunk)": _TILE,
    "kernels.ops:open_kinetic_runner(mb)": _TILE,
    "kernels.ops:open_naive_runner(mb)": _TILE,
    "kernels.ops:simulate_kinetic(mb)": _TILE,
    "kernels.ops:simulate_naive(mb)": _TILE,
    "kernels.ops:open_kinetic_runner(**opts)": _TILE,
    "kernels.ops:open_naive_runner(**opts)": _TILE,
    "kernels.ops:simulate_kinetic(**opts)": _TILE,
    "kernels.ops:simulate_naive(**opts)": _TILE,
    "core.jax_backend:JaxChunkRunner": _JAX_RUNNER,
    "kernels.ops:PallasChunkRunner": _JAX_RUNNER,
    "core.agents:ArchetypeContext.xp": _XP,
    "core.session:ChunkRunner.xp": _XP,
    "core.session:ChunkRunner.env_traceable": _XP,
    "env.rewards:RewardContext.xp": _XP,
    "core.agents:register_archetype": _ARCHETYPES,
    "train:init_actor_critic(key)": _KEY,
    "train.policies:init_actor_critic(key)": _KEY,
    "kernels.kinetic_clearing:resolve_params(M)": _ROWS,
    "core.engine:simulate(**kwargs)": _KWARGS,
    "core.engine:simulate_scenario(**kwargs)": _KWARGS,
    "core.engine:open_scenario(**kwargs)": _KWARGS,
    "launch.hlo_analysis:Op": _HLO,
    "launch.hlo_analysis:analyze(hlo)": _HLO,
    "launch.hlo_analysis:summarize(hlo)": _HLO,
    "launch.hlo_analysis:top_contributors(hlo)": _HLO,
    "launch.mesh:make_mesh_compat": _COMPAT,
    "kernels.naive_clearing:NUM_PARAM_OPERANDS": _REIMPORT,
    "ops.metrics:MetricsRegistry.steps_per_s": _ENQUEUE,
    "core.session:ChunkRunner.stats_to_device": _ONE_HOOK,
}


def _repro_modules():
    """Every module of ``repro`` by its name below the package ("core",
    "core.session", ...), and whether it is a package ``__init__``."""
    base = ROOT / "src" / "repro"
    for path in sorted(base.rglob("*.py")):
        parts = path.relative_to(base).with_suffix("").parts
        if parts[-1] == "__init__":
            yield ".".join(parts[:-1]), True
        else:
            yield ".".join(parts), False


def _param_names(fn):
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    marks = {inspect.Parameter.VAR_POSITIONAL: "*",
             inspect.Parameter.VAR_KEYWORD: "**"}
    return [marks.get(p.kind, "") + p.name for p in sig.parameters.values()
            if p.name not in IGNORED_PARAMS]


def _fields(cls):
    """A class's fields: a NamedTuple's and a dataclass's."""
    import dataclasses

    names = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names.update(f.name for f in dataclasses.fields(cls))
    return names


def _members(cls):
    """A class's own public members, its fields and its constructor."""
    names = {n for n in vars(cls) if not n.startswith("_")} | _fields(cls)
    if "__init__" in vars(cls):
        names.add("__init__")
    return sorted(names)


def _missing_public_names():
    """What ``repro`` exports and the port lacks, as NOT_PORTED's keys."""
    import importlib
    import inspect

    missing = set()

    def compare_params(key, theirs, ours):
        a, b = _param_names(theirs), _param_names(ours)
        if a is not None and b is not None:
            missing.update(f"{key}({p})" for p in a if p not in b)

    for rel, is_package in _repro_modules():
        theirs = importlib.import_module("repro." + rel)
        ours = importlib.import_module(
            "repro_torch." + MODULE_MAP.get(rel, rel))
        names = {}
        for n in dir(theirs):
            obj = getattr(theirs, n)
            if n.startswith("_") or inspect.ismodule(obj):
                continue
            where = getattr(obj, "__module__", None)
            if is_package or (rel == "core.engine"
                              and str(where).startswith("repro.")):
                names[n] = obj           # the package's or engine's API
            elif where == theirs.__name__ or not isinstance(where, str):
                names[n] = obj           # defined here (constants too)
        for n, obj in sorted(names.items()):
            key = f"{rel}:{n}"
            if not hasattr(ours, n):
                missing.add(key)
                continue
            mine = getattr(ours, n)
            if inspect.isclass(obj):
                if obj.__module__ != theirs.__name__:
                    continue         # a re-export: compared where defined
                for m in _members(obj):
                    if not (hasattr(mine, m) or m in _fields(mine)):
                        missing.add(f"{key}.{m}")
                        continue
                    member = inspect.getattr_static(obj, m, None)
                    if isinstance(member, (staticmethod, classmethod)) or \
                            inspect.isfunction(member):
                        compare_params(f"{key}.{m}", getattr(obj, m),
                                       getattr(mine, m))
            elif callable(obj):          # functions, jitted ones too
                compare_params(key, obj, mine)
    return missing


def test_the_port_has_every_public_name_of_repro():
    """Every module of both packages, ``core.jax_backend`` held against
    ``core.torch_backend`` and ``launch.hlo_analysis`` against
    ``launch.roofline``: the names each module defines, every name of each
    package ``__init__``, ``core.engine``'s re-exported block, the public
    members (fields and constructor included) of every public class and the
    parameter names of every public function and method (without ``xp``,
    ``interpret`` and ``device``). What the port lacks is exactly
    NOT_PORTED, each entry with its reason."""
    missing = _missing_public_names()
    assert not missing - set(NOT_PORTED), \
        f"repro exports these and the port lacks them: " \
        f"{sorted(missing - set(NOT_PORTED))}"
    assert not set(NOT_PORTED) - missing, \
        f"the port has these now; drop them from NOT_PORTED: " \
        f"{sorted(set(NOT_PORTED) - missing)}"


def test_the_readme_gives_each_reason_for_what_is_not_ported():
    readme = " ".join((ROOT / "README.md").read_text().split())
    section = readme[readme.index("**Not ported.**"):]
    for reason in sorted(set(NOT_PORTED.values())):
        assert reason in section, reason
    for key in NOT_PORTED:
        name = key.split(":")[1].split("(")[0].split(".")[-1]
        assert f"`{name}" in section or name in section, key
