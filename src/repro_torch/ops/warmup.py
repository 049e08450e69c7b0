"""Warm start: build and launch every runner a server needs before traffic.

The first chunk of a kernel backend pays the build: ``nvcc`` on first use
(then the on-disk build in ``kernels/_build/``), the library load, the
runner's construction and the kernel's first launch. ``Engine.warm(specs)``
(delegating here) builds each ``(static_key, chunk)`` runner and launches
it once on throwaway buffers, so the first request builds nothing:

    eng = Engine("cuda-kinetic")
    eng.warm([spec])              # builds and launches (M, A, L, seed) x chunk
    eng.readiness().ready         # -> True
    with eng.open(spec) as s:     # first request: trace_count unchanged
        s.run(...)

``readiness()`` is the probe: which runners are built and launched (the
eager baselines build nothing and are always ready), the shape a serving
layer's health endpoint needs.
"""
from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Optional, Sequence, Tuple, Union


class KeyReadiness(NamedTuple):
    """Warm/cold status of one cached runner."""

    static_key: Tuple[Any, ...]   # EnsembleSpec.static_key(): (M, A, L, seed)
    chunk: int
    warm: bool                    # launched once (or nothing to launch)
    traces: int                   # the runner's trace_count


class Readiness(NamedTuple):
    """Aggregate probe result: ``ready`` iff every known key is warm.

    An engine with no cached runners reports ``ready=True`` vacuously:
    probe after :func:`warm` (or after opening the serving specs).
    """

    ready: bool
    entries: Tuple[KeyReadiness, ...]

    def warm_keys(self) -> Tuple[Tuple[Any, ...], ...]:
        return tuple(e.static_key + (e.chunk,) for e in self.entries if e.warm)

    def cold_keys(self) -> Tuple[Tuple[Any, ...], ...]:
        return tuple(e.static_key + (e.chunk,)
                     for e in self.entries if not e.warm)


def _warm_runner(runner, spec) -> None:
    """Launch a kernel runner once on fresh buffers (discarded), so no live
    session is touched. Eager runners and launched runners are left alone."""
    if not runner.compiled or runner.launched:
        return
    runner.run(runner.init_state(spec), runner.params_to_device(spec.params),
               0, runner.chunk, None, runner.init_stats(spec))


def warm(engine, specs: Union[Any, Sequence[Any]], *,
         chunk_sizes: Optional[Iterable[int]] = None,
         include_step: bool = True) -> Readiness:
    """Build and launch every ``(static_key, chunk)`` runner for ``specs``.

    ``specs`` is one spec/config or a sequence of them. For each, the
    engine's default chunk is warmed, plus the ``chunk=1`` runner
    :meth:`Session.step` uses (``include_step``), plus any explicit
    ``chunk_sizes``. Returns the post-warm :func:`readiness` probe.
    """
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.session import DEFAULT_CHUNK

    if not isinstance(specs, (list, tuple)):
        specs = [specs]
    for spec in specs:
        spec = EnsembleSpec.coerce(spec)
        chunks = {engine.chunk_size or min(DEFAULT_CHUNK, spec.num_steps)}
        if include_step:
            chunks.add(1)
        for c in chunk_sizes or ():
            chunks.add(int(c))
        for c in sorted(chunks):
            _warm_runner(engine._runner(spec, max(1, c)), spec)
    return readiness(engine)


def readiness(engine) -> Readiness:
    """Probe which of the engine's cached runners are warm: built and
    launched once, or with nothing to launch (the eager baselines)."""
    entries = []
    for key, runner in engine._runners.items():
        entries.append(KeyReadiness(
            static_key=key[:-1], chunk=key[-1],
            warm=(not runner.compiled) or runner.launched,
            traces=runner.trace_count))
    return Readiness(ready=all(e.warm for e in entries),
                     entries=tuple(entries))
