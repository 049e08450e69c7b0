"""Coupled multi-asset scenarios over the port's engine.

  * :mod:`repro_torch.scenario.coupling` — :class:`CouplingSpec`, the
    cross-market arbitrage graph lowered onto the ``coupling_peer`` params
    column (a gather at each chunk entry).
  * :mod:`repro_torch.scenario.validate` — the stylized-facts validation
    gate: typed :class:`FactCheck` / :class:`ValidationReport` results over
    the pinned mixtures, on ``cuda-kinetic`` by default.
  * :mod:`repro_torch.scenario.sequential` — the sequential-clearing
    reference (Steinbacher et al.) and the parallel-vs-sequential
    mechanism-gap report, on the host-only ``numpy`` family.

Applying a coupling, swapping a mixture, or validating a scenario changes
values only: a warm engine builds nothing more.
"""
from repro_torch.scenario.coupling import CouplingSpec, coupled_ensemble
from repro_torch.scenario.sequential import (
    mechanism_gap,
    simulate_reference_sequential,
    simulate_step_sequential,
)
from repro_torch.scenario.validate import (
    PINNED_MIXTURES,
    FactCheck,
    ValidationReport,
    stylized_facts,
    validate_pinned,
    validate_spec,
)

__all__ = [
    "CouplingSpec",
    "coupled_ensemble",
    "mechanism_gap",
    "simulate_reference_sequential",
    "simulate_step_sequential",
    "PINNED_MIXTURES",
    "FactCheck",
    "ValidationReport",
    "stylized_facts",
    "validate_pinned",
    "validate_spec",
]
