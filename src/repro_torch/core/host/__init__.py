"""The CPU reference family's step as a NumPy program.

A NumPy-only copy of the JAX package's array-module polymorphic core with
the array module fixed to ``numpy``: the counter RNG and SplitMix64
(:mod:`.rng`), the call auction (:mod:`.auction`), the eight archetypes and
``decide`` (:mod:`.agents`), the ``stats_only`` accumulators
(:mod:`.stats`), the step with ``np.add.at`` binning (:mod:`.step`) and the
sequential-clearing mechanism (:mod:`.sequential`). Each module keeps the
name of its counterpart in the JAX package.

These modules import ``numpy`` and each other, nothing else: no ``torch``,
so the reference is independent of the torch step that the kernels' plain
versions and the ``torch-*`` backends run.
:mod:`repro_torch.core.numpy_backend` turns the session's CPU tensors into
arrays at a chunk's entry and back at its exit.
"""
