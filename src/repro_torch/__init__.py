"""KineticSim in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (kept as the reference). It imports
``torch`` and never ``jax`` or ``repro``. Entry points take an explicit
``device`` (default ``"cuda"``); ``device="cpu"`` runs each kernel's plain
PyTorch version. The main path is
``repro_torch.core.session.Engine("cuda-kinetic").open(spec).run(n)``.
"""
