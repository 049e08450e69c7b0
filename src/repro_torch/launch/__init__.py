"""Market-axis sharding of the port: the mesh and its placement rules.

The counterpart of ``repro.launch`` (``mesh``, ``sharding``). One process
drives every device of a :class:`MarketsMesh`; ``Engine("cuda-kinetic",
devices=N)`` or ``mesh=`` cut each chunk's rows over it (see
:mod:`repro_torch.kernels.ops`).
"""
from repro_torch.launch.mesh import (  # noqa: F401 (re-exported API)
    MarketsMesh,
    make_markets_mesh,
    set_host_device_count,
)
from repro_torch.launch.sharding import (  # noqa: F401
    market_sharding,
    replicate_tree,
    replicated_sharding,
)
