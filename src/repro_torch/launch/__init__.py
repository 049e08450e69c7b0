"""Market-axis sharding of the port: the mesh, its placement rules, the
card's model and the roofline.

The counterpart of ``repro.launch`` (``mesh``, ``sharding``,
``hlo_analysis``). One process drives every device of a
:class:`MarketsMesh`; ``Engine("cuda-kinetic", devices=N)`` or ``mesh=``
cut each chunk's rows over it (see :mod:`repro_torch.kernels.ops`).
:class:`Roofline` counts the operations, bytes and cross-device bytes of
what runs inside it, per device (:mod:`repro_torch.launch.roofline`).
"""
from repro_torch.launch.mesh import (  # noqa: F401 (re-exported API)
    HW,
    MarketsMesh,
    make_markets_mesh,
    set_host_device_count,
)
from repro_torch.launch.roofline import (  # noqa: F401
    Roofline,
    analyze,
    bound,
    summarize,
    top_contributors,
)
from repro_torch.launch.sharding import (  # noqa: F401
    market_sharding,
    replicate_tree,
    replicated_sharding,
)
