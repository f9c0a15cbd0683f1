"""Several shards and processes: the mesh's sharded sweeps (:mod:`.mesh`)
and the process group on ``torch.distributed`` (:mod:`.distributed`)."""

from .mesh import (  # noqa: F401
    FleetPlan,
    MeshPlan,
    lut5_fused_step,
    make_fleet_mesh,
    make_mesh,
    sharded_feasible_stream,
    sharded_pivot_stream,
)
from . import distributed  # noqa: F401
