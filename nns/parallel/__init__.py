from nns.parallel.mesh import make_mesh, best_mesh  # noqa: F401
from nns.parallel.sharded import (  # noqa: F401
    nns_sharded,
    sharded_argmin,
    sharded_argmin_2d,
)
from nns.parallel.ring import nns_ring, ring_argmin  # noqa: F401
from nns.parallel.sharded_cells import (  # noqa: F401
    ShardedCellEngine,
    nns_sharded_cells,
)
