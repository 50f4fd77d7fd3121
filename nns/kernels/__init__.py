from nns.kernels.oracle import (  # noqa: F401
    linear_scan,
    nn_oracle_f64,
    recall_at_1,
)
from nns.kernels.xla_bruteforce import (  # noqa: F401
    nns_distance_matrix,
    nns_expansion_matmul,
)
from nns.kernels.pallas_fused import (  # noqa: F401
    FusedBruteForce,
    fused_fallback,
    nns_fused,
)
from nns.kernels.cell_list import (  # noqa: F401
    CellListEngine,
    nns_cell_list,
)
from nns.kernels.topk import nns_topk  # noqa: F401
