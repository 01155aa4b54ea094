"""Multi-device stages 1 and 2 on ``torch.distributed`` (port of
``bridged_gnn_tpu/parallel``): process groups (``multihost``, ``mesh``),
the halo row partition (``halopart``), the edge-shard layout
(``edgeshard``), the stage-2 trainer's backends (``stage2_runtime``),
the collectives they differentiate through (``collectives``), stage 1's
row placement and the edge-span placement (``gspmd``) and the bridge's
sharded top-k (``topk``)."""

from bridged_gnn_tpu_torch.parallel.edgeshard import (  # noqa: F401
    pad_graph_edges_for_sharding,
    sharded_spmm,
)
from bridged_gnn_tpu_torch.parallel.halopart import (  # noqa: F401
    build_halo_partition,
    wire_bytes_per_layer,
)
from bridged_gnn_tpu_torch.parallel.mesh import make_group  # noqa: F401
from bridged_gnn_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    spawn,
)
from bridged_gnn_tpu_torch.parallel.topk import (  # noqa: F401
    sharded_pair_topk,
)
