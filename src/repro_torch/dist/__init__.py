"""The dist plane on ``torch.distributed``: the edge-sharded Spade engine
(:mod:`repro_torch.dist.graph`), :func:`spawn`, which starts a job's ranks
on one host, the error-feedback int8 gradient compression
(:mod:`repro_torch.dist.compression`) and the logical-axis sharding layer
on ``DeviceMesh`` (:mod:`repro_torch.dist.sharding`)."""

from .compression import compress_grads, dequantize_int8, ef_compress_tree, quantize_int8
from .graph import (
    STATS,
    TIME_REDUCES,
    ShardedGraph,
    init_sharded_state,
    reset_stats,
    shard_graph,
    sharded_bulk_peel,
    sharded_bulk_peel_warm,
    sharded_bulk_peel_warm_workset,
    sharded_delete_and_maintain,
    sharded_full_refresh,
    sharded_insert_and_maintain,
    sharded_insert_and_maintain_auto,
    sharded_insert_and_maintain_predictive,
    sharded_peel_weights,
    sharded_slide_and_maintain,
    sharded_slide_and_maintain_auto,
    sharded_slide_and_maintain_predictive,
    sharded_workset_sizes,
    unshard_graph,
)
from .sharding import AxisEnv, axis_env, constrain, tree_shardings, use_axis_env
from .spawn import spawn

__all__ = [
    "compress_grads",
    "dequantize_int8",
    "ef_compress_tree",
    "quantize_int8",
    "STATS",
    "TIME_REDUCES",
    "ShardedGraph",
    "init_sharded_state",
    "unshard_graph",
    "reset_stats",
    "shard_graph",
    "sharded_bulk_peel",
    "sharded_bulk_peel_warm",
    "sharded_bulk_peel_warm_workset",
    "sharded_delete_and_maintain",
    "sharded_full_refresh",
    "sharded_insert_and_maintain",
    "sharded_insert_and_maintain_auto",
    "sharded_insert_and_maintain_predictive",
    "sharded_peel_weights",
    "sharded_slide_and_maintain",
    "sharded_slide_and_maintain_auto",
    "sharded_slide_and_maintain_predictive",
    "sharded_workset_sizes",
    "spawn",
    "AxisEnv",
    "axis_env",
    "constrain",
    "tree_shardings",
    "use_axis_env",
]
