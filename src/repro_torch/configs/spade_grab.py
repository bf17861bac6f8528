"""spade-grab: the paper's own workload — evolving-graph dense-subgraph
maintenance at Grab4 scale (6.02M vertices / 25M base edges + 2.5M
increments, Table 3), as a device-plane streaming cell."""
from repro_torch.configs.base import SpadeConfig

# max_rounds: bulk peeling converges in 5-7 rounds on power-law graphs from
# 20k to 400k edges with planted dense blocks — 20 gives ~3x headroom at
# Grab scale; unconverged vertices take the final round's level and the
# periodic full_refresh (run to completion) corrects.
CONFIG = SpadeConfig(
    name="spade-grab", n_capacity=6_023_000, e_capacity=27_500_000,
    batch_edges=4096, eps=0.1, max_rounds=20,
)
SMOKE_CONFIG = SpadeConfig(
    name="spade-grab-smoke", n_capacity=512, e_capacity=4096,
    batch_edges=64, eps=0.1, max_rounds=16,
)
