"""meshgraphnet [gnn]: 15 processor blocks, d_hidden=128, sum aggregator,
2-layer MLPs [arXiv:2010.03409]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet", kind="meshgraphnet", n_layers=15, d_hidden=128,
    d_feat=0, aggregator="sum", mlp_layers=2,
)
SMOKE_CONFIG = GNNConfig(
    name="meshgraphnet-smoke", kind="meshgraphnet", n_layers=3, d_hidden=16,
    d_feat=8, aggregator="sum", mlp_layers=2, n_classes=4,
)
