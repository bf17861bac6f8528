"""gcn-cora [gnn]: 2L d_hidden=16 mean aggregator, symmetric norm
[arXiv:1609.02907; paper]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16, d_feat=0,
    aggregator="mean", n_classes=7,
)
SMOKE_CONFIG = GNNConfig(
    name="gcn-cora-smoke", kind="gcn", n_layers=2, d_hidden=8, d_feat=8,
    aggregator="mean", n_classes=4,
)
