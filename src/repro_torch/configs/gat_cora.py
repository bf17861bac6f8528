"""gat-cora [gnn]: 2L d_hidden=8 n_heads=8 attention aggregator
[arXiv:1710.10903; paper]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gat-cora", kind="gat", n_layers=2, d_hidden=8, n_heads=8,
    d_feat=0, aggregator="attn", n_classes=7,
)
SMOKE_CONFIG = GNNConfig(
    name="gat-cora-smoke", kind="gat", n_layers=2, d_hidden=4, n_heads=2,
    d_feat=8, aggregator="attn", n_classes=4,
)
