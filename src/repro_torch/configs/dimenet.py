"""dimenet [gnn]: 6 interaction blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6 [arXiv:2003.03123].  Triplets are capped per
edge at scale (GemNet-style subsampling; DESIGN.md 4)."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="dimenet", kind="dimenet", n_layers=6, d_hidden=128, d_feat=0,
    n_bilinear=8, n_spherical=7, n_radial=6, triplet_cap_per_edge=4,
)
SMOKE_CONFIG = GNNConfig(
    name="dimenet-smoke", kind="dimenet", n_layers=2, d_hidden=16, d_feat=8,
    n_bilinear=4, n_spherical=3, n_radial=4, triplet_cap_per_edge=3, n_classes=4,
)
