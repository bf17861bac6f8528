"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) MoE 64e top-8
d_ff_expert=1024 vocab=50304 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_head=128, d_ff=0, vocab=50304,
    moe=MoESpec(n_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=1e4,
)
SMOKE_CONFIG = LMConfig(
    name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=0, vocab=128, moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=64),
    dtype="float32",
)
