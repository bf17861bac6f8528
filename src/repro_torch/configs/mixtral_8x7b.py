"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) MoE 8e top-2
d_ff_expert=14336 vocab=32000, sliding-window attention (W=4096)
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=0, vocab=32000,
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=14336, expert_parallel=True,
                virtual_split=2),  # 8 experts x 2-way d_ff split = 16 expert shards
    sliding_window=4096, rope_theta=1e6,
)
SMOKE_CONFIG = LMConfig(
    name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=0, vocab=128, moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=96, expert_parallel=True, virtual_split=2),
    sliding_window=16, dtype="float32",
)
