"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm [hf:Qwen/Qwen3-14B]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_head=128, d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
)
SMOKE_CONFIG = LMConfig(
    name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=128, qk_norm=True, dtype="float32",
)
