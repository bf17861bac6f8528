"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_head=128, d_ff=19200, vocab=32256, rope_theta=1e5,
)
SMOKE_CONFIG = LMConfig(
    name="deepseek-coder-33b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=128, dtype="float32",
)
