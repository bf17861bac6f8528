"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_head=128, d_ff=16384, vocab=92544, rope_theta=1e6,
)
SMOKE_CONFIG = LMConfig(
    name="internlm2-20b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=128, dtype="float32",
)
