"""two-tower-retrieval [recsys]: embed_dim=256, tower MLP 1024-512-256,
dot interaction, sampled-softmax retrieval [RecSys'19 (YouTube)].
Embedding tables row-sharded over ('data','model')."""
from repro_torch.configs.base import RecsysConfig

# vocabs padded to multiples of 256 so the row-sharded tables divide the
# ('data','model') axes exactly (50M / 10M rounded up by 128 rows)
CONFIG = RecsysConfig(
    name="two-tower-retrieval", embed_dim=256, tower_mlp=(1024, 512, 256),
    n_user_fields=8, n_item_fields=4, user_vocab=50_000_128,
    item_vocab=10_000_128, multi_hot=16,
)
SMOKE_CONFIG = RecsysConfig(
    name="two-tower-retrieval-smoke", embed_dim=16, tower_mlp=(32, 16),
    n_user_fields=3, n_item_fields=2, user_vocab=1000, item_vocab=500,
    multi_hot=4,
)
