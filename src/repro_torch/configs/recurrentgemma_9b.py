"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427 (Griffin)]."""
from ..models.config import Activation, BlockKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family=Family.HYBRID,
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    activation=Activation.GEGLU,
    block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                   BlockKind.LOCAL_ATTENTION),
    local_window=2048, rglru_conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
)
