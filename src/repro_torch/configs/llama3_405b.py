"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from ..models.config import Activation, BlockKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family=Family.DENSE,
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    activation=Activation.SWIGLU, rope_theta=500_000.0,
    tie_embeddings=False,
    source="arXiv:2407.21783 (The Llama 3 Herd of Models)",
    fsdp_weights=True,      # 405B bf16 = 810 GB: must shard over both axes
)
