"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family=Family.MOE,
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    activation=Activation.GEGLU,
    n_experts=8, top_k=2,
    tie_embeddings=False,
    source="hf:xai-org/grok-1 (model card)",
    fsdp_weights=True,      # 314B total params
)
