"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family=Family.MOE,
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    activation=Activation.SWIGLU,
    n_experts=40, top_k=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (model card)",
)
