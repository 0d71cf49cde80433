"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295]."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family=Family.DENSE,
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    activation=Activation.GEGLU,
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
)
