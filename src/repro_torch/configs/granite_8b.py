"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324]."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family=Family.DENSE,
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152, head_dim=128,
    activation=Activation.SWIGLU,
    tie_embeddings=False,
    source="arXiv:2405.04324 (Granite Code Models)",
)
