"""llama-13b [dense] — the paper's own primary evaluation model
(§5.1.1, hf:meta-llama/Llama-2-13b)."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="llama-13b", family=Family.DENSE,
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=13824, vocab_size=32000, head_dim=128,
    activation=Activation.SWIGLU,
    tie_embeddings=False,
    source="BanaServe §5.1.1 / hf:meta-llama/Llama-2-13b",
)
