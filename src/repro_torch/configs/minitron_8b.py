"""minitron-8b [dense] — pruned Nemotron [arXiv:2407.14679]."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    activation=Activation.SWIGLU,
    tie_embeddings=False,
    source="arXiv:2407.14679 (Compact Language Models via Pruning and "
           "Knowledge Distillation)",
)
