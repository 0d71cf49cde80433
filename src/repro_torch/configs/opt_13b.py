"""opt-13b [dense] — the paper's cross-architecture validation model
(§5.1.1, hf:facebook/opt-13b).  Modeled with the shared decoder substrate
(RoPE/RMSNorm in place of OPT's learned-positional/LayerNorm — serving-path
equivalent: same shapes, same KV footprint).  OPT's 2-matrix ReLU FFN
(d_ff=20480) is mapped to the gated 3-matrix substrate at d_ff=13696 so the
FFN parameter/FLOP count matches (3*13696 ~= 2*20480)."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="opt-13b", family=Family.DENSE,
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=13696, vocab_size=50272, head_dim=128,
    activation=Activation.SWIGLU,
    tie_embeddings=True,
    source="BanaServe §5.1.1 / hf:facebook/opt-13b",
)
