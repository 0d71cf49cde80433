"""chameleon-34b [vlm] — early fusion, VQ image tokens share the text vocab
[arXiv:2405.09818].

Early fusion means images arrive as discrete VQ-VAE codes inside the same
token stream, so the backbone is a plain decoder; the VQ tokenizer itself is
the sanctioned stub (input_specs() provides mixed text+image token ids)."""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family=Family.VLM,
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    activation=Activation.SWIGLU,
    tie_embeddings=False,
    source="arXiv:2405.09818 (Chameleon)",
)
