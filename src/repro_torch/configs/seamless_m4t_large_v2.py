"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596].

The speech frontend (mel filterbank + conv feature extractor / w2v-BERT
encoder) is the sanctioned STUB: input_specs() provides precomputed frame
embeddings (B, n_frames, d_model); this config is the text decoder that
cross-attends to them.
"""
from ..models.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family=Family.AUDIO,
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    activation=Activation.SWIGLU,
    cross_attention=True, n_frames=512,
    tie_embeddings=False,
    source="arXiv:2308.11596 (SeamlessM4T)",
)
