"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

xLSTM[7:1]-style mix: predominantly mLSTM (matrix memory, fully
parallelizable) with periodic sLSTM (scalar memory with hidden mixing);
d_ff=0 — blocks carry their own up/down projections."""
from ..models.config import Activation, BlockKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family=Family.SSM,
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM, BlockKind.MLSTM,
                   BlockKind.SLSTM),
    tie_embeddings=True,
    source="arXiv:2405.04517 (xLSTM)",
)
