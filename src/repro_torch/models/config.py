"""Model configuration covering every assigned architecture family.

One dataclass describes dense GQA decoders, MoE decoders, encoder-decoder
(audio) backbones, RG-LRU hybrids, early-fusion VLMs and xLSTM stacks.  Each
layer of the stack is described by a ``block pattern`` entry so heterogeneous
stacks (RecurrentGemma's 2:1 recurrent:attention pattern, xLSTM's
mLSTM/sLSTM mix) are first-class.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Optional, Sequence, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    AUDIO = "audio"      # enc-dec backbone over precomputed frame embeddings
    HYBRID = "hybrid"    # RG-LRU + local attention (Griffin/RecurrentGemma)
    VLM = "vlm"          # early fusion, VQ image tokens share the vocab
    SSM = "ssm"          # xLSTM (mLSTM + sLSTM blocks)


class BlockKind(str, enum.Enum):
    ATTENTION = "attention"          # global self attention
    LOCAL_ATTENTION = "local_attn"   # sliding-window self attention
    RGLRU = "rglru"                  # real-gated linear recurrent unit block
    MLSTM = "mlstm"                  # matrix-memory LSTM block
    SLSTM = "slstm"                  # scalar-memory LSTM block


class Activation(str, enum.Enum):
    SWIGLU = "swiglu"
    GEGLU = "geglu"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    activation: Activation = Activation.SWIGLU
    # Attention details
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # local attention window (tokens)
    logit_soft_cap: Optional[float] = None
    # Pattern of block kinds, tiled to n_layers.  Default: all global attention.
    block_pattern: Tuple[BlockKind, ...] = (BlockKind.ATTENTION,)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # Encoder-decoder (audio): cross attention over n_frames stub embeddings
    cross_attention: bool = False
    n_frames: int = 0                          # encoder-output length stub
    # RG-LRU / recurrent
    rglru_conv_width: int = 4
    local_window: int = 2048                   # window for LOCAL_ATTENTION blocks
    # Norm / embedding
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    # Source citation (model card / paper)
    source: str = ""
    # Sharding hint: shard weight "in" dims over the data axis too (ZeRO-3 /
    # FSDP style) for models that do not fit HBM with pure tensor parallelism.
    fsdp_weights: bool = False
    # Beyond-paper serving optimization: store the attention KV cache in int8
    # with per-(token, head) scales (~2x KV memory/bandwidth at decode).
    kv_quant: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads {self.n_heads} not divisible by "
            f"n_kv_heads {self.n_kv_heads}")
        # the config keys every lru-cached cost function in core/analytical;
        # recomputing the generated field-tuple hash per lookup shows up in
        # 10^5-event simulation profiles, so compute it once
        object.__setattr__(self, "_hash", hash(tuple(
            getattr(self, f.name) for f in dataclasses.fields(self))))

    def __hash__(self) -> int:
        return self._hash

    # -- derived -------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @functools.lru_cache(maxsize=None)
    def blocks(self) -> Tuple[BlockKind, ...]:
        """The per-layer block kinds, pattern tiled out to n_layers.

        Memoized (the config is frozen/hashable): the analytical cost
        model calls this per simulator event, and at 10^5-request fleet
        scale the repeated tuple tiling dominates the sim's own runtime."""
        pat = self.block_pattern
        reps = math.ceil(self.n_layers / len(pat))
        return tuple((pat * reps)[: self.n_layers])

    @property
    def uses_kv_cache(self) -> bool:
        return any(b in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION)
                   for b in self.blocks())

    @property
    def uses_recurrent_state(self) -> bool:
        return any(b in (BlockKind.RGLRU, BlockKind.MLSTM, BlockKind.SLSTM)
                   for b in self.blocks())

    @property
    def sub_quadratic(self) -> bool:
        """True when no block attends over unbounded global context."""
        return all(b != BlockKind.ATTENTION for b in self.blocks()) or (
            self.sliding_window is not None)

    @functools.lru_cache(maxsize=None)
    def kv_cache_len(self, seq_len: int) -> int:
        """Physical KV-cache length for attention blocks at context seq_len."""
        windows = [self.local_window] * any(
            b == BlockKind.LOCAL_ATTENTION for b in self.blocks())
        if self.sliding_window is not None:
            windows.append(self.sliding_window)
        if windows and not any(b == BlockKind.ATTENTION for b in self.blocks()):
            return min(seq_len, max(windows))
        if self.sliding_window is not None:
            return min(seq_len, self.sliding_window)
        return seq_len

    # -- parameter counting (for roofline / migration cost models) ------
    @functools.lru_cache(maxsize=None)
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_layer = 0
        for kind in self.blocks():
            if kind in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION):
                attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
                per_layer_ffn = self._ffn_params()
                per_layer += attn + per_layer_ffn + 2 * d
                if self.cross_attention:
                    per_layer += attn + d
            elif kind == BlockKind.RGLRU:
                # in/out proj + gates + conv
                per_layer += 2 * d * d + 2 * d * d + self.rglru_conv_width * d
                per_layer += self._ffn_params() + 2 * d
            elif kind == BlockKind.MLSTM:
                # qkv + gates + up/down proj (factor-2 inner dim)
                inner = 2 * d
                per_layer += d * inner + 3 * inner * hd * max(self.n_heads, 1)
                per_layer += inner * d + 2 * d
            elif kind == BlockKind.SLSTM:
                per_layer += 4 * d * d + 4 * d * d + 2 * d
        embed = self.vocab_size * d
        total = per_layer + embed + d
        if not self.tie_embeddings:
            total += embed
        return total

    def _ffn_params(self) -> int:
        if self.d_ff == 0:
            return 0
        if self.n_experts > 0:
            return self.n_experts * 3 * self.d_model * self.d_ff + \
                self.d_model * self.n_experts  # router
        return 3 * self.d_model * self.d_ff    # gated MLP (gate, up, down)

    @functools.lru_cache(maxsize=None)
    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(1 for b in self.blocks()
                           if b in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION))
        expert_p = 3 * self.d_model * self.d_ff
        inactive = n_moe_layers * (self.n_experts - self.top_k) * expert_p
        return full - inactive

    # -- per-token KV bytes (paper Eq. 15/16) ----------------------------
    def kv_bytes_per_token_per_layer(self,
                                     dtype_bytes: Optional[int] = None
                                     ) -> int:
        """K+V bytes one token adds per attention layer.  With
        ``dtype_bytes=None`` the config's own storage format decides:
        int8 caches (``kv_quant``) pay 1 byte per element plus one f32
        scale per (token, head) per K and V — roughly half the bf16 cost —
        so hand-off, migration and store billings all see the quantized
        wire size.  An explicit ``dtype_bytes`` overrides (legacy
        callers / what-if sweeps)."""
        if dtype_bytes is None:
            if self.kv_quant:
                return self.n_kv_heads * (self.head_dim * 1 + 4) * 2
            dtype_bytes = 2
        return self.n_kv_heads * self.head_dim * 2 * dtype_bytes

    @functools.lru_cache(maxsize=None)
    def kv_bytes_per_token(self, dtype_bytes: Optional[int] = None) -> int:
        n_attn = sum(1 for b in self.blocks()
                     if b in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION))
        return n_attn * self.kv_bytes_per_token_per_layer(dtype_bytes)

    # -- reduced variant for CPU smoke tests -----------------------------
    def smoke(self) -> "ModelConfig":
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, len(self.block_pattern)) if len(self.block_pattern) > 1 else 2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=max(d // heads, 8),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            local_window=min(self.local_window, 64),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            fsdp_weights=False,
        )

    def replicate_small(self) -> bool:
        """Tiny models replicate weights entirely (see launch.sharding)."""
        return self.param_count() * 2 < int(1.5e9)

    def with_sliding_window(self, window: int) -> "ModelConfig":
        """Beyond-paper long-context variant for dense archs (long_500k)."""
        return dataclasses.replace(
            self, name=self.name + f"-swa{window}", sliding_window=window)

    def with_kv_quant(self) -> "ModelConfig":
        return dataclasses.replace(
            self, name=self.name + "-kvq8", kv_quant=True)
