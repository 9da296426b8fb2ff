"""Architecture configuration (port of `repro.models.config`).

The same dataclasses with the same field names and defaults: a model is a
cycle of ``LayerSpec``s (the *pattern*) repeated ``num_layers /
len(pattern)`` times, and the parameters of each pattern position are
stacked over the repeats (periods).  ``reduced()`` is the ≤ 2-period,
d_model ≤ 128 variant the CPU tests run.  Dtypes are strings, resolved to
``torch.dtype`` by ``pdtype`` and ``cdtype``.  The port's transformer runs
the dense attention decoder; `repro_torch.configs` registers only the
configurations it can run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn | mamba | mlstm | slstm
    window: int = 0            # sliding-window size for attn (0 = full)
    ffn: str = "dense"         # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                      # dense|moe|hybrid|ssm|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: Optional[int] = None

    # MoE
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_shards: int = 1

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    rope_theta: float = 10000.0

    # SSM (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0

    # encoder-decoder (audio) / prefix (vlm)
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: str = "none"              # none | audio_stub | vision_stub
    frontend_dim: int = 0
    prefix_tokens: int = 0

    # numerics / structure
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # The JAX package's compilation and sharding knobs, kept so that a
    # configuration carries across field for field; the port's eager
    # Python loop over periods reads none of them.
    scan_layers: bool = True
    unroll_loops: bool = False
    attn_chunk: int = 512
    attn_gqa_repeat: bool = False
    ssm_chunk: int = 256
    mlstm_chunk: int = 256
    remat: bool = False
    act_spec: Optional[Tuple[Optional[str], ...]] = None

    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: ≤2 pattern periods (but full pattern), tiny
        dims (d_model ≤ 128, ≤ 4 experts), CPU-friendly."""
        period = len(self.pattern)
        d_model = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, max(1, heads // 2))
        heads = (heads // kv) * kv  # keep divisibility
        moe = self.num_experts > 0
        return self.replace(
            num_layers=period if period > 2 else 2 * period,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=None,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            d_ff_expert=min(self.d_ff_expert, 128) if moe else 0,
            num_experts=min(self.num_experts, 4) if moe else 0,
            top_k=min(self.top_k, 2) if moe else 0,
            capacity_factor=(min(self.num_experts, 4) / min(self.top_k, 2)
                             if moe else self.capacity_factor),
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            prefix_tokens=(min(self.prefix_tokens, 8)
                           if self.prefix_tokens else 0),
            frontend_dim=(min(self.frontend_dim, 64)
                          if self.frontend_dim else 0),
            attn_chunk=64,
            ssm_chunk=32,
            mlstm_chunk=32,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
