"""Jamba v0.1 (52B): 32L, d=4096, 32H (GQA kv=8), d_ff=14336, MoE 16 experts
top-2, vocab 65536. Mamba:attention 7:1 interleave, MoE every other layer.
[arXiv:2403.19887]

Period of 8 layers: attention at position 4, Mamba elsewhere; MoE FFN on odd
positions, dense FFN on even — 4 periods = 32 layers.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

config = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    d_ff_expert=14336,
    num_experts=16,
    top_k=2,
    vocab_size=65536,
    pattern=_PERIOD,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2403.19887",
)
