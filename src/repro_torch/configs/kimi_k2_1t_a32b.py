"""Kimi K2: 61L, d=7168, 64H (GQA kv=8), MoE 384 experts top-8 with expert
d_ff=2048, vocab 163840 — trillion-parameter MoE. [arXiv:2501.kimi2]
Deviation: K2's dense first layer and shared expert are folded into the
uniform MoE pattern (noted in DESIGN.md).
Its attention, 64 heads of 7168 / 64 = 112 on 8 KV heads, is the JAX
package's GQA stand-in for K2's multi-head latent attention, not a
published width; the source id is the JAX package's placeholder."""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,
    d_ff_expert=2048,
    num_experts=384,
    top_k=8,
    vocab_size=163840,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    rope_theta=1_000_000.0,
    source="arXiv:2501.kimi2",
)
