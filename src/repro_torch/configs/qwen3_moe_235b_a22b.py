"""Qwen3-235B-A22B: 94L, d=4096, 64H (GQA kv=4, head_dim=128), MoE 128
experts top-8 with expert d_ff=1536, vocab 151936, QK-norm, no QKV bias.
[hf:Qwen/Qwen3-30B-A3B family scaling]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    d_ff_expert=1536,
    num_experts=128,
    top_k=8,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
