"""Qwen2.5-3B: 36L, d=2048, 16H (GQA kv=2), d_ff=11008, vocab 151936, QKV
bias, tied embeddings. [hf:Qwen/Qwen2.5-0.5B family scaling]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)
