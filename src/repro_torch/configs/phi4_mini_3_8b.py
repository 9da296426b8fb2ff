"""Phi-4-mini (3.8B): 32L, d=3072, 24H (GQA kv=8), d_ff=8192, vocab 200064,
RoPE + SwiGLU + GQA. [arXiv:2412.08905]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    tie_embeddings=True,
    source="arXiv:2412.08905",
)
