"""Llama-3 405B: 126L, d=16384, 128H (GQA kv=8), d_ff=53248, vocab 128256,
RoPE theta 5e5. [arXiv:2407.21783]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
