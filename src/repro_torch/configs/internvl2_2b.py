"""InternVL2-2B: InternLM2-1.8B language decoder (24L, d=2048, 16H GQA kv=8,
d_ff=8192, vocab 92553) consuming InternViT patch embeddings through an MLP
projector. Vision encoder is a STUB: input_specs provides 256 precomputed
patch embeddings of dim 1024 (448px / 14 patch, 0.5 pixel-shuffle).
[arXiv:2404.16821]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="internvl2-2b",
    arch_type="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="vision_stub",
    frontend_dim=1024,
    prefix_tokens=256,
    source="arXiv:2404.16821",
)
