"""Gemma-2 9B: 42L, d=3584, 16H (GQA kv=8, head_dim=256), d_ff=14336, vocab
256000, alternating local(4096-window)/global attention, attention softcap 50
and final-logit softcap 30, tied embeddings. [arXiv:2408.00118]"""
from repro_torch.models.config import ArchConfig, LayerSpec

_PERIOD = (
    LayerSpec(mixer="attn", window=4096, ffn="dense"),   # local
    LayerSpec(mixer="attn", window=0, ffn="dense"),      # global
)

config = ArchConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    pattern=_PERIOD,
    softcap_attn=50.0,
    softcap_final=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
