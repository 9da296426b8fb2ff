"""Whisper-tiny: encoder-decoder, 4L each, d=384, 6H (kv=6), d_ff=1536, vocab
51865. Conv/mel frontend is a STUB: input_specs provides 1500 frames of dim
80 (post-conv sequence length), projected into d_model by the encoder.
[arXiv:2212.04356]"""
from repro_torch.models.config import ArchConfig, LayerSpec

config = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    frontend_dim=80,
    norm="layernorm",
    source="arXiv:2212.04356",
)
