"""xLSTM-125M: 12L, d=768, 4 heads, sLSTM + mLSTM blocks (d_ff=0: mixers have
internal up-projections, no separate FFN), vocab 50304. [arXiv:2405.04517]

Period of 4: three mLSTM blocks then one sLSTM block (3 sLSTM layers total).
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_PERIOD = (
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="slstm", ffn="none"),
)

config = ArchConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=_PERIOD,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
