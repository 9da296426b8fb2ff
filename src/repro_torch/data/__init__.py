from repro_torch.data.synthetic import (
    SyntheticImageConfig,
    deal_shards,
    label_histogram,
    make_synthetic_images,
    partition_iid,
    partition_noniid,
)
from repro_torch.data.tokens import make_token_dataset
