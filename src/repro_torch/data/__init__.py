from repro_torch.data.synthetic import (
    SyntheticImageConfig,
    make_synthetic_images,
    partition_iid,
)
