from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    sgd_momentum,
    adamw,
    constant_schedule,
    inverse_time_schedule,
    cosine_schedule,
)
