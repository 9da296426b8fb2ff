from repro_torch.optim.optimizers import Optimizer, constant_schedule, sgd
