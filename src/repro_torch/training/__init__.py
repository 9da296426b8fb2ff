from repro_torch.training.local import make_local_runner
from repro_torch.training.federated import (STRATEGIES, FLConfig,  # noqa: F401
                                            run_federated)
