"""repro_torch.strategies — the aggregation-strategy registry."""
from repro_torch.strategies.base import (Strategy, available_strategies,
                                         get_strategy, register_strategy)
from repro_torch.strategies.builtin import (PAPER_MU_PROX, COTAFStrategy,
                                            CWFLStrategy,
                                            DecentralizedStrategy,
                                            FedAvgStrategy)
