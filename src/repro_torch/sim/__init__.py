"""repro_torch.sim — the FL round loop (static scenario) and its draws."""
from repro_torch.sim.draws import Draws, TorchDraws
from repro_torch.sim.engine import run_rounds
