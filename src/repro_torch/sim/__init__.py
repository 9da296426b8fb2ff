"""repro_torch.sim — the FL round loop, its draws, and the scenario
processes (channel, schedule, faults) with their registry."""
from repro_torch.sim.draws import Draws, RoundDraws, TorchDraws, take_round
from repro_torch.sim.engine import run_monte_carlo, run_rounds
from repro_torch.sim.faults import FaultConfig
from repro_torch.sim.processes import ChannelProcessConfig
from repro_torch.sim.scenarios import SCENARIOS, Scenario, get_scenario
from repro_torch.sim.scheduling import ScheduleConfig
