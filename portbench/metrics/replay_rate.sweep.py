"""`replay_rate.sweep`: see `portbench.metrics._shared.replay_rate`."""
from portbench.metrics._shared import replay_rate as read  # noqa: F401
