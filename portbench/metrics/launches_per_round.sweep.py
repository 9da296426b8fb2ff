"""`launches_per_round.sweep`: see `portbench.metrics._shared.launches_per_round`."""
from portbench.metrics._shared import launches_per_round as read  # noqa: F401
