"""`mfu.sweep`: see `portbench.metrics._shared.mfu`."""
from portbench.metrics._shared import mfu as read  # noqa: F401
