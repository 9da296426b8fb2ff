"""`capture_s.sweep`: see `portbench.metrics._shared.capture_s`."""
from portbench.metrics._shared import capture_s as read  # noqa: F401
