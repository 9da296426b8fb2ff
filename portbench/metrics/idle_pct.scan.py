"""`idle_pct.scan`: see `portbench.metrics._shared.idle_pct`."""
from portbench.metrics._shared import idle_pct as read  # noqa: F401
