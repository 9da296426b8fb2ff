"""`cwfl_round_roofline.scan`: kernel 1's least bytes at 3.35 TB/s over
its mean device time a launch; see
`portbench.metrics._shared.cwfl_round_roofline`."""
from portbench.metrics._shared import cwfl_round_roofline as read  # noqa: F401
