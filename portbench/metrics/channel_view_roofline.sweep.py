"""`channel_view_roofline.sweep`: the channel kernel's least bytes
(with the waypoint uniforms of the clients that arrive each round) at
3.35 TB/s over its mean device time a launch; see
`portbench.metrics._shared.channel_view_roofline`."""
from portbench.metrics._shared import channel_view_roofline as read  # noqa: F401
