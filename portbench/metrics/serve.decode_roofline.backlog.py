"""serve.decode_roofline.backlog: the fused decode kernel's (K3) share of its
roofline over the traced window: the bound of each K3 launch at its own
decode step (``yardstick.fused_decode_bound_ms``), summed, over K3's
device time in the trace."""

from portbench.metrics_common import decode_roofline


def read(run):
    return decode_roofline(run)
