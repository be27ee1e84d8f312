"""serve.mfu.backlog: the model FLOPs of the videos answered within the
window (padding rows not counted; each dispatch's decode steps as it ran
them, counted from the port's K3 launches) over the window's seconds times
the card's f32 peak, in %."""

from portbench.metrics_common import serve_mfu


def read(run):
    return serve_mfu(run)
