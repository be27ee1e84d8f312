"""serve.dispatch_ms.backlog: the server's own counters over the window
(``DVCServer.stats``): seconds in dispatches (the serving forward and the
copies to and from the card) over the dispatches, in ms."""

from portbench.metrics_common import dispatch_ms


def read(run):
    return dispatch_ms(run)
