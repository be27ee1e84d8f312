"""serve.batch_fill.poisson: the requests a dispatch carried over the
rows it ran (``DVCServer.stats``: filled / (dispatches x batch_size)) over
the window, in %."""


def read(run):
    if run.kind != "serve" or not run.stats["dispatches"]:
        return None
    return 100.0 * run.stats["filled"] / (run.stats["dispatches"] * run.batch_size)
