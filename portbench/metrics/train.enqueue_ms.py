"""train.enqueue_ms: the host's time in each call into the port's train
step over the window (the benchmark's span around the call; the step
queues its work without waiting for the card), the mean, in ms."""


def read(run):
    if run.kind != "train" or not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
