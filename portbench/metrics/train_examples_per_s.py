"""train_examples_per_s: the examples of the steps the device finished
within the window, over the time from the window's start to the last of
those steps' ends (CUDA events), so the rate holds all the window's work
and none of its tail."""


def read(run):
    if run.kind != "train" or not run.done_s:
        return None
    return run.batch_size * len(run.done_s) / run.done_s[-1]
