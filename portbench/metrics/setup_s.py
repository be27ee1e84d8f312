"""setup_s: seconds from the start of the process to the first timed
request or step (building the model, loading or drawing its weights,
making the traffic, warming every shape the cell uses up)."""


def read(run):
    return run.setup_s
