"""train.mfu: the model FLOPs (forward and backward, as ``FlopCounterMode``
counts the reference's first step) of the steps the device finished in the
window, over the same seconds as ``train_examples_per_s`` times the card's
f32 peak, in %."""

from portbench.yardstick import PEAK_F32_FLOPS


def read(run):
    if run.kind != "train" or run.trace is None or not run.done_s or not run.flops_step:
        return None
    return 100.0 * run.flops_step * len(run.done_s) / (run.done_s[-1] * PEAK_F32_FLOPS)
