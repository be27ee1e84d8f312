"""train.msda_roofline: K1 and K2's share of their roofline over the
traced window: the bounds of one step's MSDA calls (its locations and
weights, captured in set-up's last step; ``yardstick.msda_bound_ms`` and
``msda_bwd_bound_ms``), times the steps the trace holds (its K1 launches
over the calls a step), over K1's and K2's device time in the trace."""

from portbench.trace import kernel_seconds


def read(run):
    if run.kind != "train" or run.trace is None or not run.msda or not run.msda["calls"]:
        return None
    kernels = run.trace["kernels"]
    device_s = kernel_seconds(kernels, "msda_fwd") + kernel_seconds(kernels, "msda_bwd")
    launches = sum(1 for name, _, _ in kernels if "msda_fwd" in name)
    if device_s <= 0 or not launches:
        return None
    steps = launches / run.msda["calls"]
    return 100.0 * steps * (run.msda["fwd_ms"] + run.msda["bwd_ms"]) / 1e3 / device_s
