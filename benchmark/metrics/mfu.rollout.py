"""mfu.rollout: the whole step's share of the card's peak: the window's
counted work at each precision over that precision's peak (the control
step's operations in fp32 from the frozen count; the networks' products
from their widths, in their compute type), summed, over the traced
window's time, in %."""

PEAK = {"float32": "fp32_flops_per_s", "bfloat16": "bf16_flops_per_s"}


def read(run):
    if run["mode"] != "rollout" or not run.get("trace"):
        return None
    w, p = run["work"], run["peaks"]
    at_peak = (run["control_steps"] * w["step_flops"] / p["fp32_flops_per_s"]
               + w["net_flops"] / p[PEAK[w["net_precision"]]])
    return 100.0 * at_peak / run["window_s"]
