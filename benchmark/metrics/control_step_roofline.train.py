"""control_step_roofline.train: the control step's share of its roofline.
The bound of one launch is the larger of its counted operations over the
fp32 peak and its counted bytes over HBM's (the frozen counts of
``benchlib/counts.py``, the data sheet's peaks); the time is the device
time of the kernels launched inside the harness's ``bench.control_step``
spans in the traced window."""


def read(run):
    t = run.get("trace") or {}
    span = t.get("bench.control_step")
    if run["mode"] != "train" or not span or span["device_s"] <= 0.0:
        return None
    w, p = run["work"], run["peaks"]
    bound = max(w["step_flops"] / p["fp32_flops_per_s"],
                w["step_bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * span["n_spans"] * bound / span["device_s"]
