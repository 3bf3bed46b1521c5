"""rollout_ms.train: ``PPO.train_iteration``'s own rollout_s (host clock, the
device synchronised at its end) summed over the traced window's
iterations, per iteration, in ms."""


def read(run):
    if run["mode"] != "train" or not run.get("iterations"):
        return None
    return run["rollout_s"] / run["iterations"] * 1e3
