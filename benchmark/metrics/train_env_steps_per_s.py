"""train_env_steps_per_s: every env-step of the window over the whole
window (host clock, the device synchronised at its end), in the
``train`` mode's cells."""


def read(run):
    if run["mode"] != "train":
        return None
    return run["env_steps"] / run["window_s"]
