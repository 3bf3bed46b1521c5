"""setup_s: from the process's start (before torch is imported) to the
window's start: imports, the kernel build or its cached load, the env, the
network, the warm-up and its captures."""


def read(run):
    return run["setup_s"]
