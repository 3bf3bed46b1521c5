"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "unitree_rl_gym_tpu"}
PROGRAM = "unitree_rl_gym_tpu_torch"


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in sources():
        assert not set(top_level_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not set(top_level_imports(path)) & (FORBIDDEN | {PROGRAM, "benchlib"}), path


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join((BENCH, ROOT))))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_reference_loads_neither_jax_nor_the_program():
    mods = [p[len(BENCH) + 1:-3].replace(os.sep, ".") for p in sources("reference")]
    loaded = _loaded("\n".join(f"import {m.removesuffix('.__init__')}" for m in mods))
    assert not loaded & (FORBIDDEN | {PROGRAM})


def test_harness_loads_no_jax():
    loaded = _loaded(
        "import run\n"
        "from benchlib import common, counts, rollout, trace, train, weights\n"
        "from unitree_rl_gym_tpu_torch.envs.registry import task_registry\n"
        "from unitree_rl_gym_tpu_torch.models import networks\n"
        "from unitree_rl_gym_tpu_torch.rl import ppo\n"
        "from unitree_rl_gym_tpu_torch.utils import cache\n"
        "from unitree_rl_gym_tpu_torch.physics import backend\n")
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN
