"""Port parity of the handstand campaign scripts (module 12's handstand
half: ``scripts/handstand_{kickup_r5,transfer_r5,eval,diag,basin,recipe}.py``)
against the JAX package's, on the CPU, without compiling any JAX program:

  * every script's command-line options are its JAX counterpart's, each
    with the same default, type and arity: both parsers are built from
    the scripts' own ``add_argument`` lines;
  * ``EXPERIMENTS`` and the recipe's ``PHASES`` equal JAX's, and every
    experiment's cfgs from ``experiment_cfgs`` equal those that the JAX
    ``run_experiment``'s own cfg lines (:389-407), executed from its
    source, build from the JAX package's cfgs, as ``transfer_cfgs``' equal
    those of the JAX ``main``'s own lines (:171-194) on the arguments its
    own parser gives, for the default options and for
    ``--pd-gain 0.8 1.2 --delay-prob 0.1``;
  * ``Evaluator.runs`` / ``rates`` score the same (done, g_z, height)
    arrays alike (the rollouts stubbed on both instances), ``analyze``
    gives equal attempt records, and the basin's binning equals the JAX
    ``main``'s own lines (executed from its source) on seeded arrays;
  * ``_mujoco_policy`` of the shipped holder within 1e-6 of JAX's on
    random observations, and ``transfer_rate`` equal to JAX's on the same
    2 captured states (MuJoCo, 4 s each);
  * the port's ``TransferEval._capture`` of the shipped holder (16 envs,
    120 steps: the trailing-100-step rule after the first episodes'
    tip-over) holds at least one balanced state;
  * ``handstand_recipe.main`` trains its three phases (1 iteration each,
    8 envs) into a temporary directory, each from the last one's
    checkpoint, and exports; the shipped ``resources/pre_train/go2_handstand``
    files are byte for byte as before."""

import argparse
import hashlib
import os
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.export import export as jexport
from unitree_rl_gym_tpu.scripts import handstand_diag as jdiag
from unitree_rl_gym_tpu.scripts import handstand_kickup_r5 as jkick
from unitree_rl_gym_tpu.scripts import handstand_recipe as jrecipe
from unitree_rl_gym_tpu.scripts import handstand_transfer_r5 as jtransfer
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.scripts import handstand_basin as tbasin
from unitree_rl_gym_tpu_torch.scripts import handstand_diag as tdiag
from unitree_rl_gym_tpu_torch.scripts import handstand_kickup_r5 as tkick
from unitree_rl_gym_tpu_torch.scripts import handstand_recipe as trecipe
from unitree_rl_gym_tpu_torch.scripts import handstand_transfer_r5 as ttransfer
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

SCRIPTS = ("handstand_kickup_r5", "handstand_transfer_r5", "handstand_eval",
           "handstand_diag", "handstand_basin", "handstand_recipe")
ART_DIR = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train",
                       "go2_handstand")
TRANSFER_ARGS = {"default": [],
                 "pd_gain_delay": ["--pd-gain", "0.8", "1.2", "--delay-prob", "0.1"]}
CAPTURE_SETTLE = 120


def _digests():
    return {f: hashlib.sha256(open(os.path.join(ART_DIR, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(ART_DIR))}


@pytest.fixture(scope="module")
def shipped():
    """The shipped artifact's file digests before this module's tests."""
    return _digests()


def _source(package, script):
    return open(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, package, "scripts",
                             f"{script}.py")).read()


def _lines(src, start, end, after=None):
    """The dedented source lines from the one that starts with ``start``
    up to the one that starts with ``end`` (excluded), the search starting
    at ``after``."""
    i = src.index(start, src.index(after) if after else 0)
    return textwrap.dedent(src[i:src.index(end, i)])


def _parser(package, script):
    """The ``ArgumentParser`` of ``script``'s ``main``, built by its own
    lines from ``ap = argparse.ArgumentParser()`` up to ``parse_args``;
    None where the script takes no options."""
    src = _source(package, script)
    if "argparse.ArgumentParser()" not in src:
        return None
    i = src.index("    ap = argparse.ArgumentParser()")
    block = textwrap.dedent(src[i:src.rindex("\n", 0, src.index("ap.parse_args(", i)) + 1])
    art = (jkick if package == "unitree_rl_gym_tpu" else tkick).ART
    ns = {"argparse": argparse, "os": os, "tempfile": tempfile, "ART": art}
    exec(block, ns)
    return ns["ap"]


def _options(ap):
    """Every option of ``ap`` as (flags, dest, default, type, nargs, const,
    choices). ``--out``'s default is read as its last path part: the port
    writes under the temp dir (``tempfile.gettempdir()``) where the JAX
    script names ``/tmp``."""
    opts = []
    for a in ap._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        default = a.default
        if a.dest == "out":
            assert os.path.dirname(default) in ("/tmp", tempfile.gettempdir())
            default = os.path.basename(default)
        opts.append((tuple(a.option_strings), a.dest, default, a.type, a.nargs,
                     a.const, a.choices))
    return sorted(opts, key=repr)


@pytest.mark.parametrize("script", SCRIPTS)
def test_command_line_options_match_jax(script):
    ref, got = (_parser(p, script) for p in ("unitree_rl_gym_tpu",
                                               "unitree_rl_gym_tpu_torch"))
    if ref is None:
        assert got is None
        return
    assert _options(got) == _options(ref)
    assert len(_options(ref)) >= 2


def test_experiments_and_phases_match_jax():
    assert tkick.EXPERIMENTS == jkick.EXPERIMENTS
    assert list(tkick.EXPERIMENTS) == list(jkick.EXPERIMENTS)
    assert trecipe.PHASES == jrecipe.PHASES
    assert (tkick.EVAL_EVERY, tkick.N_EVAL) == (jkick.EVAL_EVERY, jkick.N_EVAL)
    assert ttransfer.EVAL_EVERY == jtransfer.EVAL_EVERY


def _tree(obj):
    """A cfg as nested dicts of its attributes (set ones included), without
    the JAX package's ``sim.backend`` dispatch setting, which the port has
    not (its dispatch goes by the tensors' device)."""
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        d = {k: _tree(v) for k, v in vars(obj).items() if not k.startswith("__")}
        if "backend" in d and "dt" in d:
            d.pop("backend")
        return d
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    return obj


def jax_experiment_cfgs(name):
    """The cfgs that handstand_kickup_r5.run_experiment builds for ``name``:
    its own lines (:389-407), executed from its source on the JAX
    package's registry."""
    src = _source("unitree_rl_gym_tpu", "handstand_kickup_r5")
    ns = {"EXPERIMENTS": jkick.EXPERIMENTS, "name": name,
          "task_registry": jax_registry}
    exec(_lines(src, "    iters, env_over, algo_over = EXPERIMENTS[name]",
                "    out = ", after="def run_experiment("), ns)
    exec(_lines(src, '    cfg, tcfg = task_registry.get_cfgs("go2_handstand")',
                "    env = task_registry.get_task_class(", after="def run_experiment("), ns)
    assert ns["tcfg"].runner.max_iterations == ns["iters"]
    return ns["iters"], ns["cfg"], ns["tcfg"]


@pytest.mark.parametrize("name", list(jkick.EXPERIMENTS))
def test_experiment_cfgs_match_jax_rule(name):
    got, ref = tkick.experiment_cfgs(name), jax_experiment_cfgs(name)
    assert got[0] == ref[0]
    assert _tree(got[1]) == _tree(ref[1])
    assert _tree(got[2]) == _tree(ref[2])


def jax_transfer_cfgs(argv):
    """The arguments and cfgs of handstand_transfer_r5.main: its parser
    from its own ``add_argument`` lines, and its own cfg lines (:171-194)
    executed from its source on the JAX package's registry."""
    args = _parser("unitree_rl_gym_tpu", "handstand_transfer_r5").parse_args(argv)
    ns = {"args": args, "task_registry": jax_registry}
    exec(_lines(_source("unitree_rl_gym_tpu", "handstand_transfer_r5"),
                '    cfg, tcfg = task_registry.get_cfgs("go2_handstand")',
                "    env = task_registry.get_task_class(", after="def main("), ns)
    return args, ns["cfg"], ns["tcfg"]


@pytest.mark.parametrize("argv", list(TRANSFER_ARGS.values()), ids=list(TRANSFER_ARGS))
def test_transfer_cfgs_match_jax(argv):
    got_args = ttransfer.parse_args(argv)
    ref_args, *ref = jax_transfer_cfgs(argv)
    strip = lambda a: {k: v for k, v in vars(a).items() if k != "out"}  # noqa: E731
    assert strip(got_args) == strip(ref_args)
    for got, r in zip(ttransfer.transfer_cfgs(got_args), ref):
        assert _tree(got) == _tree(r)


class _Env:
    """What Evaluator.runs reads of an eval env."""

    def __init__(self, cfg):
        self.cfg = cfg


def _eval_arrays(init_prob, steps, seed):
    """Seeded (done, g_z, height) [steps, 16]: long holds broken by dips
    below the band edge, falls and terminations."""
    rng = np.random.default_rng([int(init_prob * 10), steps, seed])
    n = tkick.N_EVAL
    pgz = np.where(rng.random((steps, n)) < 0.995, 0.3, -0.5).astype(np.float32)
    pgz[:, : n // 2] -= rng.random((1, n // 2)).astype(np.float32)   # some never hold
    h = np.where(rng.random((steps, n)) < 0.998, 0.5, 0.2).astype(np.float32)
    done = rng.random((steps, n)) < 0.003
    return done, pgz, h


def test_evaluator_scoring_matches_jax():
    cfg, _ = jax_registry.get_cfgs("go2_handstand")
    jev, tev = jkick.Evaluator(), tkick.Evaluator(device="cpu")
    jev._env = tev._env = lambda init_prob: _Env(cfg)
    jev._fn = lambda init_prob, steps, net: (
        lambda params, seed: _eval_arrays(init_prob, steps, seed))
    tev._fn = lambda init_prob, steps, net: (
        lambda seed: _eval_arrays(init_prob, steps, seed))
    for seed in (0, 1):
        for args in ((1.0, 450), (0.0, 500)):
            ref, got = jev.runs(None, None, *args, seed), tev.runs(None, *args, seed)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g, r)
        ref, got = jev.rates(None, None, seed), tev.rates(None, seed)
        assert got == ref
        assert 0.0 < ref["hold_rate"] < 1.0


def test_analyze_matches_jax():
    rng = np.random.default_rng(0)
    T, n = 300, 12
    pgz = np.cumsum(rng.normal(0, 0.08, (T, n)), axis=0).astype(np.float32) - 0.3
    h = (0.35 + 0.1 * rng.standard_normal((T, n))).astype(np.float32)
    # a termination resets to an upright start (g_z < 0), and ends some
    # attempts: done where g_z falls from above 0 (``analyze`` takes no
    # attempt that starts on a done step)
    fall = np.zeros((T, n), bool)
    fall[1:] = (pgz[:-1] > 0.0) & (pgz[1:] <= 0.0)
    done = fall & (rng.random((T, n)) < 0.5)
    ref = jdiag.analyze(done, pgz, h)
    got = tdiag.analyze(done, pgz, h)
    assert len(ref) > 10 and {a["end"] for a in ref} == {"terminated", "fell_back", "eval_end"}
    assert got == ref


def test_basin_grid_matches_jax_lines():
    """The port's ``basin_grid`` against the binning lines of the JAX
    ``main`` itself (:105-121), executed on the same seeded arrays."""
    lines = _lines(_source("unitree_rl_gym_tpu", "handstand_basin"),
                   "    th_bins = [", '    print(f"overall')
    rng = np.random.default_rng(1)
    for _ in range(3):
        th0 = rng.uniform(30.0, 150.0, 256)
        w0 = rng.uniform(-2.0, 16.0, 256)
        held = rng.random(256) < 0.6
        ns = {"np": np, "th0": th0, "w0": w0, "held": held}
        exec(lines, ns)
        assert len(ns["grid"]) > 20
        assert tbasin.basin_grid(th0, w0, held) == ns["grid"]


@pytest.fixture(scope="module")
def holder():
    return tkick.load_holder(tkick.ART, "cpu")


def test_mujoco_policy_matches_jax(holder, tmp_path):
    got = ttransfer._mujoco_policy(holder, str(tmp_path / "port"))
    ref = jtransfer._mujoco_policy(jexport.load_flat_params(jkick.ART), str(tmp_path / "jax"))
    obs = np.random.default_rng(0).standard_normal((32, 46)).astype(np.float32)
    for o in obs:
        np.testing.assert_allclose(got(o), ref(o), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def captured(holder):
    return ttransfer.TransferEval(tkick.Evaluator("cpu"))._capture(
        holder, settle=CAPTURE_SETTLE)


def test_capture_holds_balanced_states(captured):
    assert 1 <= len(captured) <= 8
    for st in captured:
        assert [a.shape for a in st] == [(3,), (4,), (12,), (3,), (3,), (12,)]
        assert all(np.isfinite(a).all() for a in st)
        assert st[0][2] > 0.3     # base height of a hold


def test_transfer_rate_matches_jax(holder, captured, tmp_path):
    pytest.importorskip("mujoco")
    states = (captured * 2)[:2]
    tev = ttransfer.TransferEval(tkick.Evaluator("cpu"))
    tev._capture = lambda *a, **k: states
    jev = jtransfer.TransferEval(jkick.Evaluator())
    jev._capture = lambda *a, **k: states
    got = tev.transfer_rate(holder, str(tmp_path / "port"), duration_s=4.0)
    ref = jev.transfer_rate(jexport.load_flat_params(jkick.ART), None,
                            str(tmp_path / "jax"))
    assert got == ref
    assert got[1] == 2


def test_recipe_chains_its_phases(tmp_path):
    out = tmp_path / "go2_handstand"
    ckpts = trecipe.main(out_dir=str(out), iters=1, num_envs=8,
                         log_root=str(tmp_path), device="cpu")
    its = [torch.load(c, map_location="cpu", weights_only=True)["iteration"]
           for c in ckpts]
    assert its == [1, 2, 3]
    for f in ("policy_flat.npz", "policy_meta.json", "policy.bin", "policy_1.pt",
              "curves.json"):
        assert (out / f).exists(), f
    with np.load(out / "policy_flat.npz") as z:
        assert "params/log_std" in z.files


def test_shipped_artifact_unchanged(shipped):
    assert _digests() == shipped
