"""CPU run of the port's bench (``bench_torch.py``): with
``BENCH_NUM_ENVS=8``, ``BENCH_ITERS=1`` and ``BENCH_CONFIGS=go2,g1`` on
the CPU it prints one valid JSON line in bench.py's shape whose flagship
key is ``go2_train_env_steps_per_s`` (g1's rate under ``extra``) and exits
0; a config that fails is reported on stderr and makes the exit code
nonzero, with the configs that ran still in the line. The line's shape
does not depend on the iteration's length, so each iteration here is cut
to ``STEPS_PER_ENV`` rollout steps and one learning epoch (the stock 24
steps and 5 epochs are what the card runs; the CPU's plain physics takes
~0.5 s a step)."""

import json

import bench_torch
from unitree_rl_gym_tpu_torch.envs.registry import task_registry

STEPS_PER_ENV = 4


def _run(monkeypatch, capsys, configs):
    get_cfgs = task_registry.get_cfgs

    def short_iterations(name):
        env_cfg, train_cfg = get_cfgs(name)
        train_cfg.runner.num_steps_per_env = STEPS_PER_ENV
        train_cfg.algorithm.num_learning_epochs = 1
        return env_cfg, train_cfg

    monkeypatch.setattr(task_registry, "get_cfgs", short_iterations)
    monkeypatch.setenv("BENCH_NUM_ENVS", "8")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_CONFIGS", configs)
    rc = bench_torch.main(["--device=cpu"])
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err


def test_bench_prints_flagship_json(monkeypatch, capsys):
    rc, lines, err = _run(monkeypatch, capsys, "go2,g1")
    assert rc == 0, err
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "go2_train_env_steps_per_s"
    assert line["unit"] == "env_steps/s"
    assert line["value"] > 0
    assert line["vs_baseline"] == line["value"] / bench_torch.BASELINE
    assert set(line["extra"]) == {"g1_train_env_steps_per_s"}
    assert line["extra"]["g1_train_env_steps_per_s"] > 0


def test_bench_failed_config_exits_nonzero(monkeypatch, capsys):
    rc, lines, err = _run(monkeypatch, capsys, "no_such_task")
    assert rc == 1
    assert lines == []
    assert "no_such_task failed" in err and "not measured" in err
