"""The port's deploy stack (module 10) against the JAX package's, on the same
inputs, with no JAX program compiled: the numpy policy runtime, the deploy
observation layout (and the committed C++ header), the real-robot helpers
(CRC, remote controller, IMU rotations, command builders), the real-robot
``Controller`` state machine on the mock transport in the ``hg`` and ``go``
DDS dialects (the cases of ``tests/test_deploy.py``), the headless MuJoCo
sim2sim run of the shipped g1 policy, the go2 MuJoCo walk, and the view
model of ``utils/viz.py``. Every result must equal the JAX module's
exactly."""

import os
import types

import numpy as np
import pytest
import torch

import unitree_rl_gym_tpu.deploy.deploy_mujoco.deploy_mujoco as j_mujoco
import unitree_rl_gym_tpu.deploy.deploy_mujoco.go2_scene as j_go2_scene
import unitree_rl_gym_tpu.deploy.deploy_real.common.command_helper as j_cmd
import unitree_rl_gym_tpu.deploy.deploy_real.common.crc as j_crc
import unitree_rl_gym_tpu.deploy.deploy_real.common.remote_controller as j_remote
import unitree_rl_gym_tpu.deploy.deploy_real.common.rotation_helper as j_rot
import unitree_rl_gym_tpu.deploy.deploy_real.config as j_config
import unitree_rl_gym_tpu.deploy.deploy_real.deploy_real as j_real
import unitree_rl_gym_tpu.deploy.deploy_real.transport as j_transport
import unitree_rl_gym_tpu.deploy.obs_layout as j_layout
import unitree_rl_gym_tpu.export.numpy_policy as j_numpy
import unitree_rl_gym_tpu.models.robot as j_robot
import unitree_rl_gym_tpu.utils.viz as j_viz
import unitree_rl_gym_tpu_torch.deploy.deploy_mujoco.deploy_mujoco as t_mujoco
import unitree_rl_gym_tpu_torch.deploy.deploy_mujoco.go2_scene as t_go2_scene
import unitree_rl_gym_tpu_torch.deploy.deploy_real.common.command_helper as t_cmd
import unitree_rl_gym_tpu_torch.deploy.deploy_real.common.crc as t_crc
import unitree_rl_gym_tpu_torch.deploy.deploy_real.common.remote_controller as t_remote
import unitree_rl_gym_tpu_torch.deploy.deploy_real.common.rotation_helper as t_rot
import unitree_rl_gym_tpu_torch.deploy.deploy_real.config as t_config
import unitree_rl_gym_tpu_torch.deploy.deploy_real.deploy_real as t_real
import unitree_rl_gym_tpu_torch.deploy.deploy_real.transport as t_transport
import unitree_rl_gym_tpu_torch.deploy.obs_layout as t_layout
import unitree_rl_gym_tpu_torch.export.numpy_policy as t_numpy
import unitree_rl_gym_tpu_torch.models.robot as t_robot
import unitree_rl_gym_tpu_torch.utils.viz as t_viz
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resource

JAX_DEPLOY = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "unitree_rl_gym_tpu", "deploy")
PORT_DEPLOY = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "unitree_rl_gym_tpu_torch", "deploy")
SIM2SIM_STEPS = 500      # MuJoCo steps of the headless g1 run (1 s)
GO2_WALK_S = 1.0


def test_numpy_policy_equal():
    """The port's numpy runtime gives the JAX one's actions bit for bit:
    go2 (MLP) batched and single, g1 (LSTM) over a batched stateful
    sequence, a reset, and the batch-size guard."""
    rng = np.random.default_rng(0)
    for task in ("go2", "g1"):
        d = resource(f"resources/pre_train/{task}")
        port, ref = t_numpy.NumpyPolicy(d), j_numpy.NumpyPolicy(d)
        assert port.meta == ref.meta
        seq = rng.standard_normal((4, 3, port.meta["num_obs"])).astype(np.float32)
        for t in range(4):
            assert np.array_equal(port(seq[t]), ref(seq[t]))
        port.reset_memory()
        ref.reset_memory()
        assert np.array_equal(port(seq[0, 0]), ref(seq[0, 0]))
        if port.is_recurrent:
            with pytest.raises(ValueError, match="batch size changed"):
                port(seq[1])


def test_obs_layout_equal():
    """The segment table, its meta and the filled observation equal the
    JAX module's; the C++ header is the committed ``obs_layout.gen.h``."""
    with open(os.path.join(JAX_DEPLOY, "cpp", "obs_layout.gen.h")) as f:
        assert t_layout.emit_cpp_header() == f.read()
    assert t_layout.PHASE_PERIOD_S == j_layout.PHASE_PERIOD_S
    rng = np.random.default_rng(1)
    for num_obs, na in ((47, 12), (41, 10), (45, 12), (39, 10)):
        port, ref = t_layout.layout_for(num_obs, na), j_layout.layout_for(num_obs, na)
        assert port.table() == ref.table() and port.to_meta() == ref.to_meta()
        kw = dict(ang_vel=rng.standard_normal(3), gravity=rng.standard_normal(3),
                  command=rng.standard_normal(3), dof_pos=rng.standard_normal(na),
                  dof_vel=rng.standard_normal(na), last_action=rng.standard_normal(na),
                  phase_t=float(rng.uniform(0, 3)))
        got = t_layout.build_obs(port, np.full(num_obs, np.nan, np.float32), **kw)
        want = j_layout.build_obs(ref, np.full(num_obs, np.nan, np.float32), **kw)
        assert np.array_equal(got, want) and np.isfinite(got).all()
    for mod in (t_layout, j_layout):
        with pytest.raises(ValueError):
            mod.layout_for(48, 12)


def test_real_robot_helpers_equal():
    """CRC, the remote controller's wire format, the IMU rotations and the
    command builders give the JAX modules' results exactly."""
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 32, 37, dtype=np.uint64)
    assert t_crc.crc32_words(words) == j_crc.crc32_words(words)
    data = rng.bytes(4 * 37 + 3)
    assert t_crc.crc32_bytes(data) == j_crc.crc32_bytes(data)

    wire = t_remote.RemoteController.pack(0b1010_0110_0101_1001, lx=0.25, rx=-0.5,
                                          ry=0.125, ly=0.75)
    assert wire == j_remote.RemoteController.pack(0b1010_0110_0101_1001, lx=0.25,
                                                  rx=-0.5, ry=0.125, ly=0.75)
    port, ref = t_remote.RemoteController(), j_remote.RemoteController()
    port.set(wire)
    ref.set(wire)
    assert vars(port) == vars(ref)
    assert {k: v for k, v in vars(t_remote.KeyMap).items() if not k.startswith("_")} == \
        {k: v for k, v in vars(j_remote.KeyMap).items() if not k.startswith("_")}

    for _ in range(10):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        assert np.array_equal(t_rot.get_gravity_orientation(q), j_rot.get_gravity_orientation(q))
        args = (rng.uniform(-1, 1), rng.uniform(-1, 1), q, rng.standard_normal((1, 3)))
        for got, want in zip(t_rot.transform_imu_data(*args), j_rot.transform_imu_data(*args)):
            assert np.array_equal(got, want)

    for build in ("create_damping_cmd", "create_zero_cmd", "init_cmd_hg", "init_cmd_go"):
        port_cmd, ref_cmd = t_transport.MockLowCmd(), j_transport.MockLowCmd()
        extra = {"init_cmd_hg": (3, t_cmd.MotorMode.PR),
                 "init_cmd_go": ([1, 4, 10],)}.get(build, ())
        getattr(t_cmd, build)(port_cmd, *extra)
        getattr(j_cmd, build)(ref_cmd, *extra)
        assert cmd_row(port_cmd) == cmd_row(ref_cmd), build
    assert (t_cmd.MotorMode.PR, t_cmd.MotorMode.AB) == (j_cmd.MotorMode.PR, j_cmd.MotorMode.AB)


def cmd_row(c):
    """Every field of a command, as plain values: (mode_machine, mode_pr,
    head, level_flag, gpio, crc, [(mode, q, qd, kp, kd, tau) per motor])."""
    return (c.mode_machine, c.mode_pr, list(c.head), c.level_flag, c.gpio, c.crc,
            [(m.mode, float(m.q), float(m.qd), float(m.kp), float(m.kd), float(m.tau))
             for m in c.motor_cmd])


def drive_controller(config_mod, real_mod, transport_mod, remote_mod, robot):
    """The scripted run of ``tests/test_deploy.py``'s controller cases:
    zero torque until ``start`` (pressed on the third tick), the 2 s move to
    the default pose, the hold until ``A`` (second tick), three 50 Hz run
    ticks with stick input and torso motion, then damping. The policy is a
    fixed linear map of the observation. Returns the sent commands, the
    observations the policy saw and the config. The controller sends one
    command object again and again, so each is recorded as sent
    (:func:`cmd_row`)."""
    cfg = config_mod.Config(os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, config_mod.__name__.replace(".", "/").rsplit("/", 1)[0],
        "configs", f"{robot}.yaml"))
    transport = transport_mod.MockTransport(cfg.msg_type)
    sent, send = [], transport.send

    def record(cmd):
        send(cmd)
        sent.append(cmd_row(cmd))

    transport.send = record
    w = np.random.default_rng(3).standard_normal((cfg.num_obs, cfg.num_actions)) * 0.1
    seen = []

    def policy(obs):
        seen.append(obs.copy())
        return (obs @ w).astype(np.float32)

    ctrl = real_mod.Controller(cfg, transport, policy=policy, sleep=lambda dt: None)
    ticks = {"n": 0}
    keys = remote_mod.KeyMap

    def press_after(n, key):
        def sleep(dt):
            ticks["n"] += 1
            if ticks["n"] >= n:
                transport.set_buttons(1 << key)
        return sleep

    ctrl.sleep = press_after(3, keys.start)
    ctrl.zero_torque_state()
    ctrl.sleep = lambda dt: None
    rng = np.random.default_rng(4)
    transport.set_motors(rng.uniform(-0.3, 0.3, 20), rng.uniform(-1, 1, 20))
    ctrl.move_to_default_pos()
    ticks["n"] = 0
    transport.set_buttons(0)
    ctrl.sleep = press_after(2, keys.A)
    ctrl.default_pos_state()
    ctrl.sleep = lambda dt: None
    for lx, ly, rx in ((0.2, 0.5, -0.4), (0.0, -0.3, 0.1), (-0.6, 0.9, 0.0)):
        transport.set_buttons(0, lx=lx, ly=ly, rx=rx)
        transport.set_motors(rng.uniform(-0.3, 0.3, 20), rng.uniform(-1, 1, 20))
        q = rng.standard_normal(4)
        transport.low_state.imu_state.quaternion = q / np.linalg.norm(q)
        transport.low_state.imu_state.gyroscope = rng.standard_normal(3)
        ctrl.run()
    ctrl.damp()
    return sent, seen, cfg


@pytest.mark.parametrize("robot", ["g1", "h1", "h1_2"])
def test_controller_on_mock_transport_equal(robot):
    """The real-robot controller's state machine in the ``hg`` (g1, h1_2)
    and ``go`` (h1, weak-motor mode bits; torso IMU on h1 and h1_2)
    dialects sends the JAX controller's commands, CRCs included, and feeds
    its policy the same observations."""
    sent, seen, cfg = drive_controller(t_config, t_real, t_transport, t_remote, robot)
    ref_sent, ref_seen, ref_cfg = drive_controller(j_config, j_real, j_transport,
                                                   j_remote, robot)
    assert vars(cfg).keys() == vars(ref_cfg).keys()
    for k, v in vars(ref_cfg).items():
        got = vars(cfg)[k]
        assert got == v if isinstance(v, str) else np.array_equal(got, v), k
    assert sent == ref_sent
    assert len(seen) == len(ref_seen) == 3
    assert all(np.array_equal(a, b) for a, b in zip(seen, ref_seen))

    # the JAX cases' own checks, on the port's run
    dialect = {"g1": "hg", "h1": "go", "h1_2": "hg"}[robot]
    assert cfg.msg_type == dialect and seen[0].shape == (cfg.num_obs,)
    motors = 6
    assert all(m[3] == 0 and m[4] == 0 for m in sent[0][motors])
    n_move = int(2.0 / cfg.control_dt)
    assert len(sent) == 3 + n_move + 2 + 3 + 1
    leg0 = cfg.leg_joint2motor_idx[0]
    assert abs(sent[3 + n_move - 1][motors][leg0][1] - cfg.default_angles[0]) < 0.05
    assert sent[3 + n_move - 1][motors][leg0][3] == cfg.kps[0]
    run = sent[-2]
    assert run[5] != 0
    for i, motor in enumerate(cfg.leg_joint2motor_idx):
        assert run[motors][motor][3] == cfg.kps[i]
    aw0 = cfg.arm_waist_joint2motor_idx[0]
    assert run[motors][aw0][3] == cfg.arm_waist_kps[0]
    np.testing.assert_allclose(seen[0][6:9], np.array([0.5, -0.2, 0.4]) * cfg.cmd_scale
                               * cfg.max_cmd, atol=1e-6)
    assert all(m[4] == 8 for m in sent[-1][motors])
    if dialect == "go":
        assert sent[0][2] == [0xFE, 0xEF] and sent[0][3] == 0xFF
        assert sent[0][motors][cfg.weak_motor[0]][0] == 1
        strong = next(i for i in range(20) if i not in cfg.weak_motor)
        assert sent[0][motors][strong][0] == 0x0A


@pytest.mark.parametrize("artifact", ["", "policy_lstm_1.pt"])
def test_sim2sim_g1_headless_equal(artifact):
    """``deploy_mujoco.run`` headless with the shipped g1 export, the
    flat-weight directory (the numpy runtime) or the TorchScript file, for
    500 MuJoCo steps returns the JAX run's stats exactly; the two packages'
    configs resolve to the same paths."""
    name = "g1.yaml"
    cfg = t_mujoco.load_config(os.path.join(PORT_DEPLOY, "deploy_mujoco", "configs", name))
    ref_cfg = j_mujoco.load_config(os.path.join(JAX_DEPLOY, "deploy_mujoco", "configs", name))
    assert cfg == ref_cfg
    policy = os.path.join(resource("resources/pre_train/g1"), artifact)
    cfg["policy_path"] = ref_cfg["policy_path"] = policy
    stats = t_mujoco.run(cfg, headless=True, max_steps=SIM2SIM_STEPS)
    ref = j_mujoco.run(ref_cfg, headless=True, max_steps=SIM2SIM_STEPS)
    assert stats == ref
    assert stats["steps"] == SIM2SIM_STEPS and not stats["fell"]


def test_go2_walk_equal():
    """``go2_scene.run_go2_walk`` of the shipped go2 policy for 1 s of
    MuJoCo returns the JAX harness's stats exactly (the port's go2 cfg gives
    the same gains, scales and default pose)."""
    d = resource("resources/pre_train/go2")
    stats = t_go2_scene.run_go2_walk(t_numpy.NumpyPolicy(d), duration_s=GO2_WALK_S)
    ref = j_go2_scene.run_go2_walk(j_numpy.NumpyPolicy(d), duration_s=GO2_WALK_S)
    assert stats == ref


URDF = {"go2": "resources/robots/go2/urdf/go2.urdf",
        "g1": "resources/robots/g1_description/g1_12dof.urdf"}


def view_env(robot_mod, task):
    robot = robot_mod.build_robot(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, URDF[task]))
    cfg = types.SimpleNamespace(asset=types.SimpleNamespace(file=URDF[task]))
    return types.SimpleNamespace(robot=robot, num_actions=robot.num_dof, dt=0.02, cfg=cfg)


@pytest.mark.parametrize("task", ["go2", "g1"])
def test_view_model_equal(task):
    """``viz.load_view_model`` maps the port robot's joints to the JAX
    one's qpos addresses, and the headless replayer mirrors a port env
    state (torch tensors) into MuJoCo."""
    env = view_env(t_robot, task)
    m, addr = t_viz.load_view_model(task, env)
    ref_m, ref_addr = j_viz.load_view_model(task, view_env(j_robot, task))
    assert (m.nq, m.njnt) == (ref_m.nq, ref_m.njnt)
    assert np.array_equal(addr, ref_addr)

    rv = t_viz.RolloutViewer(task, env, env_index=1, viewer=False, realtime=False)
    n = env.num_actions
    q = torch.linspace(-0.3, 0.3, n)
    phys = types.SimpleNamespace(
        base_pos=torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.2, 0.42]]),
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0]]),
        joint_q=torch.stack((torch.zeros(n), q)))
    assert rv.update(types.SimpleNamespace(phys=phys))
    np.testing.assert_allclose(rv.data.qpos[0:7], [0.1, 0.2, 0.42, 1.0, 0.0, 0.0, 0.0],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(rv.data.qpos[rv.qpos_addr], q.numpy(), rtol=0, atol=1e-7)
    rv.close()
