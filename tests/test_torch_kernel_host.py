"""The per-env body of kernels K1, K3 and K2 (csrc/control_step.cuh, the
warp schedule the CUDA kernels run: G lanes per env, 32 / G envs per warp)
compiled for the host with g++ -O1 into pytest's tmp dir, each phase a loop
over the 32 lanes of an emulated warp,
and held against the port's plain version at N=8, at
the physics tolerance of tests/test_torch_physics.py: K1 (``HAS_GH=false``)
grounded and airborne on the plane, K3 (``HAS_GH=true``) standing on the
tiny heightfield of tests/test_pallas_terrain.py, its end-of-step point xy
(``p_xy``) included, and K2 (``HAS_CS=true``) with per-env contact
stiffnesses from 0.25 to 3.0: on the plane at the go2 handstand's sizes
(79 contact points, decimation 5, torques not clipped), grounded, and on
the tiny heightfield at go2's. With every stiffness 1, K2's host body
gives K1's bits. The lanes' order within a phase changes no bit (no phase
reads what another lane of it, of its env or of another, writes), also
with the last warp only partly filled; the scratch of the envs of a block
fits the launch's shared memory; and the level tables that schedule the
tree recursions and the Cholesky factor and solves follow the tree and the
plain version's factor. This catches kernel math and schedule errors on
machines without a GPU; it is never a runtime path.

The ``cuda``-marked tests hold the real kernels against the plain version
on the card at N=64 (skip without a GPU)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.envs.go2_handstand import (
    FOOT_RADIUS, GO2HandstandEnv, go2_handstand_cfg,
)
from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.physics import engine as eng
from unitree_rl_gym_tpu_torch.physics import soa

N = 8
# the humanoids' sizes (SoAModel nb, nv, ncp, nrb) and decimation
HUMANOIDS = {"g1": (13, 18, 80, 31, 4), "h1": (11, 16, 72, 22, 4),
             "h1_2": (13, 18, 20, 56, 8)}
STATE_FIELDS = ("base_pos", "base_quat", "joint_q", "v")
AUX_KEYS = ("torques", "cf_rb", "rb_pos_w", "rb_vel_w")
# outputs held to the state's tolerance (p_xy: K3's end-of-step point xy)
POSITION_KEYS = STATE_FIELDS + ("p_xy",)
# per-env contact stiffnesses of the K2 cases (the JAX suite's extremes
# 0.25 and 3.0, the fine-tune's range 0.7-1.5, and 1)
CSTIFF = np.float32([0.25, 0.5, 0.7, 1.0, 1.2, 1.5, 2.0, 3.0])


def tiny_terrain(cfg):
    """The tiny heightfield of tests/test_pallas_terrain.py: 2 x 2
    sub-terrains of 4 m with a 2 m border, terrain curriculum on."""
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = 4.0
    cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    cfg.terrain.curriculum = True
    return cfg


def make_inputs(default_dof_pos, n, grounded, seed):
    rng = np.random.default_rng(seed)
    nj = default_dof_pos.shape[0]
    dd = np.asarray(default_dof_pos, np.float32)
    z = 0.32 if grounded else 0.8
    return dict(
        base_pos=np.tile(np.float32([0.0, 0.0, z]), (n, 1)),
        base_quat=np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (n, 1)),
        joint_q=(dd * (1 + 0.05 * rng.standard_normal((n, nj)))).astype(np.float32),
        v=(0.1 * rng.standard_normal((n, 6 + nj))).astype(np.float32),
        target=np.tile(dd, (n, 1)),
        friction=np.linspace(0.3, 1.2, n, dtype=np.float32),
        mass_scale=np.linspace(0.9, 1.3, n, dtype=np.float32),
    )


def terrain_inputs(env, n, seed):
    """``make_inputs`` on the terrain env's heightfield: bases over the
    sub-terrain origins with the feet near the ground, and ``gh`` [ncp, n]
    the heights under the default-pose points."""
    x = make_inputs(env.default_dof_pos.numpy(), n, True, seed)
    rng = np.random.default_rng(seed)
    origins = env.terrain_origins.reshape(-1, 3).numpy()
    base = origins[np.arange(n) % origins.shape[0]]
    base = base + np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                            np.full(n, 0.30)], 1)
    x["base_pos"] = base.astype(np.float32)
    x["gh"] = env._reset_gh(torch.from_numpy(x["base_pos"])).numpy()
    return x


def handstand_env(n):
    """The go2 handstand env on the CPU (79 contact points, decimation 5,
    torques not clipped)."""
    cfg = go2_handstand_cfg()
    cfg.env.num_envs = n
    return GO2HandstandEnv(cfg, device="cpu")


def handstand_inputs(env, n, seed):
    """``make_inputs`` at the handstand's default crouch with the lowest
    foot 4 mm into the ground, and ``cstiff`` [n] from :data:`CSTIFF`."""
    dd = env.default_dof_pos.numpy()
    x = make_inputs(dd, n, True, seed)
    rb_pos = env._feet_world(0.0, dd)[0].numpy()
    feet_z = rb_pos[env.feet_indices.numpy(), 2]
    x["base_pos"][:, 2] = FOOT_RADIUS - float(feet_z.min()) - 0.004
    x["cstiff"] = np.resize(CSTIFF, n)
    return x


def _step(fn, env, x, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    cfg = env.cfg
    s, aux = fn(
        env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, cfg.control.decimation,
        eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
        t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t,
        gh=t.get("gh"), cstiff=t.get("cstiff"),
    )
    out = {k: getattr(s, k) for k in STATE_FIELDS}
    out.update(aux)
    return {k: v.cpu().numpy() for k, v in out.items()}


def plain_step(env, x, device="cpu"):
    """The plain version (``backend.control_step_soa``) on ``device``."""
    return _step(pb.control_step_soa, env, x, device)


def env_step(env, x, device="cpu"):
    """What ``LeggedEnv.step`` runs (``backend.control_step``): K1 (K3 with
    ``gh``, K2 with ``cstiff``) on a CUDA tensor, the plain version on a
    CPU tensor."""
    return _step(pb.control_step, env, x, device)


def assert_close(ref, got, keys):
    for k in keys:
        if k in POSITION_KEYS:
            np.testing.assert_allclose(got[k], ref[k], atol=5e-5, rtol=1e-4,
                                       err_msg=k)
        else:
            mag = max(float(np.abs(ref[k]).max()), 1.0)
            np.testing.assert_allclose(got[k] / mag, ref[k] / mag, atol=5e-4,
                                       err_msg=k)


@pytest.fixture(scope="module")
def env():
    cfg = go2_rough_cfg()
    cfg.env.num_envs = N
    return LeggedEnv(cfg, device="cpu")


def build_host_lib(m, out_dir, defines=()):
    """g++ -O1 build of csrc/host_harness.cpp for the sizes of SoAModel
    ``m`` (``defines``: extra -D flags)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    so = os.path.join(str(out_dir), "libk1_host.so")
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *cuda_step.size_defines(m),
         *defines, "-I", cuda_step.CSRC_DIR, "-o", so,
         os.path.join(cuda_step.CSRC_DIR, "host_harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(so)
    lib.utrl_model_bytes.restype = ctypes.c_longlong
    lib.utrl_scratch_bytes.restype = ctypes.c_longlong
    lib.utrl_scratch_bytes.argtypes = [ctypes.c_int]
    lib.utrl_lanes_per_env.restype = ctypes.c_int
    lib.utrl_envs_per_block.restype = ctypes.c_int
    lib.utrl_blocks_per_sm_asked.restype = ctypes.c_int
    lib.utrl_control_step_host.restype = ctypes.c_int
    lib.utrl_control_step_host.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15)
    for name, n_ptr in (("utrl_control_step_terrain_host", 17),
                         ("utrl_control_step_cs_host", 16),
                         ("utrl_control_step_terrain_cs_host", 18)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * n_ptr
    return lib


def host_step(lib, m, tables, x):
    """One control step of every env of ``x`` through the host build: K1's
    body, K3's when ``x`` holds ``gh``, K2's when it holds ``cstiff``."""
    assert lib.utrl_model_bytes() == len(tables)
    blob = ctypes.create_string_buffer(tables)
    n = x["joint_q"].shape[0]
    terrain, cs = "gh" in x, "cstiff" in x
    ins = [np.ascontiguousarray(x[k]) for k in
           STATE_FIELDS + ("target", "friction", "mass_scale")
           + (("gh",) if terrain else ()) + (("cstiff",) if cs else ())]
    shapes = dict(base_pos=(n, 3), base_quat=(n, 4), joint_q=(n, m.nj),
                  v=(n, m.nv), torques=(n, m.nj), cf_rb=(n, m.nrb, 3),
                  rb_pos_w=(n, m.nrb, 3), rb_vel_w=(n, m.nrb, 3))
    if terrain:
        shapes["p_xy"] = (2 * m.ncp, n)
    outs = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    fn = getattr(lib, "utrl_control_step" + ("_terrain" if terrain else "")
                 + ("_cs" if cs else "") + "_host")
    rc = fn(ctypes.addressof(blob), n,
            *(a.ctypes.data for a in ins), *(a.ctypes.data for a in outs.values()))
    assert rc == 0
    return outs


def env_tables(env):
    m = pb.soa_model_for(env.robot.dyn)
    cfg = env.cfg
    return m, cuda_step.model_tables(m, env.cparams, env.pd, cfg.sim.dt,
                                     cfg.control.decimation, env.m_eff_n,
                                     env.m_eff_t)


@pytest.fixture(scope="module")
def host_lib(env, tmp_path_factory):
    return build_host_lib(pb.soa_model_for(env.robot.dyn),
                          tmp_path_factory.mktemp("k1_host"))


@pytest.fixture(scope="module")
def rev_host_lib(env, tmp_path_factory):
    """The host build at go2's sizes with every phase's lanes reversed."""
    return build_host_lib(pb.soa_model_for(env.robot.dyn),
                          tmp_path_factory.mktemp("k1_host_rev"),
                          ("-DUTRL_HOST_LANES_REVERSED",))


def test_model_tables_match_struct(env, host_lib):
    _, tables = env_tables(env)
    assert len(tables) == host_lib.utrl_model_bytes()


@pytest.mark.parametrize("task", ["go2", "go2_handstand"] + list(HUMANOIDS))
def test_tree_levels_follow_parent(env, hs_env, hum_envs, task):
    """Every body's parent sits on the level above it, in the depths, in the
    depth masks and in the bodies listed by depth; each body's children are
    the bodies whose parent it is; the body chains hold every body once,
    the base alone at level 0, each chain's bodies each the parent of the
    next, and each head's parent on a chain of the level above; and the
    packed tables end with the schedule's fields. The humanoids' trees are
    the base and two serial legs of 5 (h1) or 6 bodies."""
    e = {"go2": env, "go2_handstand": hs_env, **hum_envs}[task]
    m, tables = env_tables(e)
    depth = cuda_step.tree_levels(m)
    assert depth[0] == 0 and m.parent[0] == -1
    for i in range(1, m.nb):
        assert depth[i] == depth[m.parent[i]] + 1, i
    (depth_mask, n_depth, child_mask, cp_dyn, _, _, bodies, first, lvl, n_lvl,
     _, _, _, _, depth_body, depth_first, rb_pt, rb_start,
     rb_end) = cuda_step.schedule_tables(m)
    chains = [list(bodies[first[c]:first[c + 1]]) for c in range(lvl[n_lvl[0]])]
    level = {c: lv for lv in range(n_lvl[0]) for c in range(lvl[lv], lvl[lv + 1])}
    chain_of = {b: c for c, ch in enumerate(chains) for b in ch}
    assert sorted(chain_of) == list(range(m.nb)) and len(bodies) == m.nb
    assert chains[0] == [0] and level[0] == 0 and lvl[1] == 1
    for c, ch in enumerate(chains[1:], 1):
        assert level[chain_of[m.parent[ch[0]]]] == level[c] - 1, ch
        for a, b in zip(ch, ch[1:]):
            assert m.parent[b] == a, ch
    assert n_depth == [depth.max() + 1]
    level_of = {i: d for d in range(n_depth[0]) for i in range(m.nb)
                if int(depth_mask[d]) >> i & 1}
    assert sorted(level_of) == list(range(m.nb))
    for i in range(1, m.nb):
        assert level_of[m.parent[i]] == level_of[i] - 1, i
        assert int(child_mask[m.parent[i]]) >> i & 1, i
    assert sum(bin(int(c)).count("1") for c in child_mask) == m.nb - 1
    for d in range(n_depth[0]):
        n_d = bin(int(depth_mask[d])).count("1")
        assert list(depth_body[depth_first[d]:depth_first[d] + n_d]) == [
            i for i in range(m.nb) if depth[i] == d]
    assert list(cp_dyn) == list(np.repeat(np.arange(m.nb),
                                          [b - a for a, b in m.cp_slice]))
    for r, idx in enumerate(m.cp_rb):
        assert list(rb_pt[rb_start[r]:rb_end[r]]) == sorted(idx), r
    tail = np.concatenate([np.asarray(a).astype(np.uint32)
                           for a in cuda_step.schedule_tables(m)])
    np.testing.assert_array_equal(
        np.frombuffer(tables, np.uint32)[-tail.size:], tail)


@pytest.mark.parametrize("task", ["go2", "go2_handstand"] + list(HUMANOIDS))
def test_chol_levels_cover_the_plain_factor(env, hs_env, hum_envs, task):
    """Every entry the plain version's factor keeps (``soa.chol_factor_s``
    emits no structural zero) is in the kernel's pattern, and for joint
    rows i > j, column j comes before i in the factor's and the forward
    solve's order and after it in the back solve's: later on the same
    elimination chain (walked from its tail up, and from its head down) or
    on a chain of a deeper level (deepest level first, and last). So the
    kernel's chain-by-chain sums hold every term the plain version's do,
    each one final when it is read. Every joint's column holds every base
    row, which the back solve reads first, before the joint rows' terms."""
    e = {"go2": env, "go2_handstand": hs_env, **hum_envs}[task]
    m = pb.soa_model_for(e.robot.dyn)
    x = make_inputs(e.default_dof_pos.numpy(), N, True, seed=3)
    t = {k: list(torch.from_numpy(x[k]).T) for k in STATE_FIELDS}
    _, _, E_up, _ = soa.fk_s(m, t["base_pos"], t["base_quat"], t["joint_q"], t["v"])
    L, _, _ = soa.chol_factor_s(soa.crba_s(m, E_up, torch.from_numpy(x["mass_scale"])),
                                m.chol_order)
    nz = cuda_step.chol_pattern(m)
    pos, first, lvl = cuda_step.elim_chains(m)
    assert sorted(pos) == list(range(m.nj))
    assert nz[m.nj:, :m.nj].all()
    level = {c: lv for lv in range(len(lvl) - 1) for c in range(lvl[lv], lvl[lv + 1])}
    where = {int(p): (c, q) for c in range(len(first) - 1)
             for q, p in enumerate(pos[first[c]:first[c + 1]])}
    assert len(L) > m.nv
    for i, j in L:
        assert nz[i, j], (i, j)
        if m.nj > i > j:
            (ci, qi), (cj, qj) = where[i], where[j]
            assert (ci == cj and qj > qi) or level[cj] > level[ci], (i, j)


# the H100's shared memory (CUDA C++ Programming Guide, compute capability
# 9.0): 228 KB an SM, at most 227 KB a block, 1 KB reserved per resident block
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED_PER_BLOCK = 1024


def test_scratch_fits_shared_memory(host_lib, hs_host_lib):
    """The build exports one env's scratch, its lanes and the launch's
    shape, and the blocks that the kernel's __launch_bounds__ asks for fit
    an H100 SM's shared memory at go2's sizes (K1, K3, K2 on terrain) and
    the handstand's (K2 flat, 79 points): a group of G = 8 or 16 lanes per
    env, whole warps of 32 / G envs a block, each env's scratch G banks
    after the one before it (a stride of G words modulo 32), within the
    227 KB a block may use, and as many blocks resident at once as asked,
    which holds 4096 envs on 132 SMs. What the card's runtime grants is
    gated by chip_smoke.py."""
    sizes = [host_lib.utrl_scratch_bytes(0), host_lib.utrl_scratch_bytes(1),
             hs_host_lib.utrl_scratch_bytes(0)]
    assert sizes[0] < sizes[1] and sizes[0] < sizes[2]
    check_scratch_fits(host_lib, sizes)


def check_scratch_fits(lib, sizes):
    """The launch's shape in the build ``lib``, and each env scratch of
    ``sizes`` (bytes) within an H100 SM's shared memory at the blocks the
    launch asks for, holding 4096 envs on 132 SMs."""
    lanes = lib.utrl_lanes_per_env()
    per_block = lib.utrl_envs_per_block()
    asked = lib.utrl_blocks_per_sm_asked()
    assert lanes in (8, 16) and per_block % (32 // lanes) == 0, (lanes, per_block)
    assert asked * per_block * 132 >= 4096, (asked, per_block)
    for b in sizes:
        block = per_block * b
        assert b % 4 == 0 and (b // 4) % 32 == lanes, b
        assert block <= SMEM_PER_BLOCK, b
        assert asked * (block + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM, b


def test_lane_order_changes_no_bit(env, terrain_env, host_lib, rev_host_lib):
    """Each phase's lanes run in reverse in a second host build (the lanes
    of each env's group and the groups of the warp): K1, K3 and K2 give the
    same bits, so no phase reads what another lane of it writes (on the
    card the lanes of a phase run at once)."""
    rev = rev_host_lib
    cases = [(env, make_inputs(env.default_dof_pos.numpy(), N, True, seed=8)),
             (terrain_env, terrain_inputs(terrain_env, N, seed=8)),
             (terrain_env, dict(terrain_inputs(terrain_env, N, seed=9), cstiff=CSTIFF))]
    for e, x in cases:
        a = host_step(host_lib, *env_tables(e), x)
        b = host_step(rev, *env_tables(e), x)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def host_vs_plain(env, host_lib):
    """{grounded: (plain outputs, host-body outputs)} on the same inputs."""
    out = {}
    for grounded in (True, False):
        x = make_inputs(env.default_dof_pos.numpy(), N, grounded, seed=4)
        out[grounded] = plain_step(env, x), host_step(host_lib, *env_tables(env), x)
    return out


@pytest.mark.parametrize("output", STATE_FIELDS + AUX_KEYS)
@pytest.mark.parametrize("grounded", [True, False], ids=["grounded", "airborne"])
def test_host_body_matches_plain(host_vs_plain, grounded, output):
    ref, got = host_vs_plain[grounded]
    assert_close(ref, got, [output])
    if grounded and output == "cf_rb":
        assert float(np.abs(got["cf_rb"]).max()) > 1.0


@pytest.fixture(scope="module")
def terrain_env():
    cfg = tiny_terrain(go2_rough_cfg())
    cfg.env.num_envs = N
    return LeggedEnv(cfg, device="cpu")


@pytest.fixture(scope="module")
def host_vs_plain_terrain(terrain_env, host_lib):
    """(plain outputs, K3 host-body outputs) on the same terrain inputs."""
    x = terrain_inputs(terrain_env, N, seed=4)
    return plain_step(terrain_env, x), host_step(host_lib, *env_tables(terrain_env), x)


@pytest.mark.parametrize("output", POSITION_KEYS + AUX_KEYS)
def test_terrain_host_body_matches_plain(host_vs_plain_terrain, output):
    ref, got = host_vs_plain_terrain
    assert_close(ref, got, [output])
    if output == "cf_rb":
        assert float(np.abs(got["cf_rb"]).max()) > 1.0


def test_kernel_wrapper_rejects_cpu_tensors(env):
    """K1's wrapper launches on CUDA tensors only; the choice of the plain
    version for a CPU tensor is ``backend.control_step``'s."""
    x = make_inputs(env.default_dof_pos.numpy(), N, True, seed=7)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = env.cfg
    before = cuda_step.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.control_step(
            pb.soa_model_for(env.robot.dyn), env.cparams, env.pd, cfg.sim.dt,
            cfg.control.decimation,
            eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
            t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t,
        )
    assert cuda_step.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grounded", [True, False], ids=["grounded", "airborne"])
def test_cuda_kernel_matches_plain(env, cuda_device, grounded):
    x = make_inputs(env.default_dof_pos.numpy(), 64, grounded, seed=5)
    ref = plain_step(env, x, cuda_device)
    before = cuda_step.LAUNCHES
    got = env_step(env, x, cuda_device)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    assert_close(ref, got, STATE_FIELDS + AUX_KEYS)


def test_terrain_kernel_wrapper_rejects_cpu_tensors(terrain_env):
    """K3's wrapper, like K1's, launches on CUDA tensors only."""
    env = terrain_env
    x = terrain_inputs(env, N, seed=7)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = env.cfg
    before = cuda_step.LAUNCHES_TERRAIN
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.control_step_terrain(
            pb.soa_model_for(env.robot.dyn), env.cparams, env.pd, cfg.sim.dt,
            cfg.control.decimation,
            eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
            t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t, t["gh"],
        )
    assert cuda_step.LAUNCHES_TERRAIN == before


@pytest.mark.cuda
def test_cuda_terrain_kernel_matches_plain(terrain_env, cuda_device):
    x = terrain_inputs(terrain_env, 64, seed=5)
    ref = plain_step(terrain_env, x, cuda_device)
    before = cuda_step.LAUNCHES_TERRAIN
    got = env_step(terrain_env, x, cuda_device)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES_TERRAIN == before + 1
    assert_close(ref, got, POSITION_KEYS + AUX_KEYS)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_operands(env, cuda_device):
    x = make_inputs(env.default_dof_pos.numpy(), 64, True, seed=6)
    x["joint_q"] = x["joint_q"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        env_step(env, x, cuda_device)


# ---------------------------------------------------------------------------
# K2: the contact-stiffness instances
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hs_env():
    return handstand_env(N)


@pytest.fixture(scope="module")
def hs_host_lib(hs_env, tmp_path_factory):
    """The host build at the handstand's sizes (79 contact points)."""
    return build_host_lib(pb.soa_model_for(hs_env.robot.dyn),
                          tmp_path_factory.mktemp("k2_host"))


@pytest.fixture(scope="module")
def host_vs_plain_cs(hs_env, hs_host_lib, terrain_env, host_lib):
    """{case: (plain outputs, K2 host-body outputs)}: flat at the
    handstand's sizes, and on the tiny heightfield at go2's."""
    flat = handstand_inputs(hs_env, N, seed=4)
    terrain = dict(terrain_inputs(terrain_env, N, seed=4), cstiff=CSTIFF)
    return {
        "flat": (plain_step(hs_env, flat),
                 host_step(hs_host_lib, *env_tables(hs_env), flat)),
        "terrain": (plain_step(terrain_env, terrain),
                    host_step(host_lib, *env_tables(terrain_env), terrain)),
    }


@pytest.mark.parametrize(
    "case,output",
    [("flat", k) for k in STATE_FIELDS + AUX_KEYS]
    + [("terrain", k) for k in POSITION_KEYS + AUX_KEYS])
def test_cs_host_body_matches_plain(host_vs_plain_cs, case, output):
    ref, got = host_vs_plain_cs[case]
    assert_close(ref, got, [output])
    if output == "cf_rb":
        assert float(np.abs(got["cf_rb"]).max()) > 1.0


def test_cs_inputs_exercise_the_stiffness(hs_env):
    """The flat K2 case is in contact and its stiffnesses change the
    contact response (the plain version with cstiff vs without)."""
    x = handstand_inputs(hs_env, N, seed=4)
    with_cs = plain_step(hs_env, x)
    x.pop("cstiff")
    without = plain_step(hs_env, x)
    moved = np.abs(with_cs["v"] - without["v"]).max(axis=1)
    assert moved[CSTIFF == 1.0].max() == 0.0
    assert moved[CSTIFF != 1.0].min() > 1e-4


def test_cs_host_body_with_unit_stiffness_is_k1(hs_env, hs_host_lib):
    """K2's body with every stiffness 1 gives K1's bits."""
    x = handstand_inputs(hs_env, N, seed=5)
    x["cstiff"] = np.ones(N, np.float32)
    k2 = host_step(hs_host_lib, *env_tables(hs_env), x)
    x.pop("cstiff")
    k1 = host_step(hs_host_lib, *env_tables(hs_env), x)
    for k in STATE_FIELDS + AUX_KEYS:
        np.testing.assert_array_equal(k2[k], k1[k], err_msg=k)


def test_cs_kernel_wrapper_rejects_cpu_tensors(hs_env):
    """K2's wrapper, like K1's, launches on CUDA tensors only."""
    env = hs_env
    x = handstand_inputs(env, N, seed=7)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = env.cfg
    before = cuda_step.LAUNCHES_CS
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.control_step_cs(
            pb.soa_model_for(env.robot.dyn), env.cparams, env.pd, cfg.sim.dt,
            cfg.control.decimation,
            eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
            t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t,
            t["cstiff"],
        )
    assert cuda_step.LAUNCHES_CS == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "terrain"])
def test_cuda_cs_kernel_matches_plain(hs_env, terrain_env, cuda_device, case):
    """K2 on the card against the plain version: flat at the handstand's
    sizes, and with ``gh`` on the tiny heightfield."""
    if case == "flat":
        env, x = hs_env, handstand_inputs(hs_env, 64, seed=5)
        keys = STATE_FIELDS + AUX_KEYS
    else:
        env = terrain_env
        x = dict(terrain_inputs(env, 64, seed=5), cstiff=np.resize(CSTIFF, 64))
        keys = POSITION_KEYS + AUX_KEYS
    ref = plain_step(env, x, cuda_device)
    before = cuda_step.LAUNCHES_CS
    got = env_step(env, x, cuda_device)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES_CS == before + 1
    assert_close(ref, got, keys)


# ---------------------------------------------------------------------------
# a last warp only partly filled: groups without an env
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hs_rev_host_lib(hs_env, tmp_path_factory):
    """The host build at the handstand's sizes, lanes reversed."""
    return build_host_lib(pb.soa_model_for(hs_env.robot.dyn),
                          tmp_path_factory.mktemp("k2_host_rev"),
                          ("-DUTRL_HOST_LANES_REVERSED",))


def first_rows(x, n):
    """Inputs or outputs cut to their first ``n`` envs (gh and p_xy are
    [points, envs])."""
    return {k: (v[:, :n] if k in ("gh", "p_xy") else v[:n]) for k, v in x.items()}


@pytest.mark.parametrize("case", ["K1", "K3", "K2 flat", "K2 terrain"])
def test_partial_warp_matches_plain(env, terrain_env, hs_env, host_lib, rev_host_lib,
                                    hs_host_lib, hs_rev_host_lib, case):
    """n_envs one short of two whole warps (7 at G = 8, 3 at G = 16): the
    last warp's group without an env writes nothing, and every real env
    gets the bits of its row of the launch over two whole warps, the same
    bits with the lanes and groups reversed, and the plain version's
    outputs at the physics tolerance."""
    n = 2 * (32 // host_lib.utrl_lanes_per_env())
    if case == "K1":
        e, libs = env, (host_lib, rev_host_lib)
        x = make_inputs(env.default_dof_pos.numpy(), n, True, seed=11)
    elif case == "K2 flat":
        e, libs = hs_env, (hs_host_lib, hs_rev_host_lib)
        x = handstand_inputs(hs_env, n, seed=11)
    else:
        e, libs = terrain_env, (host_lib, rev_host_lib)
        x = terrain_inputs(terrain_env, n, seed=11)
        if case == "K2 terrain":
            x["cstiff"] = np.resize(CSTIFF, n)
    whole = host_step(libs[0], *env_tables(e), x)
    x = first_rows(x, n - 1)
    got = host_step(libs[0], *env_tables(e), x)
    rev = host_step(libs[1], *env_tables(e), x)
    for k in got:
        np.testing.assert_array_equal(got[k], first_rows(whole, n - 1)[k], err_msg=k)
        np.testing.assert_array_equal(got[k], rev[k], err_msg=k)
    assert_close(plain_step(e, x), got, list(got))


# ---------------------------------------------------------------------------
# the humanoids' sizes: K1 at g1's, h1's and h1_2's, K3 at g1's
# ---------------------------------------------------------------------------


def humanoid_env(task, terrain=False, n=N):
    """A humanoid env on the CPU (g1 on the tiny heightfield when
    ``terrain``)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = n
    if terrain:
        tiny_terrain(cfg)
    return task_registry.get_task_class(task)(cfg, device="cpu")


def lowest_point_z(env):
    """The lowest contact point's height above its base origin at the
    default pose (its radius taken off)."""
    from unitree_rl_gym_tpu_torch.physics import contact as ct
    from unitree_rl_gym_tpu_torch.physics import dynamics as dyn

    m = env.robot.dyn
    R_w, p_w, _, v_b = dyn.fk(m, torch.zeros(3), env.base_init_quat,
                              env.default_dof_pos,
                              torch.zeros(6 + env.robot.num_dof))
    x, _ = ct.point_kinematics(m, R_w, p_w, v_b)
    return float((x[:, 2] - m.cp_radius).min())


def humanoid_inputs(env, n, seed):
    """``make_inputs`` at the humanoid's default pose with its lowest point
    4 mm into the ground (on terrain: over the sub-terrain origins, with
    ``gh`` the heights under the default-pose points)."""
    x = make_inputs(env.default_dof_pos.numpy(), n, True, seed)
    z = -lowest_point_z(env) - 0.004
    if env.terrain is None:
        x["base_pos"][:, 2] = z
        return x
    rng = np.random.default_rng(seed)
    origins = env.terrain_origins.reshape(-1, 3).numpy()
    base = origins[np.arange(n) % origins.shape[0]]
    base = base + np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                            np.full(n, z)], 1)
    x["base_pos"] = base.astype(np.float32)
    x["gh"] = env._reset_gh(torch.from_numpy(x["base_pos"])).numpy()
    return x


@pytest.fixture(scope="module")
def hum_envs():
    return {task: humanoid_env(task) for task in HUMANOIDS}


@pytest.fixture(scope="module")
def hum_host_libs(hum_envs, tmp_path_factory):
    """{(task, reversed): host build at the task's sizes}, the six g++
    builds run side by side."""
    import concurrent.futures

    jobs = [(task, rev) for task in HUMANOIDS for rev in (False, True)]

    def one(job):
        task, rev = job
        return build_host_lib(
            pb.soa_model_for(hum_envs[task].robot.dyn),
            tmp_path_factory.mktemp(f"hum_{task}_{int(rev)}"),
            ("-DUTRL_HOST_LANES_REVERSED",) if rev else ())

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return dict(zip(jobs, ex.map(one, jobs)))


HUM_CASES = ["K1 g1", "K1 h1", "K1 h1_2", "K3 g1"]


@pytest.fixture(scope="module")
def hum_cases(hum_envs):
    """{case: (env, its task)}: the flat envs and g1 on the tiny
    heightfield."""
    out = {f"K1 {t}": (e, t) for t, e in hum_envs.items()}
    out["K3 g1"] = (humanoid_env("g1", terrain=True), "g1")
    return out


@pytest.mark.parametrize("task", list(HUMANOIDS))
def test_humanoid_sizes_and_scratch(hum_envs, hum_host_libs, task):
    """The humanoid builds' sizes, and their scratch (flat and terrain)
    fits the SM's shared memory as go2's does
    (test_scratch_fits_shared_memory)."""
    m = pb.soa_model_for(hum_envs[task].robot.dyn)
    assert (m.nb, m.nv, m.ncp, m.nrb,
            hum_envs[task].cfg.control.decimation) == HUMANOIDS[task]
    lib = hum_host_libs[(task, False)]
    check_scratch_fits(lib, [lib.utrl_scratch_bytes(0), lib.utrl_scratch_bytes(1)])


@pytest.fixture(scope="module")
def hum_host_vs_plain(hum_cases, hum_host_libs):
    """{case: (plain outputs, host-body outputs)} at N=8, grounded."""
    out = {}
    for case, (e, task) in hum_cases.items():
        x = humanoid_inputs(e, N, seed=4)
        out[case] = (plain_step(e, x),
                     host_step(hum_host_libs[(task, False)], *env_tables(e), x))
    return out


@pytest.mark.parametrize("case", HUM_CASES)
def test_humanoid_host_body_matches_plain(hum_host_vs_plain, case):
    ref, got = hum_host_vs_plain[case]
    assert_close(ref, got, list(ref))
    assert float(np.abs(got["cf_rb"]).max()) > 1.0


@pytest.mark.parametrize("case", HUM_CASES)
def test_humanoid_partial_warp_and_lane_order(hum_cases, hum_host_libs, case):
    """n_envs one short of two whole warps: every real env gets the bits of
    its row of the launch over two whole warps, the same bits with every
    phase's lanes and groups reversed (h1_2's 9 bodies without a point and
    56 report bodies over 13 dyn bodies included), and the plain version's
    outputs at the physics tolerance."""
    e, task = hum_cases[case]
    lib, rev = hum_host_libs[(task, False)], hum_host_libs[(task, True)]
    n = 2 * (32 // lib.utrl_lanes_per_env())
    x = humanoid_inputs(e, n, seed=11)
    whole = host_step(lib, *env_tables(e), x)
    rev_whole = host_step(rev, *env_tables(e), x)
    x = first_rows(x, n - 1)
    got = host_step(lib, *env_tables(e), x)
    for k in got:
        np.testing.assert_array_equal(whole[k], rev_whole[k], err_msg=k)
        np.testing.assert_array_equal(got[k], first_rows(whole, n - 1)[k], err_msg=k)
    assert_close(plain_step(e, x), got, list(got))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HUM_CASES + ["K3 h1_2"])
def test_cuda_humanoid_kernel_matches_plain(hum_envs, cuda_device, case):
    """K1 at g1's, h1's and h1_2's sizes and K3 at g1's and h1_2's on the
    card against the plain version at N=64, grounded."""
    kernel, task = case.split()
    e = humanoid_env(task, terrain=kernel == "K3", n=64)
    x = humanoid_inputs(e, 64, seed=5)
    ref = plain_step(e, x, cuda_device)
    counter = "LAUNCHES_TERRAIN" if kernel == "K3" else "LAUNCHES"
    before = getattr(cuda_step, counter)
    got = env_step(e, x, cuda_device)
    torch.cuda.synchronize()
    assert getattr(cuda_step, counter) == before + 1
    assert_close(ref, got, list(ref))
    assert float(np.abs(got["cf_rb"]).max()) > 1.0
