"""Kernels K1, K3 and K2 — the decimated physics control step on flat
ground (K1), on heightfield terrain (K3), and on either with a per-env
contact stiffness (K2) as hand-written CUDA kernels for Hopper (sm_90a) —
and K4, one rank's launch of its K1, K3 or K2 instance on its own env
block: tables, build, binding, launch counts.

Replace the JAX package's Pallas TPU kernel
(``unitree_rl_gym_tpu/physics/pallas_step.py::_kernel`` launched by
``control_step_pallas``): K1 its flat variant (``has_gh=False,
has_cs=False``), K3 its terrain variant (``has_gh=True``), K2 its
contact-stiffness variant (``has_cs=True``, with or without ``has_gh``);
K4 replaces ``control_step_pallas_sharded``, which runs one instance of
the kernel per device of the ("env",) mesh on its local env block.
The per-env body is ``csrc/control_step.cuh`` (one thread per env, one
template, ``HAS_GH`` x ``HAS_CS``); the notes at the top of
``csrc/control_step.cu`` (K1, K3) and ``csrc/control_step_cs.cu`` (K2) say
what bounds them on the H100 and what the design does about it;
:func:`flops_per_env` and :func:`bytes_per_env` give the arithmetic behind
those notes.

Build: ``nvcc -shared -Xcompiler -fPIC`` of each source of
:data:`LIBRARIES` into a shared library with a plain C interface, at first
use, into ``unitree_rl_gym_tpu_torch/_build/<hash>/`` (keyed on the source,
the header and the flags, git-ignored); loaded with ``ctypes``. No PyTorch
headers are compiled, so a build takes seconds; :func:`build_all` starts
every build of a list of models at once. The model's sizes are
compile-time constants (``-DUTRL_NB/NCP/NRB``); its numbers travel as a
:func:`model_tables` byte buffer on the device.

:func:`control_step` (K1), :func:`control_step_terrain` (K3),
:func:`control_step_cs` (K2) and :func:`control_step_sharded` (K4) are the
wrappers: each launches its kernel on CUDA tensors and raises on anything
else (``backend.control_step`` sends CPU tensors to the plain version).
``LAUNCHES`` counts K1's launches, ``LAUNCHES_TERRAIN`` K3's,
``LAUNCHES_CS`` K2's and ``LAUNCHES_SHARDED`` K4's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_TORCH_DIR
from unitree_rl_gym_tpu_torch.physics import engine as eng
from unitree_rl_gym_tpu_torch.physics import soa

CSRC_DIR = os.path.join(UNITREE_RL_GYM_TPU_TORCH_DIR, "csrc")
BUILD_DIR = os.path.join(UNITREE_RL_GYM_TPU_TORCH_DIR, "_build")
HEADER = "control_step.cuh"
# library name -> its source (each built into its own shared library)
LIBRARIES = {
    "control_step": "control_step.cu",        # K1, K3
    "control_step_cs": "control_step_cs.cu",  # K2
}
# -fmad=false: no multiply-add contraction, so the kernels round every
# product and sum as the plain version's separate torch ops do (the contact
# solve amplifies last-bit differences into visible velocity errors)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel launches since the last reset (chip_smoke.py zeroes them around
# each path it drives to show that the path went through the kernel)
LAUNCHES = 0            # K1
LAUNCHES_TERRAIN = 0    # K3
LAUNCHES_CS = 0         # K2 (flat and terrain)
LAUNCHES_SHARDED = 0    # K4 (a rank's K1, K3 or K2 instance on its block)
# nvcc's stderr (ptxas register / spill report) of each build, by library
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[tuple, ctypes.CDLL] = {}   # by (library, flags, sizes)
_TABLES: Dict[tuple, tuple] = {}
_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# model tables (layout of ModelTables in csrc/control_step.cuh)
# ---------------------------------------------------------------------------


def size_defines(m: soa.SoAModel) -> Tuple[str, ...]:
    """The compile-time sizes of the per-env arrays."""
    return (f"-DUTRL_NB={m.nb}", f"-DUTRL_NCP={m.ncp}", f"-DUTRL_NRB={m.nrb}")


def model_tables(m: soa.SoAModel, cparams, pd, sim_dt, decimation,
                 m_eff_n, m_eff_t) -> bytes:
    """Pack everything the kernel reads about the robot and the solver into
    the byte layout of ``ModelTables`` (every field 4 bytes, no padding).
    ``m_eff_n``/``m_eff_t`` come in the model's original point order."""
    nb, nj, nv = m.nb, m.nj, m.nv
    perm = m.cp_perm
    cp_rb = np.zeros(m.ncp, np.int32)
    for r, idx in enumerate(m.cp_rb):
        cp_rb[list(idx)] = r
    order = np.asarray(m.chol_order, np.int32)
    pos = np.empty(nv, np.int32)
    pos[order] = np.arange(nv, dtype=np.int32)
    ints = [
        np.asarray(m.parent, np.int32),
        np.asarray([s for s, _ in m.cp_slice], np.int32),
        np.asarray([e for _, e in m.cp_slice], np.int32),
        cp_rb,
        np.asarray(m.rb_dyn, np.int32),
        order,
        pos,
        np.asarray([cparams.iterations, decimation, int(pd.clip_torque)],
                   np.int32),
    ]
    floats = [
        np.asarray(m.axis).reshape(nj, 3),
        np.asarray(m.Etree).reshape(nj, 9),
        np.asarray(m.rtree).reshape(nj, 3),
        np.asarray([blk[0] for blk in m.I_blk]).reshape(nb, 9),
        np.asarray([blk[1] for blk in m.I_blk]).reshape(nb, 9),
        np.asarray([blk[2] for blk in m.I_blk]),
        np.asarray(m.dof_damping),
        np.asarray(m.dof_friction),
        np.asarray(m.dof_vel_limit),
        np.asarray(m.dof_lower),
        np.asarray(m.dof_upper),
        np.asarray(pd.kp),
        np.asarray(pd.kd),
        np.asarray(pd.torque_limit),
        np.asarray(m.cp_pos),
        np.asarray(m.cp_radius),
        np.asarray(m_eff_n)[perm],
        np.asarray(m_eff_t)[perm],
        np.asarray(m.rb_pos),
        np.asarray(m.gravity),
        np.asarray([
            m.armature, sim_dt, cparams.baumgarte,
            cparams.max_depenetration_velocity, cparams.terrain_friction,
            cparams.relaxation, cparams.max_angular_velocity,
            cparams.max_linear_velocity,
        ]),
    ]
    return b"".join(
        [a.astype(np.int32).tobytes() for a in ints]
        + [np.asarray(a, np.float64).astype(np.float32).tobytes() for a in floats]
    )


# ---------------------------------------------------------------------------
# work per env (the arithmetic behind the bound in csrc/control_step.cu)
# ---------------------------------------------------------------------------


def flops_per_env(m: soa.SoAModel, decimation: int, iterations: int,
                  terrain: bool = False, cs: bool = False) -> int:
    """Floating-point operations of one env's control step in the kernel
    body, counted from csrc/control_step.cuh (add, sub, mul, div, min, max,
    sqrt, sin, cos, tanh each count 1; a 3x3 mat-vec is 15, a 3x3 product
    45, a cross product 9, a spatial transform 42). ``terrain`` counts K3:
    one add per point and substep for the ground height, and the end-of-step
    point xy (2 x 6 per point). ``cs`` counts K2: one multiply per point and
    substep for the contact stiffness."""
    nb, nj, nv, ncp, nrb = m.nb, m.nj, m.nv, m.ncp, m.nrb
    depth = 0  # sum over joints of their chain length to the base (CRBA)
    for i in range(1, nb):
        k = i
        while m.parent[k] != -1:
            depth += 1
            k = m.parent[k]
    fk = 150 * nj + 24
    vprop = 48 * nj
    bias = 18 + 122 * nj + 156 * nb
    crba = 18 * nb + 612 * nj + 36 * nj + 47 * depth
    chol = sum((nv - j) * (2 * j + 1) for j in range(nv)) + 3 * nv
    solve = 2 * nv * nv
    setup = 23 * ncp + 2 * nb
    pgs = vprop + 61 * nb + 50 * ncp + 53 * nj + solve + nv
    tail = 2 * nv + 76 + 6 * nj
    substep = (fk + vprop + 6 * nj + bias + crba + chol + solve + 6 * nj
               + 2 * nv + setup + iterations * pgs + tail)
    post = fk + vprop + 45 * nrb + 6 * ncp
    if terrain:
        substep += ncp
        post += 12 * ncp
    if cs:
        substep += ncp
    return decimation * substep + post


def bytes_per_env(m: soa.SoAModel, terrain: bool = False,
                  cs: bool = False) -> int:
    """Bytes one env must move: each fp32 input read once, each output
    written once (the model tables are shared by all envs). ``terrain``
    counts K3: gh [ncp] in, p_xy [2*ncp] out; ``cs`` counts K2's contact
    stiffness, one float in."""
    n_in = (3 + 4 + m.nj + m.nv + m.nj + 1 + 1 + (m.ncp if terrain else 0)
            + (1 if cs else 0))
    n_out = (3 + 4 + m.nj + m.nv + m.nj + 3 * 3 * m.nrb
             + (2 * m.ncp if terrain else 0))
    return 4 * (n_in + n_out)


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(m: soa.SoAModel, library: str = "control_step") -> str:
    """Where the build of ``library`` for this model's sizes lives (hash of
    its source, the header and the flags)."""
    h = hashlib.sha256()
    for name in (LIBRARIES[library], HEADER):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + size_defines(m)).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], f"lib{library}.so")


def build(m: soa.SoAModel, library: str = "control_step") -> str:
    """Compile ``library`` for this model's sizes unless a build with the
    same sources and flags exists; returns the library path."""
    path = library_path(m, library)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *size_defines(m), "-I", CSRC_DIR,
           "-o", tmp, os.path.join(CSRC_DIR, LIBRARIES[library])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, path)
    BUILD_LOGS[path] = res.stderr
    return path


def build_all(models) -> Dict[tuple, str]:
    """Build every library of :data:`LIBRARIES` for every SoAModel of
    ``models``, all nvcc processes started together; returns
    {(library, sizes): path}. A failed build raises."""
    jobs = {(lib, size_defines(m)): (m, lib) for m in models for lib in LIBRARIES}
    out, errors = {}, []

    def one(key):
        try:
            out[key] = build(*jobs[key])
        except Exception as e:  # re-raised below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=one, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# ctypes argument counts of each entry point: tables, n_envs, the operand
# and output pointers, the stream
_ENTRY_POINTS = {
    "control_step": {"utrl_control_step": 16,
                     "utrl_control_step_terrain": 18},
    "control_step_cs": {"utrl_control_step_cs": 17,
                        "utrl_control_step_terrain_cs": 19},
}


def _library(m: soa.SoAModel, library: str = "control_step") -> ctypes.CDLL:
    """The loaded ``library`` for this model's sizes; built (or found by the
    hash of its sources) once per process, not hashed again per launch."""
    key = (library, NVCC_FLAGS, size_defines(m))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(m, library))
            lib.utrl_model_bytes.restype = ctypes.c_longlong
            lib.utrl_model_bytes.argtypes = []
            for name, n_ptr in _ENTRY_POINTS[library].items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                               + [ctypes.c_void_p] * n_ptr)
            _LIBS[key] = lib
    return lib


def _device_tables(lib, m, cparams, pd, sim_dt, decimation, m_eff_n, m_eff_t,
                   device) -> torch.Tensor:
    """The packed tables on ``device``, built once per set of operands. The
    cache entry holds the operands themselves, so their ids stay theirs."""
    key = (id(m), id(cparams), id(pd), float(sim_dt), int(decimation),
           id(m_eff_n), id(m_eff_t), str(device))
    hit = _TABLES.get(key)
    if hit is None:
        blob = model_tables(m, cparams, pd, sim_dt, decimation, m_eff_n, m_eff_t)
        if len(blob) != lib.utrl_model_bytes():
            raise RuntimeError(
                f"model tables are {len(blob)} bytes, the kernel's ModelTables "
                f"is {lib.utrl_model_bytes()}"
            )
        host = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        hit = _TABLES[key] = (host.to(device), (m, cparams, pd, m_eff_n, m_eff_t))
    return hit[0]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(m, cparams, pd, sim_dt, decimation, state, target, friction,
            mass_scale, m_eff_n, m_eff_t, gh, cstiff, name):
    """Check the operands, allocate the outputs and launch K1 (``gh`` and
    ``cstiff`` None), K3 (``gh``) or K2 (``cstiff``, with or without
    ``gh``) on the current stream. Returns (PhysicsState, aux)."""
    dev = state.joint_q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel {name} runs on CUDA tensors, got {dev}")
    N = state.joint_q.shape[0]
    nj, nv, nrb, ncp = m.nj, m.nv, m.nrb, m.ncp
    inputs = [
        ("base_pos", state.base_pos, (N, 3)),
        ("base_quat", state.base_quat, (N, 4)),
        ("joint_q", state.joint_q, (N, nj)),
        ("v", state.v, (N, nv)),
        ("target", target, (N, nj)),
        ("friction", friction, (N,)),
        ("mass_scale", mass_scale, (N,)),
    ]
    if gh is not None:
        inputs.append(("gh", gh, (ncp, N)))
    if cstiff is not None:
        inputs.append(("cstiff", cstiff, (N,)))
    for arg, t, shape in inputs:
        _check(arg, t, shape, dev)
    lib = _library(m, "control_step" if cstiff is None else "control_step_cs")
    tables = _device_tables(lib, m, cparams, pd, sim_dt, decimation, m_eff_n,
                            m_eff_t, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = dict(
        base_pos=empty(N, 3), base_quat=empty(N, 4), joint_q=empty(N, nj),
        v=empty(N, nv), torques=empty(N, nj), cf_rb=empty(N, nrb, 3),
        rb_pos_w=empty(N, nrb, 3), rb_vel_w=empty(N, nrb, 3),
    )
    if gh is not None:
        out["p_xy"] = empty(2 * ncp, N)
    fn = getattr(lib, "utrl_control_step" + ("_terrain" if gh is not None else "")
                 + ("_cs" if cstiff is not None else ""))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            tables.data_ptr(), N,
            *(t.data_ptr() for _, t, _ in inputs),
            *(t.data_ptr() for t in out.values()),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel {name} launch failed: cudaError {err}")
    new_state = eng.PhysicsState(
        base_pos=out.pop("base_pos"), base_quat=out.pop("base_quat"),
        joint_q=out.pop("joint_q"), v=out.pop("v"),
    )
    return new_state, out


def control_step(m: soa.SoAModel, cparams, pd, sim_dt, decimation, state,
                 target, friction, mass_scale, m_eff_n, m_eff_t):
    """K1's wrapper: the decimated control step of every env of SoAModel
    ``m`` on flat ground, launched on the current stream. Raises on a tensor
    that is not on CUDA or that the kernel does not take. Returns
    (PhysicsState, aux) like ``backend.control_step_soa``."""
    res = _launch(m, cparams, pd, sim_dt, decimation, state, target, friction,
                  mass_scale, m_eff_n, m_eff_t, None, None, "K1")
    global LAUNCHES
    LAUNCHES += 1
    return res


def control_step_terrain(m: soa.SoAModel, cparams, pd, sim_dt, decimation,
                         state, target, friction, mass_scale, m_eff_n,
                         m_eff_t, gh):
    """K3's wrapper: K1 above per-point ground heights ``gh`` [ncp, N]
    (frozen across the substeps); aux gains ``p_xy`` [2*ncp, N], the
    end-of-step world x and y rows of every point. Raises like K1's."""
    res = _launch(m, cparams, pd, sim_dt, decimation, state, target, friction,
                  mass_scale, m_eff_n, m_eff_t, gh, None, "K3")
    global LAUNCHES_TERRAIN
    LAUNCHES_TERRAIN += 1
    return res


def control_step_cs(m: soa.SoAModel, cparams, pd, sim_dt, decimation,
                    state, target, friction, mass_scale, m_eff_n, m_eff_t,
                    cstiff, gh=None):
    """K2's wrapper: K1 (``gh`` None) or K3 (``gh`` [ncp, N]) with every
    env's contact de-penetration bias scaled by ``cstiff`` [N] after its
    clamp. Raises like K1's."""
    res = _launch(m, cparams, pd, sim_dt, decimation, state, target, friction,
                  mass_scale, m_eff_n, m_eff_t, gh, cstiff, "K2")
    global LAUNCHES_CS
    LAUNCHES_CS += 1
    return res


def control_step_sharded(m: soa.SoAModel, cparams, pd, sim_dt, decimation,
                         state, target, friction, mass_scale, m_eff_n,
                         m_eff_t, block, gh=None, cstiff=None):
    """K4's wrapper: this rank's launch of K1 (``gh`` and ``cstiff`` None),
    K3 (``gh``) or K2 (``cstiff``) on its env block ``block``
    (``parallel.mesh.EnvBlock``), on the current stream of the rank's
    device. Every operand holds the block's ``n_local`` envs; ``gh`` is the
    block's contiguous [ncp, n_local] rows (a strided view of the global
    rows raises) and aux's ``p_xy`` comes back as [2*ncp, n_local]. Envs
    are independent and the kernel runs one thread per env, so the outputs
    are the bits of the block's rows of a launch over all envs. Raises like
    K1's, and on a batch that is not the block's."""
    n = state.joint_q.shape[0]
    if n != block.n_local:
        raise ValueError(f"K4 got {n} envs, rank {block.rank}'s block holds "
                         f"{block.n_local}")
    instance = "K2" if cstiff is not None else ("K3" if gh is not None else "K1")
    res = _launch(m, cparams, pd, sim_dt, decimation, state, target, friction,
                  mass_scale, m_eff_n, m_eff_t, gh, cstiff,
                  f"K4 ({instance} on rank {block.rank})")
    global LAUNCHES_SHARDED
    LAUNCHES_SHARDED += 1
    return res
