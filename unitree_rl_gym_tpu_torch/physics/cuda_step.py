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
The per-env body is ``csrc/control_step.cuh`` (a group of 8 lanes per
env, four envs a warp, each env's working set in its slice of shared
memory and what one lane alone reads across phases in its registers; one
template, ``HAS_GH`` x ``HAS_CS``), scheduled by the level and chain tables
:func:`model_tables` appends
(:func:`schedule_tables`); the notes at the top of
``csrc/control_step.cu`` (K1, K3) and ``csrc/control_step_cs.cu`` (K2) say
what bounds them on the H100 and what the design does about it;
:func:`flops_per_env` and :func:`bytes_per_env` give the arithmetic behind
those notes.

Build: ``nvcc -shared -Xcompiler -fPIC`` of each source of
:data:`LIBRARIES` into a shared library with a plain C interface, at first
use, into ``unitree_rl_gym_tpu_torch/_build/<hash>/`` (keyed on the source,
the header and the flags, git-ignored; ``utils/cache.py`` relocates it or
turns it off); loaded with ``ctypes``. No PyTorch
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
DEFAULT_BUILD_DIR = os.path.join(UNITREE_RL_GYM_TPU_TORCH_DIR, "_build")
# where builds go (``utils/cache.enable_persistent_cache`` moves it)
BUILD_DIR = DEFAULT_BUILD_DIR
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


def tree_levels(m: soa.SoAModel) -> np.ndarray:
    """Depth of every body in the kinematic tree (base 0): the levels by
    which the kernel's CRBA composites run, one level a phase. Bodies come
    after their parents (``parent[i] < i``), as the recursions assume."""
    depth = np.zeros(m.nb, np.int32)
    for i in range(1, m.nb):
        if not 0 <= m.parent[i] < i:
            raise ValueError(f"body {i}'s parent {m.parent[i]} does not precede it")
        depth[i] = depth[m.parent[i]] + 1
    return depth


def chol_pattern(m: soa.SoAModel) -> np.ndarray:
    """Structural nonzeros of the Cholesky factor of H in elimination order
    (lower triangle, fill included): what CRBA writes (the base block, each
    joint with the base and with its chain's joints), closed under
    elimination."""
    nv = m.nv
    pos = np.empty(nv, np.int64)
    pos[np.asarray(m.chol_order)] = np.arange(nv)
    nz = np.zeros((nv, nv), bool)

    def mark(a, b):
        i, j = pos[a], pos[b]
        nz[max(i, j), min(i, j)] = True

    for r in range(6):
        for c in range(6):
            mark(r, c)
    for i in range(1, m.nb):
        j = i - 1
        for r in range(6):
            mark(6 + j, r)
        k = i
        while k != 0:
            mark(6 + j, 6 + k - 1)
            k = m.parent[k]
    for k in range(nv):
        rows = np.nonzero(nz[k + 1:, k])[0] + k + 1
        for a in rows:
            nz[a, rows[rows <= a]] = True
    return nz


def _chains(parent, root_alone=False):
    """Chains of the forest ``parent`` (-1 at a root), by which the kernel
    runs a pass over it with a lane a chain: a chain starts at a root, at a
    root's child with ``root_alone``, or at a child of a node with more
    than one child, and goes on to a node's only child. Returns (the nodes
    chain by chain, each from its head; each chain's first entry, then the
    entry count; each level's first chain, then the chain count), the
    chains ordered by level (a root's chain 0, any other one more than the
    chain of its head's parent), then by head."""
    n = len(parent)
    children = [[c for c in range(n) if parent[c] == i] for i in range(n)]
    depth = [0] * n
    for i in range(n):
        k = i
        while parent[k] >= 0:
            k, depth[i] = parent[k], depth[i] + 1

    def head(b):
        p = parent[b]
        return (p < 0 or (root_alone and parent[p] < 0)
                or len(children[p]) != 1)

    chains, level, chain_of = [], [], {}
    for h in sorted((b for b in range(n) if head(b)), key=lambda b: (depth[b], b)):
        ch = [h]
        while len(children[ch[-1]]) == 1 and not head(children[ch[-1]][0]):
            ch.append(children[ch[-1]][0])
        level.append(0 if parent[h] < 0 else level[chain_of[parent[h]]] + 1)
        chain_of.update({b: len(chains) for b in ch})
        chains.append(ch)
    order = sorted(range(len(chains)), key=lambda c: (level[c], chains[c][0]))
    nodes = [b for c in order for b in chains[c]]
    first = np.cumsum([0] + [len(chains[c]) for c in order])
    lv = [level[c] for c in order]
    return (np.asarray(nodes, np.int32), first.astype(np.int32),
            np.searchsorted(lv, np.arange(max(lv) + 2)).astype(np.int32))


def body_chains(m: soa.SoAModel):
    """Chains of the kinematic tree (``_chains``): the base alone, level 0;
    each of its children heads a chain of level 1 (go2: a leg, hip to
    calf). The kernel's FK, velocity, RNEA and force passes run a phase a
    level, each lane a chain: down it (FK, velocities, accelerations) or
    up it (forces)."""
    return _chains(list(m.parent), root_alone=True)


def elim_chains(m: soa.SoAModel):
    """Chains of the joints' elimination tree (``_chains``): a joint
    position's parent is its column's first structural nonzero below the
    diagonal, a root one whose parent is a base position (go2: a leg, calf
    to hip, under the base rows). An entry (i, j) of L needs the entries of
    the columns k < j where both rows are structural nonzeros: j's
    descendants. The kernel's factor and forward solve run the levels from
    the deepest, each lane a chain from its tail up; the back solve the
    levels from 0, each chain from its head down."""
    nz = chol_pattern(m)
    nj = m.nj
    par = [int(np.nonzero(nz[j + 1:, j])[0][0]) + j + 1 for j in range(nj)]
    return _chains([p if p < nj else -1 for p in par])


def _bits(sets, n) -> np.ndarray:
    """[n] uint32: entry i has bit k set for every k of sets[i]."""
    out = np.zeros(n, np.uint32)
    for i, ks in enumerate(sets):
        for k in ks:
            out[i] |= np.uint32(1 << int(k))
    return out


def schedule_tables(m: soa.SoAModel) -> list:
    """The warp schedule's fields of ``ModelTables``, in order: bodies by
    depth, the depth count, each body's children, each point's body, L's
    row and column patterns (sets as bit masks); the body chains (bodies,
    each chain's first entry, each level's first chain, the level count)
    and the elimination chains (joint positions, the same); the bodies
    listed by depth with each depth's first entry, and the points listed by
    report body with each report body's [start, end)."""
    nb, nv = m.nb, m.nv
    if nb > 32 or nv > 32:
        raise ValueError(f"{nb} bodies / {nv} dofs: the tables hold 32 bits")
    depth = tree_levels(m)
    nz = chol_pattern(m)
    cp_dyn = np.zeros(m.ncp, np.int32)
    for b, (s, e) in enumerate(m.cp_slice):
        cp_dyn[s:e] = b
    cp_rb = np.zeros(m.ncp, np.int32)
    for r, idx in enumerate(m.cp_rb):
        cp_rb[list(idx)] = r
    chains = []
    for nodes, first, lvl in (body_chains(m), elim_chains(m)):
        n = len(nodes)
        chains += [nodes, np.pad(first, (0, n + 1 - len(first)), mode="edge"),
                   np.pad(lvl, (0, n + 1 - len(lvl)), mode="edge"), [len(lvl) - 1]]
    return [
        _bits([np.nonzero(depth == d)[0] for d in range(depth.max() + 1)], nb),
        [depth.max() + 1],
        _bits([[c for c in range(nb) if m.parent[c] == i] for i in range(nb)], nb),
        cp_dyn,
        _bits([np.nonzero(nz[i, :i])[0] for i in range(nv)], nv),
        _bits([np.nonzero(nz[i + 1:, i])[0] + i + 1 for i in range(nv)], nv),
        *chains,
        np.argsort(depth, kind="stable"),
        np.pad(np.searchsorted(np.sort(depth), np.arange(depth.max() + 1)),
               (0, nb - depth.max() - 1)),
        np.argsort(cp_rb, kind="stable"),
        np.searchsorted(np.sort(cp_rb), np.arange(m.nrb)),
        np.searchsorted(np.sort(cp_rb), np.arange(m.nrb), side="right"),
    ]


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
        + [np.asarray(a).astype(np.uint32).tobytes() for a in schedule_tables(m)]
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


def source_path(sources, flags, name: str) -> str:
    """Where the build of ``csrc/`` files ``sources`` (the first one
    compiled, the rest included) with ``flags`` lives: a hash of their
    contents and the flags under :data:`BUILD_DIR`."""
    h = hashlib.sha256()
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], f"lib{name}.so")


def library_path(m: soa.SoAModel, library: str = "control_step") -> str:
    """Where the build of ``library`` for this model's sizes lives (hash of
    its source, the header and the flags)."""
    return source_path((LIBRARIES[library], HEADER),
                       NVCC_FLAGS + size_defines(m), library)


def build(m: soa.SoAModel, library: str = "control_step") -> str:
    """Compile ``library`` for this model's sizes unless a build with the
    same sources and flags exists; returns the library path. The nvcc
    report (ptxas registers and spills) is kept beside the library and
    read into :data:`BUILD_LOGS` either way."""
    return build_source((LIBRARIES[library], HEADER),
                        NVCC_FLAGS + size_defines(m), library)


def build_source(sources, flags, name: str) -> str:
    """Compile ``csrc/`` ``sources[0]`` (including the rest) with ``flags``
    into ``lib<name>.so`` at :func:`source_path` unless it exists there;
    returns the path. nvcc's report goes beside it and into
    :data:`BUILD_LOGS`."""
    path = source_path(sources, flags, name)
    log = f"{path}.nvcc.log"
    if os.path.exists(path):
        if os.path.exists(log):
            with open(log) as f:
                BUILD_LOGS[path] = f.read()
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, sources[0])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    with open(log, "w") as f:
        f.write(res.stderr)
    os.replace(tmp, path)
    BUILD_LOGS[path] = res.stderr
    return path


def build_all(models, only=()) -> Dict[tuple, str]:
    """Build every library of :data:`LIBRARIES` for every SoAModel of
    ``models``, and each (SoAModel, library) pair of ``only``, all nvcc
    processes started together; returns {(library, sizes): path}. A failed
    build raises."""
    jobs = {(lib, size_defines(m)): (m, lib) for m in models for lib in LIBRARIES}
    jobs.update({(lib, size_defines(m)): (m, lib) for m, lib in only})
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
            lib.utrl_scratch_bytes.restype = ctypes.c_longlong
            lib.utrl_scratch_bytes.argtypes = [ctypes.c_int]
            lib.utrl_lanes_per_env.restype = ctypes.c_int
            lib.utrl_lanes_per_env.argtypes = []
            lib.utrl_envs_per_block.restype = ctypes.c_int
            lib.utrl_envs_per_block.argtypes = []
            lib.utrl_resident_blocks.restype = ctypes.c_int
            lib.utrl_resident_blocks.argtypes = [ctypes.c_int]
            for name, n_ptr in _ENTRY_POINTS[library].items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                               + [ctypes.c_void_p] * n_ptr)
            _LIBS[key] = lib
    return lib


def scratch_bytes(m: soa.SoAModel, library: str = "control_step",
                  terrain: bool = False) -> int:
    """One env's shared-memory scratch, padded to the stride at which the
    launch lays out the envs of a warp, in the build of ``library`` for
    this model's sizes, with or without ``gh``."""
    return int(_library(m, library).utrl_scratch_bytes(int(terrain)))


def lanes_per_env(m: soa.SoAModel, library: str = "control_step") -> int:
    """The lanes of a warp that compute one env (G) in the build of
    ``library`` for this model's sizes."""
    return int(_library(m, library).utrl_lanes_per_env())


def resident_envs(m: soa.SoAModel, library: str = "control_step",
                  terrain: bool = False) -> Tuple[int, int]:
    """(blocks, envs per block) of the instance of ``library`` (flat or
    ``terrain``; K2's in ``control_step_cs``) that the current CUDA device
    keeps resident on one SM at the launch's block size and shared memory,
    as the CUDA runtime's occupancy calculator gives it. Raises on a CUDA
    error."""
    lib = _library(m, library)
    blocks = int(lib.utrl_resident_blocks(int(terrain)))
    if blocks < 0:
        raise RuntimeError(f"{library}: occupancy query failed with CUDA error "
                           f"{-blocks}")
    return blocks, int(lib.utrl_envs_per_block())


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
    are independent (each env's group of lanes computes it alone, and a
    group without an env writes nothing), so the outputs are the bits of
    the block's rows of a launch over all envs. Raises like
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
