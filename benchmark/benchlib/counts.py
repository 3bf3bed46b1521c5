"""Frozen work counts: the yardstick of the roofline and mfu metrics.

``flops_per_env`` and ``bytes_per_env`` are copies of the port's
``physics/cuda_step.py`` functions of the same names as the benchmark was
accepted with (a later kernel cannot change what the bound counts); they
take any object with the SoA model's sizes (``nb``, ``nj``, ``nv``,
``ncp``, ``nrb``, ``parent``). The networks' counts are the matrix
products' multiply-adds, two operations each, counted from the widths.
"""


def flops_per_env(m, decimation: int, iterations: int,
                  terrain: bool = False, cs: bool = False) -> int:
    """Floating-point operations of one env's control step (add, sub, mul,
    div, min, max, sqrt, sin, cos, tanh each count 1; a 3x3 mat-vec is 15,
    a 3x3 product 45, a cross product 9, a spatial transform 42).
    ``terrain``: the ground height per point and substep and the
    end-of-step point xy; ``cs``: the contact stiffness per point and
    substep."""
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


def bytes_per_env(m, terrain: bool = False, cs: bool = False) -> int:
    """Bytes one env must move: each fp32 input read once, each output
    written once (the model tables are shared by all envs)."""
    n_in = (3 + 4 + m.nj + m.nv + m.nj + 1 + 1 + (m.ncp if terrain else 0)
            + (1 if cs else 0))
    n_out = (3 + 4 + m.nj + m.nv + m.nj + 3 * 3 * m.nrb
             + (2 * m.ncp if terrain else 0))
    return 4 * (n_in + n_out)


def mlp_flops(in_dim: int, hidden, out_dim: int) -> int:
    """Operations of one sample through a dense stack."""
    dims = [in_dim] + list(hidden) + [out_dim]
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def lstm_flops(in_dim: int, hidden: int, layers: int = 1) -> int:
    """Operations of one sample through one step of a stacked LSTM (the
    gates' input and recurrent products)."""
    total, d = 0, in_dim
    for _ in range(layers):
        total += 2 * (d * 4 * hidden + hidden * 4 * hidden)
        d = hidden
    return total
