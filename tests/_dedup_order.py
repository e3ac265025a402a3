"""The tile-dedup kernels' grouping and summation order in numpy float32:
``scatter_dedup``, ``fused_chain`` and ``gather_mul_scatter``.

``csrc/scatter_dedup.cu``, ``csrc/fused_chain.cu`` and
``csrc/gather_mul_scatter.cu`` run only on the card.
These functions repeat their arithmetic, operation for operation, on the
CPU: every product and sum is one float32 rounding (the kernels use
``__fmul_rn`` and ``__fadd_rn``, no contraction), taken in the kernels'
order.  A tile is ``tile_rows(d)`` consecutive batch rows; a group is the
tile's rows with one in-range id (0 <= id < S; other rows drop); its
leader is its lowest row.  The leader's row comes first, the others are
added in ascending row order, and the sum is added once into the view.
Tiles are taken in order here; on the card they meet in the reductions in
no fixed order, so the kernels equal this bit for bit where an id repeats
only within a tile.  Used by ``tests/test_torch_dedup_hopper.py`` and
``tests/test_torch_gms_hopper.py`` (against the plain versions and the JAX
package) and ``tests/test_torch_cuda.py`` (bitwise against the kernels).
"""
import numpy as np

from repro_torch.kernels import ring_scatter

#: the first round of a lane's groups spans this many columns after the
#: row's head (32 lanes, four columns each)
ROUND_COLS = 128


def tile_groups(ids: np.ndarray, S: int, T: int):
    """(leader, members) of every group, tile by tile in order: members the
    group's rows in ascending order, the leader first."""
    out = []
    for r0 in range(0, len(ids), T):
        seen: dict = {}
        for b in range(r0, min(r0 + T, len(ids))):
            if 0 <= ids[b] < S:
                seen.setdefault(int(ids[b]), []).append(b)
        out.extend((rows[0], rows) for rows in seen.values())
    return out


def scatter_dedup_order(view: np.ndarray, ids: np.ndarray, vals: np.ndarray,
                        T: int | None = None) -> np.ndarray:
    """view [S, d] ⊎= vals [B, d] at ids as ``scatter_dedup`` sums it: a
    new array."""
    view = view.astype(np.float32).copy()
    S, d = view.shape
    T = ring_scatter.tile_rows(d) if T is None else T
    for leader, rows in tile_groups(ids, S, T):
        s = vals[leader].astype(np.float32).copy()
        for f in rows[1:]:
            s = s + vals[f]
        view[ids[leader]] = view[ids[leader]] + s
    return view


def gather_mul_scatter_order(view: np.ndarray, out_ids: np.ndarray,
                             src: np.ndarray, in_ids: np.ndarray,
                             scale: np.ndarray) -> np.ndarray:
    """view [S, d] ⊎= scale[b] · src[clip(in_ids[b])] at out_ids as
    ``gather_mul_scatter`` sums it: each row's product rounded once
    (``__fmul_rn``), then ``scatter_dedup_order`` over tiles of
    ``tile_rows(d)``.  A new array."""
    rows = np.clip(in_ids, 0, src.shape[0] - 1)
    prod = src[rows].astype(np.float32) * scale.astype(np.float32)[:, None]
    return scatter_dedup_order(view, out_ids, prod)


def q_coords(m: int, d: int, head: int) -> np.ndarray:
    """[d, 2]: the (i, j) the ``fused_chain`` kernel steps to for each
    column of a row whose head (columns before its first 16-byte boundary)
    is ``head``, lane by lane and round by round as the kernel does: group
    g = lane + 32·round starts at column 0 (g = 0) or head + 4(g - 1); at
    a round's first column p = c - 1 - m is divided once a lane (its first
    Q column) and stepped by (128 // m, 128 % m) from round to round after
    that; within a group each column steps j + 1, carried into i at m, from
    (0, p) while p is negative.  Rows of columns with p < 0 read (0, p)."""
    out = np.zeros((d, 2), np.int64)
    groups = (d - head) // 4 + 2
    step_i, step_j = divmod(ROUND_COLS, m)
    for lane in range(32):
        have, fi, fj = False, 0, 0
        for g in range(lane, groups + 31 - (groups + 31) % 32, 32):
            c0 = 0 if g == 0 else head + 4 * (g - 1)
            n = 0 if g >= groups else (head if g == 0 else min(4, d - c0))
            p0 = c0 - 1 - m
            if p0 >= 0:
                if have:
                    fi, fj = fi + step_i, fj + step_j
                    if fj >= m:
                        fi, fj = fi + 1, fj - m
                else:
                    fi, fj, have = p0 // m, p0 % m, True
            i, j = (fi, fj) if p0 >= 0 else (0, p0)
            for t in range(4):
                if t < n:
                    out[c0 + t] = (i, j)
                j += 1
                if j == m:
                    i, j = i + 1, 0
    return out


def ring_mul_order(a: np.ndarray, b: np.ndarray, spec) -> np.ndarray:
    """a ⊗ b for rows [B, d] as the kernels compute each column: c = ca·cb;
    s = sa·cb + ca·sb; q = (qa·cb + ca·qb) + sa_i·sb_j + sb_i·sa_j at the
    (i, j) of ``q_coords``; columns past 1 + m + m² are 0."""
    if spec[0] == "scalar":
        return a * b
    m = spec[1]
    d = a.shape[-1]
    ca, cb = a[:, :1], b[:, :1]
    out = a * cb + ca * b  # the c and s columns, the first term of q
    out[:, 0] = a[:, 0] * b[:, 0]
    i, j = np.divmod(np.arange(min(d, 1 + m + m * m) - 1 - m), m)
    q = slice(1 + m, 1 + m + len(i))
    out[:, q] = (out[:, q] + a[:, 1 + i] * b[:, 1 + j]) + b[:, 1 + i] * a[:, 1 + j]
    out[:, 1 + m + m * m:] = 0.0
    return out


def chain_product_order(vals: np.ndarray, sources, spec) -> np.ndarray:
    """vals [B, d] ⊗ Π_i plane_i[clip(ids_i)], sources left to right
    (``fused_chain``'s ``prod``)."""
    out = vals.astype(np.float32)
    for plane, ids in sources:
        out = ring_mul_order(out, plane[np.clip(ids, 0, plane.shape[0] - 1)], spec)
    return out


def fused_apply_order(view: np.ndarray, out_ids: np.ndarray, vals: np.ndarray,
                      sources, spec):
    """(view, prod) as ``fused_chain`` computes them: the chain product, then
    ``scatter_dedup_order`` of it over tiles of ``tile_rows(d)``."""
    prod = chain_product_order(vals, sources, spec)
    return scatter_dedup_order(view, out_ids, prod), prod
