"""The matvec kernels' summation order in numpy float32: the TMA rows
kernel and the cols kernel.

``csrc/matvec.cu`` runs only on the card.  These functions repeat its
arithmetic, operation for operation, on the CPU: every product and sum is
one float32 rounding (the kernels use ``__fmul_rn`` and ``__fadd_rn``, no
contraction), taken in the kernel's order (for the rows kernel, over the
stages that ``rank1_chain.block_stages`` lists).  Used by
``tests/test_torch_matvec_hopper.py`` (against the plain version and the
JAX package) and ``tests/test_torch_cuda.py`` (bitwise against the kernel).
"""
import numpy as np

from repro_torch.kernels import rank1_chain


def _butterfly(v: np.ndarray) -> np.float32:
    """Lane 0 of the xor-shuffle reduction of 32 lanes (offsets 16 .. 1)."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def rows_order(A: np.ndarray, x: np.ndarray, plan) -> np.ndarray:
    """y = A x as the TMA rows kernel sums it: per stage of ``count`` rows of
    a chunk, S = 8 // count warps a row (1 from 8 rows on), warp segment g
    taking the float4s 32·(g + S·i) + lane; each lane four component sums,
    (x + y) + (z + w), a butterfly over the lanes, the segments in order,
    then the chunks in order."""
    rows, cols = A.shape
    y = np.zeros(rows, np.float32)
    warps = rank1_chain.WARPS
    for b in range(plan.blocks):
        for c, r, count, c0, w in rank1_chain.block_stages(plan, rows, cols, b):
            S = 1 if count >= warps else warps // count
            nf4 = w // 4
            steps = -(-nf4 // (32 * S))
            pad = np.zeros((count, steps * 32 * S, 4), np.float32)
            xpad = np.zeros((steps * 32 * S, 4), np.float32)
            pad[:, :nf4] = A[r:r + count, c0:c0 + w].reshape(count, nf4, 4)
            xpad[:nf4] = x[c0:c0 + w].reshape(nf4, 4)
            # [count, step, segment, lane, component]
            a5 = pad.reshape(count, steps, S, 32, 4)
            x5 = xpad.reshape(steps, S, 32, 4)
            acc = np.zeros((count, S, 32, 4), np.float32)
            for i in range(steps):
                acc = acc + a5[:, i] * x5[i]
            lanes = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
            for j in range(count):
                total = _butterfly(lanes[j, 0])
                for g in range(1, S):
                    total = total + _butterfly(lanes[j, g])
                y[r + j] = total if c == 0 else y[r + j] + total
    return y


def cols_order(A: np.ndarray, x: np.ndarray, plan) -> np.ndarray:
    """y = xᵀ A as the cols kernel sums it: split z of ``plan.chunk`` rows,
    warp w adding x[r]·A[r, :] over rows lo + w, lo + w + 8, ... in order;
    the warps' sums added in order into the split's partial; the splits'
    partials added in order."""
    rows, cols = A.shape
    warps = rank1_chain.WARPS
    y = None
    for z in range(plan.blocks):
        lo, hi = z * plan.chunk, min(rows, (z + 1) * plan.chunk)
        part = None
        for w in range(warps):
            acc = np.zeros(cols, np.float32)
            for r in range(lo + w, hi, warps):
                acc = acc + x[r] * A[r]
            part = acc if part is None else part + acc
        y = part if y is None else y + part
    return y


def matvec_order(A: np.ndarray, x: np.ndarray, transposed: bool, sms: int) -> np.ndarray:
    """The kernel's y for the row-major, 16-byte aligned ``A`` [rows, cols]
    (cols % 4 == 0 in the rows layout, the TMA kernel's) on a card of
    ``sms`` SMs: A x (rows layout) or xᵀ A (cols layout)."""
    rows, cols = A.shape
    plan = rank1_chain.matvec_plan(rows, cols, transposed, True, sms)
    assert plan.kernel == ("simt" if transposed else "tma"), plan
    A, x = A.astype(np.float32), x.astype(np.float32)
    return cols_order(A, x, plan) if transposed else rows_order(A, x, plan)
