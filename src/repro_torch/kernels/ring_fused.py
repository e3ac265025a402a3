"""Runtime of fused trigger chains on the card (PyTorch port of
``repro.kernels.ring_fused``).

The plan-level fusion pass (``repro_torch.core.plan.fuse_trigger_ops``)
collapses an eligible Gather→Lift→(Marginalize)→Emit→ScatterAccum run of a
trigger plan into one ``FusedChain`` op whose runtime is this module:

    view ⊎_{out_ids}  vals ⊗ Π_i plane_i[ids_i]

over flat ``[S, d]`` payload planes.  Every gather source (sibling-view
planes and lift relations alike) is a ``(plane [Sg, d], ids [B])`` pair,
the scalar or degree-m ring product is one flat formula
(:func:`ring_mul_flat`), and on a CUDA tensor the whole chain is one launch
of ``csrc/fused_chain.cu`` (gather, product, in-tile dedup and atomic ⊎).
A CPU tensor takes the plain version (:func:`fused_apply_ref`: clamped
gather, ``ring_mul_flat`` per source, plain scatter).

Legality is decided at plan time against an H100 model of the kernel's
block (:func:`chain_smem_bytes` <= :data:`SMEM_PER_BLOCK`, at most
:data:`MAX_SOURCES` sources).  The TPU bounds (``VMEM_BUDGET``,
``MAX_FUSED_PLANE``) held whole source planes in VMEM; the CUDA kernel
reads source rows from device memory, so source rows are not bounded.
"""
from __future__ import annotations

import math

import torch

from . import scatter_ops
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle
from .ref import scatter_add_ref
from .ring_scatter import tile_rows

#: shared memory one block may take on an H100 (227 KB, opted into above
#: the default 48 KB)
SMEM_PER_BLOCK = 232_448

#: (plane, ids) pairs the kernel's argument struct takes; a chain with more
#: sources stays unfused at plan time
MAX_SOURCES = 4

#: warps of one ``fused_chain`` block at widths above 1 (kWarps)
CHAIN_WARPS = 8

FUSED_CHAIN = CudaKernel(
    "fused_chain.cu", "repro_fused_chain",
    [PTR, PTR, PTR, PTR, I64, I32, I64, I32, I32]
    + [PTR] * (2 * MAX_SOURCES) + [I64] * MAX_SOURCES + [I32])


# ---------------------------------------------------------------------------
# Ring spec: which payload algebras the flat formula covers
# ---------------------------------------------------------------------------
def fused_ring_spec(ring):
    """Flat-payload descriptor of ``ring``, or None when the ring is outside
    the fused algebra: ``("scalar",)`` for single-scalar-component rings,
    ``("degree", m)`` for the (c, s, Q) cofactor ring.  Requires a
    commutative bilinear float32 ring: gathered factors reorder past later
    lift multiplies (so non-commutative rings never fuse), and int rings
    keep the exact plain ⊎."""
    if ring.mul_terms is None or not ring.commutative:
        return None
    if ring.dtype != torch.float32:
        return None
    comps = ring.components
    shapes = list(comps.values())
    if len(comps) == 1 and shapes[0] == ():
        return ("scalar",)
    m = getattr(ring, "m", None)
    if (m and list(comps.keys()) == ["c", "s", "Q"]
            and shapes == [(), (m,), (m, m)]):
        return ("degree", int(m))
    return None


def spec_width(spec) -> int:
    """Payload plane width d of a fused ring spec."""
    if spec[0] == "scalar":
        return 1
    m = spec[1]
    return 1 + m + m * m


def ring_mul_flat(a: torch.Tensor, b: torch.Tensor, spec) -> torch.Tensor:
    """Ring product on flat ``[..., d]`` payload planes.

    For the degree-m ring the (c, s, Q) triple lives in one
    ``d = 1 + m + m²`` plane (c at column 0, s next, Q row-major) and the
    product is

        c = ca·cb
        s = sa·cb + ca·sb
        q = qa·cb + ca·qb, then + outer(sa, sb), then + outer(sb, sa)

    term by term in that order (each a separate rounded operation, as the
    CUDA kernel computes it), so integer-valued float32 payloads multiply
    bit-identically to ``Ring.mul``.  Trailing padding columns (inputs
    wider than d) stay zero."""
    if spec[0] == "scalar":
        return a * b
    m = spec[1]
    d = 1 + m + m * m
    ca, sa, qa = a[..., :1], a[..., 1:1 + m], a[..., 1 + m:d]
    cb, sb, qb = b[..., :1], b[..., 1:1 + m], b[..., 1 + m:d]
    c = ca * cb
    s = sa * cb + ca * sb
    lead = sa.shape[:-1]
    # Q row i is sa_i·sb (resp. sb_i·sa), row-major
    outer_ab = (sa[..., :, None] * sb[..., None, :]).reshape(*lead, m * m)
    outer_ba = (sb[..., :, None] * sa[..., None, :]).reshape(*lead, m * m)
    q = qa * cb + ca * qb
    q = q + outer_ab
    q = q + outer_ba
    out = torch.cat([c, s, q], dim=-1)
    if a.shape[-1] > d:  # padded feature plane: keep the zero columns
        out = torch.cat([out, out.new_zeros((*lead, a.shape[-1] - d))], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Plan-time H100 model
# ---------------------------------------------------------------------------
def ring_degree(width: int) -> int:
    """The degree m of a degree-m ring payload of ``width`` = 1 + m + m²
    columns; 0 for any other width (the scalar ring's 1)."""
    m = (math.isqrt(4 * int(width) - 3) - 1) // 2 if width >= 3 else 0
    return m if 1 + m + m * m == width else 0


def chain_smem_bytes(width: int) -> int:
    """Shared memory (bytes) of one ``fused_chain`` block at payload width
    ``width``, exactly what the kernel's launch requests: none at width 1
    (a thread a row, the dedup by shuffles); otherwise the tile of grouped
    rows' products (``tile_rows · width`` floats) and, for the degree-m
    ring, each of the block's :data:`CHAIN_WARPS` warps' (c, s) slots of
    both factors of every source (2 · :data:`MAX_SOURCES` · (m + 1)
    floats).  Deterministic in the width; a chain fuses only while it is at
    most :data:`SMEM_PER_BLOCK` (up to degree 80, width 6481)."""
    width = int(width)
    if width <= 1:
        return 0
    m = ring_degree(width)
    slots = CHAIN_WARPS * 2 * MAX_SOURCES * (m + 1) if m else 0
    return 4 * (tile_rows(width) * width + slots)


# ---------------------------------------------------------------------------
# The chain: plain version and kernel
# ---------------------------------------------------------------------------
def _take_clip(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return plane.index_select(0, ids.clamp(0, plane.shape[0] - 1).long())


def chain_product(vals: torch.Tensor, sources, spec) -> torch.Tensor:
    """``vals ⊗ Π_i plane_i[clamp(ids_i)]``, the per-row product ``[B, d]``
    of a chain (plain PyTorch)."""
    cur = vals
    for plane, ids in sources:
        cur = ring_mul_flat(cur, _take_clip(plane, ids), spec)
    return cur


def fused_apply_ref(view_plane, out_ids, vals, sources, spec,
                    product_out=None) -> torch.Tensor:
    """Plain version of :func:`fused_apply` (the reference's ``fused_xla``
    lowering): clamped gather, ``ring_mul_flat`` per source, scatter with
    out_ids < 0 or >= S dropped.  In place; returns ``view_plane``."""
    cur = chain_product(vals, sources, spec)
    if product_out is not None:
        product_out.copy_(cur)
    return scatter_add_ref(view_plane, out_ids, cur)


def resolve_backend(hint: str | None, device) -> str:
    """Lowering of a fused chain: ``fused_cuda`` (the kernel) for a CUDA
    tensor, ``fused_torch`` (the plain version) for a CPU tensor or where
    the ⊎ backend is forced to ``torch`` (the plan's ScatterAccum hint or
    ``REPRO_TORCH_SCATTER_BACKEND=torch``)."""
    kind = device.type if isinstance(device, torch.device) else torch.device(device).type
    if kind != "cuda":
        return "fused_torch"
    if (hint or scatter_ops.active_override()) == "torch":
        return "fused_torch"
    return "fused_cuda"


_NO_SOURCES = (None,) * MAX_SOURCES
_NO_ROWS = (0,) * MAX_SOURCES


def fused_apply(view_plane: torch.Tensor, out_ids: torch.Tensor,
                vals: torch.Tensor, sources, spec, *,
                backend: str | None = None,
                product_out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused chain over flat planes, in place:

        view_plane [S, d] ⊎_{out_ids} (vals [B, d] ⊗ Π_i plane_i[ids_i])

    ``sources`` is a sequence of at most :data:`MAX_SOURCES` ``(plane
    [Sg, d], ids [B])`` pairs, applied left to right; ids clamp into
    [0, Sg - 1].  ``out_ids`` < 0 or >= S drop.  ``product_out`` ([B, d]),
    when given, receives the per-row product.  ``backend`` is the plan's
    ⊎ hint (:func:`resolve_backend`).  Returns ``view_plane``."""
    S, d = view_plane.shape
    B = out_ids.shape[0]
    dev = view_plane.device
    n = len(sources)
    if n > MAX_SOURCES:
        raise ValueError(f"{n} sources; the kernel takes at most {MAX_SOURCES}")
    check_tensor("view_plane", view_plane, torch.float32, (S, d), dev)
    check_tensor("out_ids", out_ids, torch.int32, (B,), dev)
    check_tensor("vals", vals, torch.float32, (B, d), dev)
    for i, (plane, ids) in enumerate(sources):
        rows = plane.shape[0]
        if rows == 0 and B:
            raise ValueError(f"gather source {i} has no rows")
        check_tensor("plane", plane, torch.float32, (rows, d), dev, index=i)
        check_tensor("ids", ids, torch.int32, (B,), dev, index=i)
    if product_out is not None:
        check_tensor("product_out", product_out, torch.float32, (B, d), dev)
    if not on_card(view_plane) or resolve_backend(backend, dev) == "fused_torch":
        return fused_apply_ref(view_plane, out_ids, vals, sources, spec,
                               product_out)
    if spec_width(spec) > d:
        raise ValueError(f"ring spec {spec} is wider than the plane ({d})")
    if B * d == 0:
        return view_plane
    FUSED_CHAIN.launch(
        view_plane.data_ptr(), out_ids.data_ptr(), vals.data_ptr(),
        None if product_out is None else product_out.data_ptr(),
        S, d, B, 0 if spec[0] == "scalar" else int(spec[1]), n,
        *[p.data_ptr() for p, _ in sources], *_NO_SOURCES[n:],
        *[i.data_ptr() for _, i in sources], *_NO_SOURCES[n:],
        *[p.shape[0] for p, _ in sources], *_NO_ROWS[n:],
        tile_rows(d), stream_handle(view_plane))
    return view_plane
