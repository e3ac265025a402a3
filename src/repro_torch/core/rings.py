"""Rings for F-IVM payloads (PyTorch port of ``repro.core.rings``).

A relation maps keys to payloads drawn from a ring (D, +, *, 0, 1).  The key
computation (joins, marginalization, delta propagation) is ring-independent;
a different ring retargets the same view tree to a different task (Sec. 2 /
Sec. 7 of the paper).

Every ring product the paper uses is bilinear in the payload components;
``mul_terms`` spells that bilinearity out, so a join over dense
dictionary-encoded key tensors decomposes into one ``torch.einsum`` per term
(see contraction.py).  Payloads are dicts of tensors: each component has
shape ``[*key_dims, *payload_shape]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device

Payload = Any  # dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MulTerm:
    """One bilinear term of the ring product.

    out[comp_out][..., out_subs] += coef * a[comp_a][..., a_subs] * b[comp_b][..., b_subs]

    Subscripts refer to *payload* axes only (key axes are handled by the
    contraction engine).  Example (degree-m ring, Def. 7.2):
      Q_out += s_a s_b^T  ->  MulTerm("Q", "s", "s", "i", "j", "ij")
    """

    comp_out: str
    comp_a: str
    comp_b: str
    a_subs: str
    b_subs: str
    out_subs: str
    coef: float = 1.0


class Ring:
    """Base class.  Subclasses define components, identities, lift, mul."""

    name: str = "abstract"
    #: mapping component name -> payload shape (tuple of ints)
    components: Mapping[str, tuple] = {}
    #: bilinear expansion of * ; None means use generic `mul`
    mul_terms: Sequence[MulTerm] | None = None
    #: dtype for payload leaves
    dtype: torch.dtype = torch.float32
    commutative: bool = True

    # Two structurally identical rings built by separate calls (e.g.
    # sum_ring() in a query and in a database loader) compare equal.
    def _identity(self):
        return (
            type(self).__name__,
            self.name,
            str(self.dtype),
            tuple((k, tuple(shp)) for k, shp in self.components.items()),
        )

    def __eq__(self, other):
        return isinstance(other, Ring) and self._identity() == other._identity()

    def __hash__(self):
        return hash(self._identity())

    # -- construction ------------------------------------------------------
    def zeros(self, key_shape: Sequence[int] = (), device="cuda") -> Payload:
        dev = resolve_device(device)
        return {
            k: torch.zeros((*key_shape, *shp), dtype=self.dtype, device=dev)
            for k, shp in self.components.items()
        }

    def ones(self, key_shape: Sequence[int] = (), device="cuda") -> Payload:
        raise NotImplementedError

    # -- ring ops (componentwise add; mul may be overridden) ---------------
    def add(self, a: Payload, b: Payload) -> Payload:
        return {k: a[k] + b[k] for k in a}

    def mul(self, a: Payload, b: Payload) -> Payload:
        """Elementwise (over key dims, broadcasting) ring product."""
        if self.mul_terms is None:
            raise NotImplementedError
        out: dict[str, torch.Tensor] = {}
        for t in self.mul_terms:
            x, y = a[t.comp_a], b[t.comp_b]
            na, nb = len(t.a_subs), len(t.b_subs)
            kx = x.dim() - na
            ky = y.dim() - nb
            nk = max(kx, ky)
            # pad key dims to a common rank, then broadcast them
            x = x.reshape((1,) * (nk - kx) + tuple(x.shape))
            y = y.reshape((1,) * (nk - ky) + tuple(y.shape))
            key_letters = "".join(chr(ord("A") + i) for i in range(nk))
            spec = (f"{key_letters}{t.a_subs},{key_letters}{t.b_subs}"
                    f"->{key_letters}{t.out_subs}")
            kshape = tuple(max(x.shape[i], y.shape[i]) for i in range(nk))
            x = x.expand(kshape + tuple(x.shape[nk:]))
            y = y.expand(kshape + tuple(y.shape[nk:]))
            term = torch.einsum(spec, x, y)
            if t.coef != 1.0:
                term = term * t.coef
            out[t.comp_out] = out[t.comp_out] + term if t.comp_out in out else term
        # fill in components never produced (stay zero)
        any_k = next(iter(out))
        ref = out[any_k]
        key_shape = ref.shape[: ref.dim() - len(self.components[any_k])]
        for k, shp in self.components.items():
            if k not in out:
                out[k] = torch.zeros((*key_shape, *shp), dtype=self.dtype,
                                     device=ref.device)
        return out

    # -- lifting ------------------------------------------------------------
    def lift(self, values: torch.Tensor, var_index: int | None = None) -> Payload:
        """Lifting function g_X applied elementwise to a tensor of key values
        (the payload lives on ``values``' device)."""
        raise NotImplementedError

    # -- predicates ----------------------------------------------------------
    def is_zero(self, a: Payload, atol: float = 0.0) -> torch.Tensor:
        """Boolean tensor over key dims: True where payload == ring zero."""
        flags = None
        for k, shp in self.components.items():
            x = a[k]
            axes = tuple(range(x.dim() - len(shp), x.dim()))
            f = x.abs() <= atol
            if axes:
                f = f.all(dim=axes) if len(axes) > 1 else f.all(dim=axes[0])
            flags = f if flags is None else flags & f
        return flags

    def scale(self, a: Payload, factor: torch.Tensor) -> Payload:
        """Scalar (ℤ-module) scaling: every component times ``factor``,
        which has the key dims' shape and broadcasts over the payload
        axes."""
        out = {}
        for k, x in a.items():
            f = factor.to(x.dtype)
            out[k] = x * f.reshape(tuple(f.shape) + (1,) * (x.dim() - f.dim()))
        return out


# ---------------------------------------------------------------------------
# Scalar rings: ℤ and ℝ — COUNT / SUM aggregates.
# ---------------------------------------------------------------------------
class ScalarRing(Ring):
    components = {"v": ()}
    mul_terms = (MulTerm("v", "v", "v", "", "", ""),)

    def __init__(self, dtype=torch.float32, name="scalar"):
        self.dtype = dtype
        self.name = name

    def ones(self, key_shape=(), device="cuda"):
        return {"v": torch.ones(tuple(key_shape), dtype=self.dtype,
                                device=resolve_device(device))}

    def lift(self, values, var_index=None):
        """Default SUM lifting: g(x) = x (cast into the ring)."""
        return {"v": values.to(self.dtype)}

    def lift_one(self, values, var_index=None):
        """COUNT lifting: g(x) = 1."""
        return {"v": torch.ones(values.shape, dtype=self.dtype,
                                device=values.device)}


def count_ring(dtype=torch.int32) -> ScalarRing:
    r = ScalarRing(dtype=dtype, name="count")
    r.lift = r.lift_one  # type: ignore[method-assign]
    return r


def sum_ring(dtype=torch.float32) -> ScalarRing:
    return ScalarRing(dtype=dtype, name="sum")


# ---------------------------------------------------------------------------
# Degree-m matrix ring (Def. 7.2): payload (c, s, Q) — sufficient statistics
# for linear regression over joins.
# ---------------------------------------------------------------------------
class DegreeMRing(Ring):
    r"""(c, s, Q) triples:  c scalar count, s ∈ R^m, Q ∈ R^{m×m}.

    a * b = (c_a c_b,
             c_b s_a + c_a s_b,
             c_b Q_a + c_a Q_b + s_a s_b^T + s_b s_a^T)
    """

    commutative = True

    def __init__(self, m: int, dtype=torch.float32):
        self.m = m
        self.dtype = dtype
        self.name = f"degree{m}"
        self.components = {"c": (), "s": (m,), "Q": (m, m)}
        self.mul_terms = (
            MulTerm("c", "c", "c", "", "", ""),
            MulTerm("s", "s", "c", "i", "", "i"),
            MulTerm("s", "c", "s", "", "i", "i"),
            MulTerm("Q", "Q", "c", "ij", "", "ij"),
            MulTerm("Q", "c", "Q", "", "ij", "ij"),
            MulTerm("Q", "s", "s", "i", "j", "ij"),
            MulTerm("Q", "s", "s", "j", "i", "ij"),
        )

    def ones(self, key_shape=(), device="cuda"):
        dev = resolve_device(device)
        key_shape = tuple(key_shape)
        return {
            "c": torch.ones(key_shape, dtype=self.dtype, device=dev),
            "s": torch.zeros((*key_shape, self.m), dtype=self.dtype, device=dev),
            "Q": torch.zeros((*key_shape, self.m, self.m), dtype=self.dtype,
                             device=dev),
        }

    def lift(self, values, var_index: int | None = None):
        """g_j(x) = (1, e_j x, E_jj x^2) — Sec. 7.2."""
        if var_index is None:
            raise ValueError("degree-m lifting needs the variable index")
        x = values.to(self.dtype)
        key_shape = tuple(x.shape)
        c = torch.ones(key_shape, dtype=self.dtype, device=x.device)
        s = torch.zeros((*key_shape, self.m), dtype=self.dtype, device=x.device)
        s[..., var_index] = x
        Q = torch.zeros((*key_shape, self.m, self.m), dtype=self.dtype,
                        device=x.device)
        Q[..., var_index, var_index] = x * x
        return {"c": c, "s": s, "Q": Q}


# ---------------------------------------------------------------------------
# Host rings: exact payloads as Python / numpy values, for the host engine
# (``repro_torch.core.py_engine``) and the relational data ring of Sec. 7.3.
# ---------------------------------------------------------------------------
class PyRing:
    """Protocol for host-side rings operating on opaque python payloads."""

    name = "py-abstract"

    def zero(self):  # pragma: no cover - interface
        raise NotImplementedError

    def one(self):  # pragma: no cover - interface
        raise NotImplementedError

    def add(self, a, b):  # pragma: no cover - interface
        raise NotImplementedError

    def neg(self, a):  # pragma: no cover - interface
        raise NotImplementedError

    def mul(self, a, b):  # pragma: no cover - interface
        raise NotImplementedError

    def lift(self, value, var_index=None):  # pragma: no cover - interface
        raise NotImplementedError

    def is_zero(self, a) -> bool:
        return a == self.zero()


class PyNumberRing(PyRing):
    """ℤ / ℝ with numeric lifting (COUNT if count=True else SUM)."""

    def __init__(self, count=False):
        self.count = count
        self.name = "py-count" if count else "py-sum"

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return a + b

    def neg(self, a):
        return -a

    def mul(self, a, b):
        return a * b

    def lift(self, value, var_index=None):
        return 1 if self.count else value


class PyDegreeMRing(PyRing):
    """Exact numpy mirror of DegreeMRing."""

    def __init__(self, m: int):
        self.m = m
        self.name = f"py-degree{m}"

    def zero(self):
        return (0.0, np.zeros(self.m), np.zeros((self.m, self.m)))

    def one(self):
        return (1.0, np.zeros(self.m), np.zeros((self.m, self.m)))

    def add(self, a, b):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2])

    def neg(self, a):
        return (-a[0], -a[1], -a[2])

    def mul(self, a, b):
        ca, sa, Qa = a
        cb, sb, Qb = b
        return (
            ca * cb,
            cb * sa + ca * sb,
            cb * Qa + ca * Qb + np.outer(sa, sb) + np.outer(sb, sa),
        )

    def lift(self, value, var_index=None):
        if var_index is None:
            raise ValueError("degree-m lifting needs the variable index")
        s = np.zeros(self.m)
        s[var_index] = value
        Q = np.zeros((self.m, self.m))
        Q[var_index, var_index] = value * value
        return (1.0, s, Q)

    def is_zero(self, a):
        return a[0] == 0 and not a[1].any() and not a[2].any()


class PyRelationalRing(PyRing):
    """The relational data ring F[ℤ] (Def. 7.4).

    Payloads are relations over ℤ: dict mapping tuples -> int multiplicity.
    0 = {} (empty relation); 1 = {(): 1}.  + is union (⊎); * is join (⊗)
    implemented as concatenating Cartesian product of tuples with multiplied
    multiplicities.

    ``tagged=True`` activates the footnote-2 generalization needed for
    *incremental* maintenance: payload entries are (var, value) pairs and
    join canonicalizes by sorting on var, so delta payloads align with view
    payloads whatever the order in which joins are applied during
    propagation (evaluation joins children left-to-right; a delta joins its
    siblings around the propagation path, a different order).
    """

    def __init__(self, tagged: bool = False):
        self.tagged = tagged
        self.name = "py-relational" + ("-tagged" if tagged else "")

    def zero(self):
        return {}

    def one(self):
        return {(): 1}

    def add(self, a, b):
        out = dict(a)
        for t, mult in b.items():
            out[t] = out.get(t, 0) + mult
            if out[t] == 0:
                del out[t]
        return out

    def neg(self, a):
        return {t: -m for t, m in a.items()}

    def mul(self, a, b):
        out: dict[tuple, int] = {}
        for ta, ma in a.items():
            for tb, mb in b.items():
                t = ta + tb
                if self.tagged:
                    t = tuple(sorted(t, key=lambda p: p[0]))
                out[t] = out.get(t, 0) + ma * mb
                if out[t] == 0:
                    del out[t]
        return out

    def lift(self, value, var_index=None, free=True):
        return {(value,): 1} if free else {(): 1}

    def is_zero(self, a):
        return len(a) == 0
