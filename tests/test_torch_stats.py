"""The port's streaming statistics ≡ the reference's ``repro.data.stats``.

The scenario of ``tests/test_substrate.py::
test_running_cofactor_matches_numpy_and_supports_deletes`` (4 batches of 32
rows over m = 6 features, then the last batch deleted, then a ridge solve)
through ``RunningCofactor`` of both packages on the same numpy rows, the
port on the CPU.  Tolerances:

* integer-valued rows: the (c, s, Q) state is bitwise equal after every
  update (every sum is exact in float32);
* normal rows: the state is within the float32 summation bound of
  ``tests/test_torch_ops.py`` ((n + 2)·2⁻²³·Σ|terms|, n the rows so far);
* the derived statistics and the ridge solution are computed by both
  packages from the SAME state, carried across with ``convert``; they are
  float32 elementwise arithmetic and one small LU solve (LAPACK against
  XLA), held within 1e-6 of each result's largest magnitude, as
  ``tests/test_torch_engine_cofactor.py`` holds the regression solve.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.data import stats as rstats  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import stats  # noqa: E402

EPS = 2.0 ** -23
M = 6


def _batches(kind, seed=5, n=4, rows=32):
    rng = np.random.default_rng(seed)
    if kind == "ints":
        return [rng.integers(-4, 5, size=(rows, M)).astype(np.float32)
                for _ in range(n)]
    return [rng.standard_normal((rows, M)).astype(np.float32) for _ in range(n)]


def _ref_state(st):
    return tuple(np.asarray(t) for t in (st.c, st.s, st.Q))


def _assert_state(port, ref, kind, rows):
    got = convert.running_cofactor_to_numpy(port)
    want = _ref_state(ref)
    X = np.concatenate(rows).astype(np.float64)
    abs_sums = (np.float64(len(X)), np.abs(X).sum(0), np.abs(X).T @ np.abs(X))
    for g, r, a in zip(got, want, abs_sums):
        assert g.shape == r.shape and g.dtype == r.dtype
        if kind == "ints":
            np.testing.assert_array_equal(g, r)
        else:
            err = np.abs(g.astype(np.float64) - r)
            assert (err <= (len(X) + 2) * EPS * a).all()


def _assert_rel(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max(initial=0) <= rtol * np.abs(want).max(initial=0)


@pytest.mark.parametrize("kind", ["ints", "normal"])
def test_running_cofactor_stream_matches_reference(kind):
    batches = _batches(kind)
    ref = rstats.RunningCofactor.init(M)
    port = stats.RunningCofactor.init(M, device="cpu")
    for i, x in enumerate(batches):
        ref = ref.update(jnp.asarray(x))
        port = port.update(torch.tensor(x))
        _assert_state(port, ref, kind, batches[:i + 1])
    # delete the last batch: negative weights, the ring's additive inverse
    w = -np.ones(len(batches[-1]), np.float32)
    ref = ref.update(jnp.asarray(batches[-1]), weights=jnp.asarray(w))
    port = port.update(torch.tensor(batches[-1]), weights=torch.tensor(w))
    # the bound covers every row streamed, the deleted ones included
    _assert_state(port, ref, kind, batches)
    if kind == "ints":
        X = np.concatenate(batches[:-1])
        np.testing.assert_array_equal(port.Q.numpy(), X.T @ X)
        assert float(port.c) == len(X)


@pytest.mark.parametrize("kind", ["ints", "normal"])
def test_derived_statistics_and_ridge_match_reference(kind):
    """From one state (the reference's, carried across): mean, variance,
    covariance, correlation, normalizer, drift against the state after two
    batches, and the ridge solve."""
    batches = _batches(kind)
    ref = rstats.RunningCofactor.init(M)
    for x in batches[:2]:
        ref = ref.update(jnp.asarray(x))
    ref_base = ref
    for x in batches[2:]:
        ref = ref.update(jnp.asarray(x))
    ref = ref.update(jnp.asarray(batches[-1]),
                     weights=-jnp.ones(len(batches[-1]), jnp.float32))
    port = convert.running_cofactor_from_numpy(*_ref_state(ref), device="cpu")
    port_base = convert.running_cofactor_from_numpy(*_ref_state(ref_base),
                                                   device="cpu")
    for name in ("mean", "variance", "covariance", "correlation"):
        _assert_rel(getattr(port, name)().numpy(), getattr(ref, name)())
    for g, r in zip(port.normalizer(), ref.normalizer()):
        _assert_rel(g.numpy(), r)
    _assert_rel(port.drift_score(port_base).numpy(), ref.drift_score(ref_base))
    want = np.asarray(rstats.solve_ridge(ref, 0, [1, 2, 3], reg=1e-3))
    got = stats.solve_ridge(port, 0, [1, 2, 3], reg=1e-3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # and the solve is the normal equations of the rows kept
    X = np.concatenate(batches[:-1]).astype(np.float64)
    A = X[:, [1, 2, 3]]
    direct = np.linalg.solve(A.T @ A + 1e-3 * np.eye(3), A.T @ X[:, 0])
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)


def test_running_cofactor_state_round_trips_through_convert():
    rng = np.random.default_rng(3)
    c, s, Q = (np.float32(7.0), rng.standard_normal(M).astype(np.float32),
               rng.standard_normal((M, M)).astype(np.float32))
    st = convert.running_cofactor_from_numpy(np.array([c]), s, Q, device="cpu")
    assert st.c.shape == () and st.s.dtype == torch.float32
    for g, w in zip(convert.running_cofactor_to_numpy(st), (c, s, Q)):
        np.testing.assert_array_equal(g, w)


def test_running_cofactor_defaults_to_cuda():
    st = stats.RunningCofactor.init(M, device="cpu")
    assert st.Q.shape == (M, M) and st.c.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.RunningCofactor.init(M)
