"""The port's degree-m cofactor engine ≡ the reference's, bit for bit.

The retailer cofactor stream (m = 10, payload width 111) at
``RETAILER_DOMS``, built for both engines from the same numpy arrays and
compared on every materialized view after every update, for ``fivm`` and
``reeval``; then the normal-equations solve on the maintained statistics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from benchmarks import common as bc  # noqa: E402
from repro.core.apps import regression as ref_regression  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.data import synth  # noqa: E402


def _stream(seed=0, batch=32, n_batches=6):
    rng = np.random.default_rng(seed)
    rq = ref_regression.cofactor_query(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS)
    tq = regression.cofactor_query(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS)
    db = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng,
                     density=0.05)
    stream = bc.update_stream(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS,
                              rq.ring, rng, batch, n_batches)
    return rq, tq, db, stream


@pytest.mark.parametrize("strategy", ["fivm", "reeval"])
def test_retailer_cofactor_stream_matches_reference(strategy):
    rq, tq, db, stream = _stream()
    assert tq.ring.m == 10
    ref_eng, port_eng = P.run_parity(rq, tq, db, stream, bc.retailer_vo(),
                                     synth.retailer_vo(), strategy)
    if strategy != "fivm":
        return
    # the model solved on the maintained statistics
    ref_stats = ref_regression.stats_of_result(ref_eng.result())
    stats = regression.stats_of_result(port_eng.result())
    features = [0, 1, 2, 4, 5]
    want = np.asarray(ref_regression.solve_linear_model(ref_stats, 3, features))
    got = regression.solve_linear_model(stats, 3, features).numpy()
    # the statistics are bitwise equal (above); the two float32 LU solves
    # (XLA's and LAPACK's) round differently, so entries near zero differ
    # by more than 1e-6 of themselves: the bound is 1e-6 of θ's largest
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    g = regression.gradient(stats, torch.tensor(want)).numpy()
    g_ref = np.asarray(ref_regression.gradient(ref_stats, want))
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-6 * np.abs(g_ref).max())


def test_build_cofactor_engine_matches_reference():
    """build_cofactor_engine over the same multiplicity tables."""
    rng = np.random.default_rng(4)
    mult = {n: (rng.random(tuple(synth.RETAILER_DOMS[v] for v in sch))
                < 0.05).astype(np.float32)
            for n, sch in synth.RETAILER_RELATIONS.items()}
    eng = regression.build_cofactor_engine(
        synth.RETAILER_RELATIONS, synth.RETAILER_DOMS,
        {n: torch.tensor(m) for n, m in mult.items()},
        var_order=synth.retailer_vo(), storage="dense", device="cpu")
    ref_eng = ref_regression.build_cofactor_engine(
        bc.RETAILER_RELATIONS, bc.RETAILER_DOMS,
        {n: jnp.asarray(m) for n, m in mult.items()},
        var_order=bc.retailer_vo(), storage="dense")
    P.assert_views_equal(ref_eng, eng)
