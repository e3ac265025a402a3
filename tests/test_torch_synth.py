"""The port's synthetic data ≡ ``benchmarks/common.py``'s for one seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402  (also puts the repository root on sys.path)

_torch_parity.cap_torch_threads()
pytest.importorskip("jax")

from benchmarks import common as bc  # noqa: E402
from repro.core import DegreeMRing as RefDegreeMRing  # noqa: E402
from repro.core import sum_ring as ref_sum_ring  # noqa: E402
from repro_torch.core import DegreeMRing, sum_ring  # noqa: E402
from repro_torch.data import synth  # noqa: E402

SCHEMAS = {
    "retailer": (bc.RETAILER_RELATIONS, synth.RETAILER_RELATIONS,
                 bc.RETAILER_DOMS, synth.RETAILER_DOMS),
    "housing": (bc.HOUSING_RELATIONS, synth.HOUSING_RELATIONS,
                dict(bc.HOUSING_DOMS, pc=64), dict(synth.HOUSING_DOMS, pc=64)),
}


def test_schema_copies_match():
    assert synth.RETAILER_RELATIONS == bc.RETAILER_RELATIONS
    assert synth.RETAILER_DOMS == bc.RETAILER_DOMS
    assert synth.RETAILER_DOMS_BIG == bc.RETAILER_DOMS_BIG
    assert synth.HOUSING_RELATIONS == bc.HOUSING_RELATIONS
    assert synth.HOUSING_DOMS == bc.HOUSING_DOMS
    for ours, theirs in ((synth.retailer_vo(), bc.retailer_vo()),
                         (synth.housing_vo(), bc.housing_vo())):
        assert ours.parent_map() == theirs.parent_map()


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("ring", ["sum", "degree"])
def test_synth_db_and_stream_match(schema, ring):
    ref_rels, rels, ref_doms, doms = SCHEMAS[schema]
    m = len({v for sch in rels.values() for v in sch})
    ref_ring, port_ring = ((ref_sum_ring(), sum_ring()) if ring == "sum"
                           else (RefDegreeMRing(m), DegreeMRing(m)))
    r_rng, t_rng = np.random.default_rng(11), np.random.default_rng(11)
    ref_db = bc.synth_db(ref_rels, ref_doms, ref_ring, r_rng, density=0.2)
    db = synth.synth_db(rels, doms, port_ring, t_rng, density=0.2, device="cpu")
    ref_stream = bc.update_stream(ref_rels, ref_doms, ref_ring, r_rng, 16, 7)
    stream = synth.update_stream(rels, doms, port_ring, t_rng, 16, 7,
                                 device="cpu")
    assert list(db) == list(ref_db)
    for name, rel in db.items():
        assert rel.schema == ref_db[name].schema
        for c, v in rel.payload.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref_db[name].payload[c]))
    assert [r for r, _ in stream] == [r for r, _ in ref_stream]
    for (_, upd), (_, ref_upd) in zip(stream, ref_stream):
        assert upd.keys.dtype == torch.int32
        np.testing.assert_array_equal(upd.keys.numpy(), np.asarray(ref_upd.keys))
        for c, v in upd.payload.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref_upd.payload[c]))
