"""The JAX reference's side of ``test_torch_shard.py``, run in a subprocess
that forces 4 host devices::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_shard_ref.py OUT_DIR

It runs every scenario of ``_torch_shard_child`` through the reference's
``shard_executor`` and writes the result views (``ref.npz``) and the shard
plans' ``pretty()`` forms (``ref.json``), plus the chaos stream's
uninterrupted result (the kill -9 test's target).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
import _torch_shard_child as S  # noqa: E402

from repro.core import (COOUpdate, DenseRelation, IVMEngine, Query,  # noqa: E402
                        StreamExecutor, chain, plan_shards, shard_executor,
                        sum_ring)


def engine(db, kind):
    q = Query(relations=dict(S.SCHEMAS), free_vars=("A", "C"), ring=sum_ring(),
              domains=S.DOMS, lifts=dict(S.LIFTS))
    rels = {n: DenseRelation(S.SCHEMAS[n], q.ring, {"v": jnp.asarray(a)})
            for n, a in db.items()}
    vo = chain(*S.VO)
    if kind == "grow":
        return IVMEngine.build(q, rels, var_order=vo, storage="sparse",
                               storage_opts=dict(min_capacity=16))
    probe = IVMEngine.build(q, rels, var_order=vo, storage="sparse")
    sparse = [n for n, s in probe.storage_plan.items() if s.kind == "sparse"]
    return IVMEngine.build(q, rels, var_order=vo, storage="sparse",
                           storage_overrides={min(sparse): "dense"})


def stream(items, schemas=S.SCHEMAS):
    return [(r, COOUpdate(schemas[r], jnp.asarray(k), {"v": jnp.asarray(v)}))
            for r, k, v in items]


def main(out_dir):
    assert len(jax.devices()) == 4, jax.devices()
    arrays, specs = {}, {}
    for name in S.SCENARIOS:
        db, items, kind = S.scenario(name)
        eng = engine(db, kind)
        ex = shard_executor(eng)
        specs[name] = ex.shard.pretty()
        ex.run(stream(items))
        arrays[name] = np.asarray(
            eng.result().transpose(("A", "C")).payload["v"])
    specs["plan_n1"] = plan_shards(engine(*S.scenario("rounds")[::2]),
                                   devices=jax.devices()[:1]).pretty()
    cq = Query(relations=dict(S.CH_SCHEMAS), free_vars=("A",),
               ring=sum_ring(), domains=S.CH_DOMS, lifts={"C": ("value",)})
    rels = {n: DenseRelation(S.CH_SCHEMAS[n], cq.ring, {"v": jnp.asarray(a)})
            for n, a in S.chaos_db().items()}
    eng = IVMEngine.build(cq, rels, var_order=chain(["A", "B"], {"B": [["C"]]}),
                          storage="sparse")
    StreamExecutor(eng).run(stream(S.chaos_stream(), S.CH_SCHEMAS))
    arrays["chaos"] = np.asarray(eng.result().payload["v"])
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(specs, f)


if __name__ == "__main__":
    main(sys.argv[1])
