"""The port's plan-driven sharding ≡ the reference's (``tests/test_shard.py``,
the 4-device cases of ``tests/test_serve.py`` and ``tests/test_recovery.py``).

* **In process** — ``collective_placement``, ``plan_shards`` specs and
  ``pretty()`` and the storage shard surface against the reference on the
  same numpy inputs, at one rank and (the port's bare-world-size form) at
  four.
* **Four ranks** — one JAX subprocess forces 4 host devices and runs every
  scenario of ``_torch_shard_child`` through the reference's
  ``shard_executor`` (``_torch_shard_ref.py``); beside it one 4-rank gloo
  group (processes of ``_torch_shard_child.py``, a ``file://`` rendezvous
  under ``tmp_path``) runs the same scenarios through the port's, checks
  the serving plane on a 4-rank sharded executor, then kills itself with
  SIGKILL mid-segment.  The port is held to the reference: bitwise on the
  integer streams (growth included), within 1e-6 relative on the float
  stream, the same plans at n = 4; the killed group's checkpoints resume on
  1 rank (here) and on 2 (a second group) to the reference's uninterrupted
  views, bitwise.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_shard_child as S  # noqa: E402
from repro.core import DenseRelation as RDense  # noqa: E402
from repro.core import IVMEngine as REngine  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import SparseRelation as RSparse  # noqa: E402
from repro.core import chain as rchain  # noqa: E402
from repro.core import make_mesh as ref_make_mesh  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import plan_shards as ref_plan_shards  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro_torch.core import (DenseRelation, SparseRelation, make_mesh,  # noqa: E402
                              plan_shards, shard_executor, sum_ring)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.relations import is_sharded  # noqa: E402
from repro_torch.checkpoint.stream_state import StreamCheckpointer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, HERE, env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _ranks(mode, world, init, out):
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_shard_child.py"), mode,
         str(r), str(world), init, out], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _finish(procs, timeout=300):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append((p.returncode, out))
    return outs


class _Runs:
    """The reference's 4-device dump and the port's 4-rank group, started
    together (the in-process tests run meanwhile); :meth:`get` waits for
    them, then resumes the killed group's checkpoints on 2 ranks."""

    def __init__(self, out):
        self.out = out
        flags = (os.environ.get("XLA_FLAGS", "")
                 + " --xla_force_host_platform_device_count=4").strip()
        self.ref = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_shard_ref.py"), out],
            env=_env(XLA_FLAGS=flags), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.group = _ranks("group", WORLD, os.path.join(out, "init4"), out)
        self.procs = [self.ref] + self.group
        self.result = None

    def get(self) -> dict:
        if self.result is not None:
            return self.result
        out = self.out
        group = _finish(self.group)
        # the second resume works on a copy of the killed group's snapshots
        ck, killed = os.path.join(out, "ck"), os.path.join(out, "ck_killed")
        shutil.copytree(ck, killed)
        resumed = _ranks("resume", 2, os.path.join(out, "init2"), out)
        self.procs += resumed
        resumed = _finish(resumed)
        shutil.rmtree(ck)
        shutil.copytree(killed, ck)
        ref_out, _ = self.ref.communicate(timeout=600)
        assert self.ref.returncode == 0, ref_out[-3000:]
        with open(os.path.join(out, "ref.json")) as f:
            ref_specs = json.load(f)
        port = port_views = None
        if os.path.exists(os.path.join(out, "port.json")):
            with open(os.path.join(out, "port.json")) as f:
                port = json.load(f)
            port_views = dict(np.load(os.path.join(out, "port.npz")))
        self.result = dict(dir=out, group=group, resumed=resumed,
                           ref_specs=ref_specs,
                           ref=dict(np.load(os.path.join(out, "ref.npz"))),
                           port=port, port_views=port_views)
        return self.result

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    started = _Runs(str(tmp_path_factory.mktemp("shard")))
    yield started
    started.close()


@pytest.fixture
def runs(_started):
    return _started.get()


def _group_ok(runs):
    assert runs["port"] is not None, runs["group"][0][1][-3000:]
    return runs["port"]


# ---------------------------------------------------------------------------
# in process: the placement pass, the specs, the storage surface
# ---------------------------------------------------------------------------
def _engines(kind="mixed"):
    """(reference engine, port engine) over the rounds scenario's database:
    ``mixed`` (sparse storage, one view forced dense) or ``sparse``."""
    db = S.scenario("rounds")[0]
    rq = RQuery(relations=dict(S.SCHEMAS), free_vars=("A", "C"), ring=rsum(),
                domains=S.DOMS, lifts=dict(S.LIFTS))
    rels = {n: RDense(S.SCHEMAS[n], rq.ring, {"v": jnp.asarray(a)})
            for n, a in db.items()}
    probe = REngine.build(rq, rels, var_order=rchain(*S.VO), storage="sparse")
    sparse = [n for n, s in probe.storage_plan.items() if s.kind == "sparse"]
    over = {min(sparse): "dense"} if kind == "mixed" else {}
    ref = REngine.build(rq, rels, var_order=rchain(*S.VO), storage="sparse",
                        storage_overrides=over)
    return ref, S.Port().engine(db, kind)


def test_collective_placement_classification():
    """The plan-time pass: written+gathered → all_gather, written-only →
    scatter, unshardable/read-only → replicate — the reference's
    placements for the same plans."""
    ref, eng = _engines("sparse")
    got = {}
    for pkg, e in ((rplan, ref), (tplan, eng)):
        plans = [e.plans.lookup_sig(e, rel, ("coo", tuple(e.query.relations[rel]), 1))
                 for rel in sorted(e.updatable)]
        write_union = set()
        for p in plans:
            write_union |= set(p.write_views)
        read_union = set(pkg.read_sets(plans))
        placement = pkg.collective_placement(plans, {n: True for n in e.views})
        for name, place in placement.items():
            if name.startswith(pkg.IND_PREFIX):
                continue
            if name not in write_union:
                assert place == "replicate", (name, place)
            elif name in read_union:
                assert place == "all_gather", (name, place)
            else:
                assert place == "scatter", (name, place)
        assert "all_gather" in placement.values()
        forced = pkg.collective_placement(plans, {n: False for n in e.views})
        assert set(forced.values()) == {"replicate"}
        got[pkg.__name__] = (placement, forced)
    assert got["repro_torch.core.plan"] == got["repro.core.plan"]


@pytest.mark.parametrize("n", [1, WORLD])
def test_plan_shards_specs_and_reasons(n, request):
    """Specs (name, kind, axis, collective, extent, reason) and ``pretty()``
    equal the reference's: at one rank against its one-device mesh, at
    four (the port's bare world size) against its forced 4-device mesh."""
    ref, eng = _engines()
    sp = plan_shards(eng, devices=n)
    if n == 1:
        rsp = ref_plan_shards(ref, devices=jax.devices()[:1])
        assert {k: tuple(dataclass_tuple(v)) for k, v in sp.specs.items()} == \
            {k: tuple(dataclass_tuple(v)) for k, v in rsp.specs.items()}
        want = rsp.pretty()
    else:
        want = request.getfixturevalue("runs")["ref_specs"]["rounds"]
    assert sp.pretty() == want
    assert sp.n_devices == n and sp.pretty().startswith(f"mesh[view={n}]")
    for name, v in eng.views.items():
        spec = sp.specs[name]
        if spec.kind == "shard":
            assert spec.extent % n == 0
            if isinstance(v, SparseRelation):
                assert spec.axis == "slot" and spec.extent == v.capacity
            else:
                assert spec.axis == "lead" and spec.extent == v.domains[0]
            assert spec.collective in ("scatter", "all_gather")
        else:
            assert spec.collective is None and spec.extent == 0
    # a placement per leaf of the state: the same structure
    shardings = sp.state_shardings(eng.state)
    assert len(torch.utils._pytree.tree_leaves(shardings)) == len(
        torch.utils._pytree.tree_leaves(eng.state))


def dataclass_tuple(spec):
    return (spec.name, spec.kind, spec.axis, spec.collective, spec.extent,
            spec.reason)


def test_storage_shard_surface():
    """The shard surface of both backends, as the reference's (the sparse
    table's key leaf replicates on purpose: linear probing crosses slot
    ranges)."""
    mesh, rmesh = make_mesh(), ref_make_mesh(jax.devices()[:1])
    ring, rring = sum_ring(), rsum()
    dense = DenseRelation.zeros(("A", "B"), ring, (8, 4), device="cpu")
    sparse = SparseRelation.zeros(("A",), ring, (64,), capacity=16, device="cpu")
    scalar = DenseRelation.zeros((), ring, (), device="cpu")
    rdense = RDense.zeros(("A", "B"), rring, (8, 4))
    rsparse = RSparse.zeros(("A",), rring, (64,), capacity=16)
    rscalar = RDense.zeros((), rring, ())
    for t, r in ((dense, rdense), (sparse, rsparse), (scalar, rscalar)):
        assert (t.shard_axis(), t.shard_extent()) == (r.shard_axis(),
                                                      r.shard_extent())
    assert dense.shard_axis() == 0 and dense.shard_extent() == 8
    assert sparse.shard_axis() == 0 and sparse.shard_extent() == 16
    assert scalar.shard_axis() is None and scalar.shard_extent() == 0
    for (t, r), shard in (((dense, rdense), True), ((sparse, rsparse), True),
                          ((dense, rdense), False), ((scalar, rscalar), True)):
        got = torch.utils._pytree.tree_leaves(t.leaf_shardings(mesh, "view", shard))
        want = jax.tree.leaves(r.leaf_shardings(rmesh, "view", shard))
        assert len(got) == len(want) == len(torch.utils._pytree.tree_leaves(t))
        split = [p.kind == "split" and p.axis == "view" for p in got]
        ref_split = ["view" in tuple(s.spec) for s in want]
        if isinstance(t, SparseRelation):
            # the table leaf (first) stays whole; the payload rows split
            assert split == [False] + ref_split[1:]
        else:
            assert split == ref_split


# ---------------------------------------------------------------------------
# four ranks against four devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(S.SCHEDULES))
def test_sharded_matches_single_device(mode, runs):
    """Scan, rounds and switch dispatch over 4 ranks: bitwise to the
    reference's 4-device run (integer-valued payloads), with the same
    shard plan."""
    port = _group_ok(runs)
    assert port["specs"][mode] == runs["ref_specs"][mode]
    assert port["sharded"][mode], "nothing sharded on 4 ranks"
    np.testing.assert_array_equal(runs["port_views"][mode], runs["ref"][mode])


def test_sharded_float_payloads_within_tolerance(runs):
    """Non-integer float payloads: within 1e-6 relative of the reference,
    the acceptance bound of its sharded tests."""
    _group_ok(runs)
    np.testing.assert_allclose(runs["port_views"]["float"], runs["ref"]["float"],
                               rtol=1e-6, atol=1e-6)


def test_sharded_segmented_stream_grows_and_matches(runs):
    """Capacity segmentation under a shard plan: bitwise to the reference."""
    port = _group_ok(runs)
    assert port["specs"]["grow"] == runs["ref_specs"]["grow"]
    np.testing.assert_array_equal(runs["port_views"]["grow"], runs["ref"]["grow"])


def test_sharded_views_hold_one_slice_per_rank(runs):
    """Each rank holds 1/4 of every sharded view's payload rows, and a
    gloo group's executor says it runs the eager program."""
    port = _group_ok(runs)
    for name, views in port["local_rows"].items():
        assert set(views) == set(port["sharded"][name])
        for local, total in views.values():
            assert local * WORLD == total
    assert port["program"] == "eager"
    assert set(port["collectives"]) >= {"read", "gather", "broadcast"}
    assert {v["backend"] for v in port["collectives"].values()} == {"gloo"}


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_four_rank_pinned_reads_match_offline_recompute(storage, runs):
    """A 4-rank sharded executor behind a ``ViewServer`` publishes
    generations whose pinned views and lookups equal offline recomputation
    at each generation's offset (checked in every rank)."""
    report = _group_ok(runs)["serve"][storage]
    assert report["generations"] >= 4 and report["reads"] > 0
    assert report["sharded"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_kill9_mid_segment_then_mesh_elastic_resume(ranks, runs):
    """The 4-rank group is SIGKILLed mid-segment; its checkpoints resume on
    another rank count and converge to the reference's uninterrupted run,
    bitwise."""
    _group_ok(runs)
    # rank 0 dies by SIGKILL; a peer by SIGKILL or by the collective its
    # killed peers broke
    codes = [code for code, _ in runs["group"]]
    assert codes[0] == -9, runs["group"][0][1][-3000:]
    assert all(c != 0 for c in codes), codes
    want = runs["ref"]["chaos"]
    if ranks == 2:
        for code, out in runs["resumed"]:
            assert code == 0, out[-3000:]
        got = np.load(os.path.join(runs["dir"], "resume2.npz"))
        assert list(got["sharded"])
        np.testing.assert_array_equal(got["root"], want)
        return
    ckdir = os.path.join(runs["dir"], "ck")
    ck = StreamCheckpointer(ckdir, segment_updates=2)
    steps = ck.ckpt.all_steps()
    assert steps[:2] == [0, 2] and set(steps) <= {0, 2, 4}, steps
    port = S.Port()
    eng = port.chaos_engine("sparse")
    ex = shard_executor(eng, checkpoint=ck)
    assert ex.shard.n_devices == 1
    ex.resume(port.chaos_stream())
    assert not any(is_sharded(v) for v in eng.views.values())
    np.testing.assert_array_equal(port.result(eng, order=("A",)), want)


@pytest.mark.parametrize("check", ["triangle_fivm_indicators",
                                   "triangle_dbt_indicators",
                                   "chain_factorized", "audit_repair"])
def test_sharded_paths_beyond_the_reference_suite(check, runs):
    """Paths the reference's sharding tests do not take, on 4 ranks and held
    to the port's unsharded engine bitwise (which its own suites hold to
    the reference): indicator projections under ``fivm`` and ``dbt``,
    factorized updates through ``apply_update`` on a sharded state, and an
    audited stream whose sharded root drifts, then is repaired in place."""
    same, detail = _group_ok(runs)["port_only"][check]
    assert same, check
    assert detail, (check, detail)  # something sharded; the repair in place
