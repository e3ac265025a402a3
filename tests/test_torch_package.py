"""Package rules of the PyTorch port.

* No module of ``repro_torch``, nor ``chip_smoke.py`` and the port's tools
  (``tools/lint_hotpath_torch.py``, ``tools/verify_plans_torch.py``),
  imports ``jax`` or the JAX package ``repro`` (checked statically with
  ``ast``).
* Entry points default to ``device="cuda"`` and raise on a host without
  CUDA unless the caller passes ``device="cpu"``.
* What the slice does not port yet raises ``NotImplementedError`` (the
  encoder-decoder and front-end LM families); sparse storage, indicators, factorized updates,
  sharding and the training loss, ported since, run against the reference
  instead.
* On a CUDA host the kernel toolchain (``nvcc``) is present: the test fails,
  not skips, where it is missing.
"""
import ast
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()

from repro_torch.core import IVMEngine, Query, sum_ring  # noqa: E402
from repro_torch.core import plan, storage  # noqa: E402
from repro_torch.data import synth  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "lint_hotpath_torch.py",
    ROOT / "tools" / "verify_plans_torch.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_never_imports_jax_or_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"ivm.py", "plan.py", "stream.py", "scatter_ops.py", "ops.py",
            "stats.py", "lm.py", "attention.py", "serve_lm.py", "faults.py",
            "integrity.py", "fault_tolerance.py", "checkpointer.py",
            "stream_state.py", "registry.py", "lookup.py", "server.py",
            "verifier.py", "chip_smoke.py", "lint_hotpath_torch.py",
            "verify_plans_torch.py", "optimizers.py", "schedules.py", "train.py",
            "mesh.py", "compression.py", "lm_data.py", "train_lm.py"} <= names


def _small_engine(**kw):
    doms = synth.RETAILER_DOMS
    q = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=doms, lifts={"units": ("value",)})
    db = synth.synth_db(synth.RETAILER_RELATIONS, doms, q.ring,
                        np.random.default_rng(0), device="cpu")
    return IVMEngine.build(q, db, var_order=synth.retailer_vo(), **kw), q, db


def test_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device works")
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth.synth_db(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS,
                       sum_ring(), rng)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sum_ring().zeros((3,))
    _, q, db = _small_engine(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVMEngine.build(q, db, var_order=synth.retailer_vo())


@pytest.mark.parametrize("reduced", [False, True])
def test_seamless_builds_and_its_batches_carry_frames(reduced):
    """seamless-m4t-large-v2 (the encoder-decoder) builds, full and reduced;
    the reduced config's batches (``lm_data``, ``real_batch``) carry
    ``frames`` [B, n_frontend_tokens, d_model] beside the tokens."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.models import registry

    cfg = get_config("seamless_m4t_large_v2")
    cfg = cfg.reduced() if reduced else cfg
    api = registry.build(cfg)
    assert cfg.enc_dec and set(api.specs) >= {"enc_layers", "dec_layers", "frame_proj"}
    assert api.n_params() == (242_432 if reduced else 2_036_459_520)
    if not reduced:
        return
    shape = ShapeSpec("t", 12, 4, "train")
    for batch in (lm_data._batch_for_step(cfg, shape, 0, 0, "cpu"),
                  registry.real_batch(cfg, shape, torch.Generator().manual_seed(0))):
        assert set(batch) == {"tokens", "labels", "frames"}
        assert tuple(batch["frames"].shape) == (4, cfg.n_frontend_tokens, cfg.d_model)
        assert batch["frames"].dtype == torch.float32
    loss, _ = api.loss(api.init(seed=0, device="cpu"),
                       lm_data._batch_for_step(cfg, shape, 0, 0, "cpu"))
    assert bool(torch.isfinite(loss))


def test_lm_loss_is_not_ported():
    """Ported since: ``ModelAPI.loss`` is ``lm_loss``, which equals the
    reference's on the same parameters and batch (labels < 0 masked)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as ref_config
    from repro.models import registry as rregistry
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    cfg = get_config("llama3_2_1b").reduced()
    api = registry.build(cfg)
    tree = jax.tree.map(np.asarray, rregistry.build(ref_config("llama3_2_1b").reduced()).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
             "labels": rng.integers(-1, cfg.vocab_size, (2, 8)).astype(np.int32)}
    loss, metrics = api.loss(convert.tree_from_numpy(tree, device="cpu"), batch)
    want, want_metrics = rregistry.build(ref_config("llama3_2_1b").reduced()).loss(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(metrics["tokens"]) == float(want_metrics["tokens"])


def test_server_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device works")
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry
    from repro_torch.serve_lm import Server

    cfg = get_config("llama3_2_1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build(cfg).init(seed=0)
    assert Server(cfg, device="cpu").device.type == "cpu"


def _sparse_inputs(what):
    """(reference query, numpy database, stream, storage keywords) for a case
    of sparse storage, which is ported now: ``auto`` (the default, dense at
    these domains), ``sparse``, a per-view ``sparse`` override, and
    ``sparse`` under plan fusion."""
    from benchmarks import common as bc
    from repro.core import Query as RQuery
    from repro.core import sum_ring as rsum

    rq = RQuery(relations=bc.RETAILER_RELATIONS, free_vars=(), ring=rsum(),
                domains=bc.RETAILER_DOMS, lifts={"units": ("value",)})
    rng = np.random.default_rng(0)
    rdb = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng,
                      density=0.02)
    stream = bc.update_stream(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring,
                              rng, 8, 5)
    dense, _, _ = _small_engine(device="cpu", storage="dense")
    keyed = sorted(n for n, v in dense.views.items() if v.schema)[0]
    kw = {"auto": {}, "sparse": dict(storage="sparse"),
          "fusion": dict(storage="sparse"),
          "sparse_override": dict(storage="dense",
                                  storage_overrides={keyed: "sparse"})}[what]
    return rq, rdb, stream, kw


@functools.lru_cache(maxsize=None)
def _reference_run(what):
    """The reference engine's storage plan and result after the case's
    stream; computed once a storage setting (the ``fusion`` case shares
    ``sparse``'s: the port's plan fusion does not reach the reference)."""
    if what == "fusion":
        return _reference_run("sparse")
    from benchmarks import common as bc
    from repro.core import IVMEngine as RefEngine

    rq, rdb, stream, kw = _sparse_inputs(what)
    ref = RefEngine.build(rq, rdb, var_order=bc.retailer_vo(), **kw)
    storage_plan = {n: (s.kind, s.capacity) for n, s in ref.storage_plan.items()}
    for rel, upd in stream:
        ref.apply_update(rel, upd)
    return storage_plan, np.asarray(ref.result().payload["v"])


def _sparse_case(what):
    """(port engine, stream) for a case of :func:`_sparse_inputs`."""
    import _torch_parity as P
    from repro_torch import convert

    _, rdb, stream, kw = _sparse_inputs(what)
    q = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    db = convert.database_from_numpy(P.db_to_numpy(rdb), q.ring, device="cpu")
    eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(), device="cpu", **kw)
    return eng, stream


def _factorized_case():
    """Factorized updates, ported since: a product of an Item factor over
    ksn and one over (cat, price) applied to the retailer engine of the
    sparse cases (``auto`` storage, dense here), twice, bitwise against the
    reference's engine."""
    import _torch_parity as P
    from benchmarks import common as bc
    from repro.core import DenseRelation as RDense
    from repro.core import FactorizedUpdate as RFact
    from repro.core import IVMEngine as RefEngine

    rq, rdb, _, _ = _sparse_inputs("auto")
    eng, _ = _sparse_case("auto")
    ref = RefEngine.build(rq, rdb, var_order=bc.retailer_vo())
    rng = np.random.default_rng(3)
    doms = bc.RETAILER_DOMS
    for _ in range(2):
        upd = RFact(("ksn", "cat", "price"), (
            RDense(("ksn",), rq.ring, {"v": rng.integers(
                -2, 3, doms["ksn"]).astype(np.float32)}),
            RDense(("cat", "price"), rq.ring, {"v": rng.integers(
                0, 2, (doms["cat"], doms["price"])).astype(np.float32)})))
        ref.apply_update("Item", upd)
        eng.apply_update("Item", P.port_update(upd, eng.query.ring))
    P.assert_views_equal(ref, eng, "factorized Item")
    np.testing.assert_array_equal(eng.result().payload["v"].numpy(),
                                  np.asarray(ref.result().payload["v"]))


@pytest.mark.parametrize("what", ["auto", "sparse", "sparse_override",
                                  "indicators", "factorized", "sharding",
                                  "fusion"])
def test_unported_features_raise(what):
    """What is not ported raises; the sparse-storage cases and factorized
    updates, ported since, now run against the reference (sparse storage:
    a short retailer stream, the same storage plan, the same result;
    factorized: :func:`_factorized_case`)."""
    if what in ("auto", "sparse", "sparse_override", "fusion"):
        import _torch_parity as P

        eng, stream = _sparse_case(what)
        ref_plan, ref_result = _reference_run(what)
        assert {n: (s.kind, s.capacity) for n, s in eng.storage_plan.items()} == ref_plan
        kinds = {s.kind for s in eng.storage_plan.values()}
        assert kinds == ({"dense"} if what == "auto" else {"dense", "sparse"})
        with plan.use_fusion("on" if what == "fusion" else "off"):
            for rel, upd in stream:
                eng.apply_update(rel, P.port_update(upd, eng.query.ring))
        np.testing.assert_array_equal(eng.result().payload["v"].numpy(), ref_result)
        if what == "sparse_override":
            assert [n for n, v in eng.views.items()
                    if isinstance(v, storage.SparseRelation)] == [
                        n for n, s in eng.storage_plan.items() if s.kind == "sparse"]
        return
    if what == "indicators":
        # ported since: the acyclic retailer query gets no indicator, as in
        # the reference, and the engine equals its plain build
        from benchmarks import common as bc
        from repro.core import Query as RefQuery
        from repro.core import add_indicators, build_view_tree
        from repro.core import sum_ring as ref_sum_ring

        eng, q, db = _small_engine(device="cpu", use_indicators=True)
        plain, _, _ = _small_engine(device="cpu")
        assert eng.indicators == {} and eng.tree.pretty() == plain.tree.pretty()
        assert all(n.indicator is None for n in eng.tree.walk())
        rq = RefQuery(relations=bc.RETAILER_RELATIONS, free_vars=(),
                      ring=ref_sum_ring(), domains=bc.RETAILER_DOMS,
                      lifts={"units": ("value",)})
        ref_tree = add_indicators(build_view_tree(rq, bc.retailer_vo()), rq)
        assert ref_tree.pretty() == eng.tree.pretty()
        assert all(n.indicator is None for n in ref_tree.walk())
        assert torch.equal(eng.result().payload["v"], plain.result().payload["v"])
        return
    if what == "factorized":
        _factorized_case()
        return
    if what == "sharding":
        # ported since: the sparse case's shard plan at one rank is the
        # reference's at one device, and a sharded executor over it ends
        # where the reference's engine does
        import _torch_parity as P
        import jax
        from benchmarks import common as bc
        from repro.core import IVMEngine as RefEngine
        from repro.core import plan_shards as ref_plan_shards
        from repro_torch.core import plan_shards, shard_executor

        eng, stream = _sparse_case("sparse")
        rq, rdb, _, kw = _sparse_inputs("sparse")
        ref = RefEngine.build(rq, rdb, var_order=bc.retailer_vo(), **kw)
        want = ref_plan_shards(ref, devices=jax.devices()[:1]).pretty()
        assert plan_shards(eng).pretty() == want
        ex = shard_executor(eng)
        ex.run([(rel, P.port_update(upd, eng.query.ring))
                for rel, upd in stream])
        np.testing.assert_array_equal(eng.result().payload["v"].numpy(),
                                      _reference_run("sparse")[1])


@pytest.mark.cuda
def test_cuda_host_has_the_kernel_toolchain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _cuda

    # raises, and so fails the test, where nvcc is missing
    assert pathlib.Path(_cuda.find_nvcc()).exists()
