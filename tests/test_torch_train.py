"""The port's LM training path ≡ the reference's, on the CPU.

Reduced configs of the four dense GQA models (llama3.2-1b, llama3.2-3b,
qwen2-1.5b with its QKV bias, granite-3-2b), float32; parameters drawn with
numpy in the reference's layout and carried into both packages, the
reference run as its own tests run it (``JAX_PLATFORMS=cpu``, XLA).

* ``lm_loss`` and its metrics against ``repro.models.lm.lm_loss`` (some
  labels −1; the reduced vocab of 256 pads to 512 columns), and the MTP
  head through ``replace(mtp=True)``: within 1e-5 relative.
* Gradients: ``torch.autograd.grad`` against ``jax.grad``, every leaf
  within 1e-4 of its largest magnitude (float32, sums in another order
  through the whole backward pass).
* ``remat="full"`` against ``"none"``: bitwise on the CPU.
* ``kernels.ref.flash_attention_bwd_ref`` against autograd of the plain
  forward (float64, 1e-12) and against ``jax.grad`` of
  ``flash_attention_jnp`` (float32, 1e-5 of each output's largest
  magnitude), G 1 and 2, causal and not.
* ``data.lm_data`` batches bitwise, also from ``start_step``.
* ``make_train_plan`` equal to the reference's; one ``make_train_step``
  at 1 and 4 microbatches against the reference's (SGD with momentum: the
  parameters within 1e-5 and the accumulated gradient within 1e-4 of each
  leaf's largest magnitude); the port's own ``run_training`` (the loss falls over
  60 steps; a resume continues the straight run), as
  ``tests/test_train_loop.py``.
* A training checkpoint's manifest lists the reference's leaves (shape,
  dtype, CRC32) for the same carried-across state.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import ShapeSpec as RShape  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.data import lm_data as rdata  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.optim import optimizers as roptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.models import attention, layers, registry  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCHS = ["llama3_2_1b", "llama3_2_3b", "qwen2_1_5b", "granite_3_2b",
         "moonshot_v1_16b_a3b"]
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 16


def numpy_params(specs, seed: int) -> dict:
    """A parameter tree of the spec tree's shapes drawn with numpy: norms
    1 + 0.1·N, biases 0.1·N, embeddings 0.02·N, matrices N / √fan_in."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "zeros":
            return 0.1 * x
        if spec.init == "embed":
            return 0.02 * x
        shape = spec.shape[1:] if spec.axes[0] == "layers" else spec.shape
        fan_in = int(np.prod(shape[:-1])) if spec.axes[-1] == "embed" else shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return layers.map_tree(leaf, specs)


def both(arch: str, **replace):
    """(reference config, port config, numpy parameter tree) of the
    reduced ``arch`` with ``replace`` applied to both configs."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    return rcfg, cfg, numpy_params(registry.build(cfg).specs, seed=len(arch))


def batch_np(cfg, seed=0) -> dict:
    """Tokens and labels [B, S] with a few labels −1 (masked)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


def ref_loss_and_grads(rcfg, tree, batch):
    rapi = rregistry.build(rcfg)
    rp = jax.tree.map(jnp.asarray, tree)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: rapi.loss(p, rb), has_aux=True)(rp)
    return loss, metrics, grads


def port_loss_and_grads(cfg, tree, batch):
    api = registry.build(cfg)
    params = convert.tree_from_numpy(tree, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    xs = [p.requires_grad_() for p in leaves]
    loss, metrics = api.loss(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs)
    return loss, metrics, pytree.tree_unflatten(list(grads), spec)


def assert_rel(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def assert_trees_rel(got, want, rtol):
    """Every leaf of the port's tree within ``rtol`` of the largest
    magnitude of the reference's leaf at the same path."""
    got_np = convert.tree_to_numpy(got)
    want_leaves = jax.tree.leaves_with_path(want)
    got_leaves = jax.tree.leaves(got_np)
    assert len(got_leaves) == len(want_leaves)
    for g, (path, w) in zip(got_leaves, want_leaves):
        assert_rel(g, w, rtol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("mtp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, mtp):
    rcfg, cfg, tree = both(arch, mtp=mtp)
    batch = batch_np(cfg)
    r_loss, r_metrics, r_grads = ref_loss_and_grads(rcfg, tree, batch)
    t_loss, t_metrics, t_grads = port_loss_and_grads(cfg, tree, batch)
    assert cfg.padded_vocab == 512 and cfg.vocab_size == 256
    assert t_loss.dtype == torch.float32 and t_loss.shape == ()
    assert set(t_metrics) == set(r_metrics)
    for k in r_metrics:
        assert_rel(t_metrics[k], r_metrics[k], LOSS_RTOL, k)
    assert float(t_metrics["tokens"]) == 2 * S - 5
    assert_trees_rel(t_grads, r_grads, GRAD_RTOL)


def test_remat_full_equals_none_bitwise():
    _, cfg, tree = both("qwen2_1_5b")
    batch = batch_np(cfg, seed=1)
    got = [port_loss_and_grads(dataclasses.replace(cfg, remat=remat), tree, batch)
           for remat in ("full", "none")]
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(pytree.tree_leaves(got[0][2]), pytree.tree_leaves(got[1][2])):
        assert torch.equal(a, b)


def test_remat_dots_raises():
    _, cfg, tree = both("llama3_2_1b", remat="dots")
    with pytest.raises(NotImplementedError, match="Queue 1 item 20"):
        port_loss_and_grads(cfg, tree, batch_np(cfg))


def test_loss_and_prefill_take_one_tree():
    """Training and serving share the one parameter tree: with every label
    but the last position's masked, the loss is the cross entropy of the
    prefill's last-position logits (the same float32 function, sums in
    another order)."""
    _, cfg, tree = both("granite_3_2b")
    api = registry.build(cfg)
    params = convert.tree_from_numpy(tree, device="cpu")
    batch = batch_np(cfg, seed=2)
    batch["labels"][:, :-1] = -1
    batch["labels"][:, -1] = [3, 7]
    loss, metrics = api.loss(params, batch)
    logits, _ = api.prefill(params, {"tokens": batch["tokens"]})
    ce = layers.softmax_cross_entropy(logits, torch.as_tensor(batch["labels"][:, -1]),
                                      cfg.vocab_size)
    assert float(metrics["tokens"]) == B
    assert abs(float(loss) - float(ce.mean())) <= LOSS_RTOL * float(ce.mean())


# ---------------------------------------------------------------------------
# The plain attention backward
# ---------------------------------------------------------------------------
BWD_SHAPES = [(2, 4, 2, 24, 16, True), (2, 4, 2, 24, 16, False),
              (1, 2, 2, 17, 8, True), (1, 2, 2, 17, 8, False)]


def _qkvo(seed, B_, H, Hkv, T, D, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B_, H, T, D), (B_, Hkv, T, D), (B_, Hkv, T, D), (B_, H, T, D))]


@pytest.mark.parametrize("B_,H,Hkv,T,D,causal", BWD_SHAPES)
def test_flash_bwd_ref_matches_autograd_of_plain_forward(B_, H, Hkv, T, D, causal):
    q, k, v, do = (torch.tensor(a, requires_grad=i < 3) for i, a in
                   enumerate(_qkvo(0, B_, H, Hkv, T, D, np.float64)))
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                      causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert_rel(g, w, 1e-12)


@pytest.mark.parametrize("B_,H,Hkv,T,D,causal", BWD_SHAPES)
def test_flash_bwd_ref_matches_jax_grad_of_flash_attention_jnp(B_, H, Hkv, T, D, causal):
    q, k, v, do = _qkvo(1, B_, H, Hkv, T, D, np.float32)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(*(torch.tensor(a) for a in (q, k, v, np.asarray(o),
                                                                  do)), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_rel(g, w, 1e-5)


def test_model_attention_gradient_on_the_cpu_is_autograd_of_the_plain_branch():
    """On CPU tensors ``models.attention.flash_attention`` stays the plain
    branch (no autograd function), whose gradient is the plain backward's
    (float32: the branch takes its scores in float32)."""
    q, k, v, do = (torch.tensor(a) for a in _qkvo(2, 1, 4, 2, 20, 16, np.float32))
    for t in (q, k, v):
        t.requires_grad_()
    o = attention.flash_attention(q, k, v)
    assert o.grad_fn is not None and "FlashAttentionFn" not in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, (q, k, v), do)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do)
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-5)


# ---------------------------------------------------------------------------
# Data, plan, step, trainer, checkpoint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", [0, 3])
def test_lm_data_batches_bitwise(start):
    cfg, rcfg = get_config("llama3_2_1b").reduced(), ref_config("llama3_2_1b").reduced()
    shape, rshape = ShapeSpec("t", 32, 4, "train"), RShape("t", 32, 4, "train")
    got = lm_data.synthetic_lm_batches(cfg, shape, seed=5, start_step=start, device="cpu")
    want = rdata.synthetic_lm_batches(rcfg, rshape, seed=5, start_step=start)
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    reqs = list(lm_data.serving_requests(cfg, batch=2, prompt_len=8, seed=3, n_requests=2,
                                         device="cpu"))
    rreqs = list(rdata.serving_requests(rcfg, batch=2, prompt_len=8, seed=3, n_requests=2))
    for g, w in zip(reqs, rreqs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "llama3_2_1b", "llama3_2_3b",
                                  "jamba_v0_1_52b", "granite_3_2b"])
@pytest.mark.parametrize("batch,seq", [(256, 4096), (8, 1024), (3, 64)])
def test_make_train_plan_matches_reference(arch, batch, seq):
    got = train.make_train_plan(get_config(arch), ShapeSpec("t", seq, batch, "train"),
                                mesh.make_smoke_mesh())
    want = rtrain.make_train_plan(ref_config(arch), RShape("t", seq, batch, "train"),
                                  rmesh.make_smoke_mesh())
    assert got.n_microbatches == want.n_microbatches
    assert str(got.accum_dtype).split(".")[-1] == jnp.dtype(want.accum_dtype).name
    assert (got.learning_rate, got.warmup_steps, got.total_steps) == (
        want.learning_rate, want.warmup_steps, want.total_steps)


def test_smoke_mesh_matches_reference():
    m, r = mesh.make_smoke_mesh(), rmesh.make_smoke_mesh()
    assert tuple(m.axis_names) == tuple(r.axis_names)
    assert (mesh.dp_axes(m), mesh.dp_size(m), mesh.tp_size(m)) == (
        rmesh.dp_axes(r), rmesh.dp_size(r), rmesh.tp_size(r))
    with pytest.raises(NotImplementedError, match="Queue 1 item 20"):
        mesh.make_production_mesh()


@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_reference(n_micro):
    """One step of granite-3-2b reduced at 8 × 16 from the same parameters
    and batch, with SGD and momentum (its ``mu`` is the accumulated
    gradient).  AdamW's first step is nearly sign(g)·lr for every element,
    so it would turn a gradient within rounding of 0 into a difference of
    up to 2·lr: the optimizers are held to the reference on equal gradients
    in ``tests/test_torch_optim.py``."""
    rcfg, cfg, tree = both("granite_3_2b")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)}
    ropt, opt = roptim.sgd(0.1, momentum=0.9), optimizers.sgd(0.1, momentum=0.9)
    rplan = rtrain.TrainPlan(n_microbatches=n_micro, accum_dtype=jnp.float32)
    plan = train.TrainPlan(n_microbatches=n_micro, accum_dtype=torch.float32)
    rp = jax.tree.map(jnp.asarray, tree)
    r_new, r_state, r_metrics = rtrain.make_train_step(
        rcfg, rregistry.build(rcfg), ropt, rplan)(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.tree_from_numpy(tree, device="cpu")
    new, state, metrics = train.make_train_step(cfg, registry.build(cfg), opt, plan)(
        params, opt.init(params), batch)
    for k in ("loss", "grad_norm"):
        assert metrics[k].shape == () and metrics[k].dtype == torch.float32
        assert_rel(metrics[k], r_metrics[k], LOSS_RTOL, k)
    assert_trees_rel(new, r_new, LOSS_RTOL)
    assert_trees_rel(state["mu"], r_state["mu"], GRAD_RTOL)
    assert int(state["step"]) == int(r_state["step"]) == 1


def test_microbatched_step_equals_single_batch():
    """As tests/test_train_loop.py: gradient accumulation over 4
    microbatches gives the update of one batch (float32 accumulation)."""
    _, cfg, tree = both("granite_3_2b")
    api = registry.build(cfg)
    batch = registry.real_batch(cfg, ShapeSpec("t", 16, 8, "train"),
                                torch.Generator().manual_seed(0))
    assert batch["tokens"].shape == (8, 16) and batch["tokens"].dtype == torch.int32
    opt = optimizers.sgd(0.1)
    params = convert.tree_from_numpy(tree, device="cpu")
    outs = [train.make_train_step(cfg, api, opt, train.TrainPlan(n, torch.float32))(
        params, opt.init(params), batch)[0] for n in (1, 4)]
    for a, b in zip(pytree.tree_leaves(outs[0]), pytree.tree_leaves(outs[1])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_loss_decreases_on_reduced_llama(tmp_path):
    cfg = get_config("llama3_2_1b").reduced()
    _, history = train.run_training(cfg, steps=60, batch_size=8, seq_len=32,
                                    checkpoint_dir=str(tmp_path), log_every=0, device="cpu")
    first = np.mean([h["loss"] for h in history[:10]])
    last = np.mean([h["loss"] for h in history[-10:]])
    assert last < first - 0.3, (first, last)


def test_checkpoint_resume_is_consistent(tmp_path):
    cfg = get_config("qwen2_1_5b").reduced()
    kw = dict(batch_size=4, seq_len=16, checkpoint_every=10, log_every=0, device="cpu")
    _, h_full = train.run_training(cfg, steps=20, checkpoint_dir=str(tmp_path / "a"), **kw)
    train.run_training(cfg, steps=10, checkpoint_dir=str(tmp_path / "b"),
                       schedule_steps=20, **kw)
    _, h_resumed = train.run_training(cfg, steps=20, checkpoint_dir=str(tmp_path / "b"),
                                      schedule_steps=20, **kw)
    assert h_resumed[0]["step"] == 10
    np.testing.assert_allclose(h_full[-1]["loss"], h_resumed[-1]["loss"], rtol=1e-4,
                               atol=1e-4)


def test_train_lm_example_checkpoints_into_a_fresh_directory(tmp_path, monkeypatch):
    """The ``train_lm`` example without ``--ckpt`` checkpoints into a fresh
    directory under ``TMPDIR`` and removes it, so a second run trains from
    step 0 again; with ``--ckpt DIR`` a rerun of a finished run resumes at
    its end and has nothing left to train."""
    import tempfile

    from repro_torch.examples import train_lm

    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(tempfile, "tempdir", None)
    (tmp_path / "tmp").mkdir()
    argv = ["--tiny", "--steps", "3", "--device", "cpu"]
    runs = [train_lm.main(argv) for _ in range(2)]
    assert [[h["step"] for h in run] for run in runs] == [[0, 1, 2]] * 2
    assert runs[0][-1]["loss"] == runs[1][-1]["loss"]
    assert not list((tmp_path / "tmp").glob("repro_train_lm_*"))
    kept = str(tmp_path / "kept")
    assert len(train_lm.main(argv + ["--ckpt", kept])) == 3
    assert train_lm.main(argv + ["--ckpt", kept]) == []


def test_bf16_training_state_checkpoints_through_float32(tmp_path):
    """A bf16 parameter tree saves its leaves as float32 (exact) and
    restores them in bf16, bitwise."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(), param_dtype="bfloat16",
                              act_dtype="bfloat16")
    kw = dict(batch_size=2, seq_len=8, log_every=0, device="cpu")
    params, _ = train.run_training(cfg, steps=2, checkpoint_dir=str(tmp_path), **kw)
    assert pytree.tree_leaves(params)[0].dtype == torch.bfloat16
    from repro_torch.checkpoint.checkpointer import Checkpointer

    manifest = Checkpointer(str(tmp_path)).read_manifest(2)
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {"float32", "int32"}
    again, history = train.run_training(cfg, steps=2, checkpoint_dir=str(tmp_path), **kw)
    assert history == []
    for a, b in zip(pytree.tree_leaves(params), pytree.tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_manifest_lists_reference_leaves(tmp_path):
    """The same (params, AdamW state) after one reference step, saved by
    both checkpointers: equal leaf lists (shape, dtype, CRC32)."""
    from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
    from repro_torch.checkpoint.checkpointer import Checkpointer

    rcfg, cfg, tree = both("llama3_2_3b")
    ropt = roptim.adamw(1e-2)
    rp = jax.tree.map(jnp.asarray, tree)
    rb = {k: jnp.asarray(v) for k, v in batch_np(cfg).items()}
    rp, rstate, _ = rtrain.make_train_step(
        rcfg, rregistry.build(rcfg), ropt, rtrain.TrainPlan(1, jnp.float32))(
        rp, ropt.init(rp), rb)
    state_np = jax.tree.map(np.asarray, (rp, rstate))
    RCheckpointer(str(tmp_path / "ref")).save(state_np, 1)
    carried = convert.tree_from_numpy(state_np, device="cpu")
    Checkpointer(str(tmp_path / "port")).save(train._host_form(carried), 1)

    def leaves(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            return json.load(f)["leaves"]

    assert leaves(tmp_path / "port") == leaves(tmp_path / "ref")
    back = convert.tree_to_numpy(carried)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state_np)):
        np.testing.assert_array_equal(a, b)
