"""The port's recsys training against the reference on the CPU: the
optimizers, ``loss_fn`` and its gradients, the train step (with micro
batches), the loop, checkpoints in both directions, resume, the straggler
watchdog, gradient compression, ``launch/train.py`` and the
``train_retrieval`` example, and the gradient of ``fm_interaction``.

Both packages run the same numpy inputs; the reference's parameters
(perturbed, so biases and norm weights are not their constant inits) cross
through ``params_from_numpy``. The port's steps update parameters and
state in place, and ``params_from_numpy`` shares the numpy arrays' memory
on the CPU, so every port tree here is a copy.

Tolerances, each as |Δ| ≤ tol·max|ref| over a tensor unless said:

- gradients and losses under ``FP32``: 1e-5 (the two packages sum the
  same f32 products in other orders); under ``MIXED``: 0.03 (bf16 steps of
  2^-8 carried through the layers; the tanh GELU rounds each op to bf16 in
  the reference, once in the port), as in ``test_torch_recsys_models.py``.
  Where the reference's own bf16 gradient of a leaf lies further than that
  from its f32 gradient (bert4rec's block biases: 4.1% at full width, the
  GELU's backward rounded op by op), the port's must lie at most twice as
  far from the f32 gradient as the reference's does (two bf16 roundings of
  one f32 gradient; the port's is 0.8% there);
- the optimizers on identical gradients, and a whole fm step under FP32:
  1e-6 (the same f32 ops in the same order; reductions and ``pow`` round
  otherwise by an ulp or so);
- loss trajectories of the loop: rtol 1e-5 (launch/train.py's stream) and
  the reference's own rtol 1e-4 for resume equivalence;
- ``fm_interaction``'s gradient against autograd through the plain version
  and against JAX's: 1e-6 (the same formula rounded in another order).
"""
import dataclasses
import functools
import itertools
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import bert4rec as jbert  # noqa: E402
from repro.configs import dlrm_rm2 as jdlrm  # noqa: E402
from repro.configs import fm as jfm  # noqa: E402
from repro.configs import xdeepfm as jxdeepfm  # noqa: E402
from repro.kernels.fm_interaction.ref import fm_interaction_ref as j_fm_ref  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import bert4rec as tbert  # noqa: E402
from repro_torch.configs import dlrm_rm2 as tdlrm  # noqa: E402
from repro_torch.configs import fm as tfm  # noqa: E402
from repro_torch.configs import xdeepfm as txdeepfm  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.examples import train_retrieval  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import fm_interaction, fm_interaction_ref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train import compress as tcompress  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

MODULES = {"fm": (jfm, tfm, {"vocab_per_field": 1000}),
           "dlrm-rm2": (jdlrm, tdlrm, {"vocab_per_field": 1000}),
           "xdeepfm": (jxdeepfm, txdeepfm, {"vocab_per_field": 1000}),
           "bert4rec": (jbert, tbert, {"n_items": 2000})}
TOL = {"FP32": 1e-5, "MIXED": 0.03}
OPT_TOL, B, N_MASKED, N_NEG = 1e-6, 8, 3, 50


def perturb(tree_, rng):
    """Each leaf plus 0.3 of its spread (0.1 for a constant leaf) times
    N(0, 1), as numpy."""
    def one(a):
        a = np.asarray(a)
        s = float(a.std()) or 0.1
        return (a + 0.3 * s * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(one, tree_)


def configs(arch, size, prec="FP32"):
    jmod, tmod, cut = MODULES[arch]
    if size == "reduced":
        jcfg, tcfg = jmod.make_reduced(), tmod.make_reduced()
    else:
        jcfg = dataclasses.replace(jmod.make_config(), **cut)
        tcfg = dataclasses.replace(tmod.make_config(), **cut)
    return (dataclasses.replace(jcfg, precision=getattr(jcommon, prec)),
            dataclasses.replace(tcfg, precision=getattr(tcommon, prec)))


def make_batch(cfg, rng, b=B):
    """CTR ids over [−V, V) (negative ids wrap) with labels in {0, 1} (and
    N(0, 1) dense features for dlrm); bert4rec histories over [−n, n), masked
    positions in [0, S), labels and shared negatives in [0, n)."""
    if cfg.kind == "bert4rec":
        n, s = cfg.n_items, cfg.seq_len
        return {"items": rng.integers(-n, n, (b, s)).astype(np.int32),
                "masked_pos": rng.integers(0, s, (b, N_MASKED)).astype(np.int32),
                "labels": rng.integers(0, n, (b, N_MASKED)).astype(np.int32),
                "neg_ids": rng.integers(0, n, (N_NEG,)).astype(np.int32)}
    v = cfg.vocab_per_field
    batch = {"sparse": rng.integers(-v, v, (b, cfg.n_sparse)).astype(np.int32),
             "labels": rng.integers(0, 2, (b,)).astype(np.float32)}
    if cfg.n_dense:
        batch["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    return batch


def copy_tree(t):
    return tree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else np.array(x), t)


def port_params(tcfg, jp):
    """The reference's parameters as the port's, in memory of their own."""
    return copy_tree(trecsys.params_from_numpy(tcfg, jp, "cpu"))


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close_scaled(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3e} against max|ref| {scale:.3e}"


def assert_trees_close(got, want, tol, what=""):
    """Every leaf, by JAX's path names and order."""
    g = tree.flatten_with_paths(got)
    w = [("/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                   for k in path), leaf)
         for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [n for n, _ in g] == [n for n, _ in w], what
    for (name, a), (_, b) in zip(g, w):
        assert_close_scaled(a, b, tol, f"{what} {name}")


# ---------------------------------------------------------------------------
# Gradients of loss_fn
# ---------------------------------------------------------------------------

GRAD_CASES = [(a, s, p) for a in MODULES for s in ("reduced", "full") for p in ("FP32", "MIXED")]


@functools.lru_cache(maxsize=None)
def grad_case(arch, size, prec):
    """(reference cfg, port cfg, reference params (numpy), batch)."""
    jcfg, tcfg = configs(arch, size, prec)
    rng = np.random.default_rng(GRAD_CASES.index((arch, size, prec)))
    jp = perturb(jrecsys.init_params(jcfg, jax.random.PRNGKey(0)), rng)
    return jcfg, tcfg, jp, make_batch(tcfg, rng)


@pytest.mark.parametrize("arch,size,prec", GRAD_CASES, ids=["-".join(c) for c in GRAD_CASES])
def test_loss_and_gradients_match_reference(arch, size, prec):
    """``loss_and_grads(loss_fn)`` against ``jax.value_and_grad``: the
    loss and every gradient leaf (bert4rec through its sampled softmax)."""
    jcfg, tcfg, jp, batch = grad_case(arch, size, prec)
    jl, jg = jax.value_and_grad(functools.partial(jrecsys.loss_fn, jcfg))(jp, jbatch(batch))
    tp = port_params(tcfg, jp)
    tl, tg = tstep.loss_and_grads(functools.partial(trecsys.loss_fn, tcfg), tp, batch)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert_close_scaled(tl, jl, TOL[prec], "loss")
    assert all(g.dtype == torch.float32 for g in tree.leaves(tg))
    if prec == "FP32":
        assert_trees_close(tg, jg, TOL[prec], "grad")
    else:
        jg32 = jax.grad(functools.partial(jrecsys.loss_fn, configs(arch, size)[0]))(
            jp, jbatch(batch))
        names = [n for n, _ in tree.flatten_with_paths(tg)]
        for name, t, j, j32 in zip(names, tree.leaves(tg), jax.tree.leaves(jg),
                                   jax.tree.leaves(jg32)):
            t, j, j32 = t.numpy(), np.asarray(j), np.asarray(j32)
            assert t.shape == j.shape, name
            scale = float(np.abs(j).max())
            if float(np.abs(t - j).max()) > TOL[prec] * scale:
                ref_off = float(np.abs(j - j32).max())
                assert ref_off > TOL[prec] * scale, f"grad {name}"
                assert float(np.abs(t - j32).max()) <= 2.0 * ref_off, f"grad {name}"
    # the parameters are left as they were, with no autograd flags
    for a, b in zip(tree.leaves(tp), tree.leaves(port_params(tcfg, jp))):
        assert torch.equal(a, b) and not a.requires_grad


def test_fm_tables_gradient_flows_through_the_interaction():
    """The second-order term's gradient reaches ``tables``: the rows a
    batch touches get a gradient, equal to autograd through the plain
    version (within 1e-6 of its scale), and the others stay zero."""
    jcfg, tcfg, jp, batch = grad_case("fm", "reduced", "FP32")
    tp = port_params(tcfg, jp)
    loss = functools.partial(trecsys.loss_fn, tcfg)
    _, g = tstep.loss_and_grads(loss, tp, batch)

    def plain_loss(p, b):  # the same loss with the plain version's autograd
        f, v = p["tables"].shape[:2]
        flat = trecsys._flat_ids(b["sparse"], f, v, p["tables"].device)
        second = fm_interaction_ref(trecsys._gather(p["tables"], flat))
        lin = trecsys._sum_fields(trecsys._gather(p["linear"], flat))
        logits = second + lin + p["bias"]
        return tcommon.bce_with_logits(logits, torch.as_tensor(b["labels"]))

    _, want = tstep.loss_and_grads(plain_loss, tp, batch)
    assert_close_scaled(g["tables"], want["tables"].numpy(), OPT_TOL, "tables")
    touched = torch.zeros(tcfg.n_sparse, tcfg.vocab_per_field, dtype=torch.bool)
    ids = torch.as_tensor(batch["sparse"]).long() % tcfg.vocab_per_field
    touched[torch.arange(tcfg.n_sparse)[None, :], ids] = True
    assert bool((g["tables"].abs().sum(-1) > 0)[touched].all())
    assert not bool(g["tables"][~touched].any())


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

OPT_SHAPES = {"emb": (2, 256, 128), "w": (16, 8), "b": (7,), "s": ()}
OPT_CASES = [(k, c) for k in ("adamw", "adafactor", "sgd") for c in (1.0, 0.0)]


def opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * (0.1 + i)).astype(np.float32)
              for k, s in OPT_SHAPES.items()} for i in range(3)]
    return params, grads


@pytest.mark.parametrize("kind,clip", OPT_CASES, ids=[f"{k}-clip{c:g}" for k, c in OPT_CASES])
def test_apply_updates_matches_reference(kind, clip):
    """Three steps from carried state on identical gradients (the second
    and third steps' norms above 1, so clipping scales them): params,
    state and grad_norm within 1e-6 after each. The (2, 256, 128) leaf
    takes Adafactor's factored branch and its RMS clip."""
    params, grads = opt_inputs(OPT_CASES.index((kind, clip)))
    cfg_kw = dict(kind=kind, lr=1e-2, grad_clip=clip)
    jcfg, tcfg = joptim.OptimConfig(**cfg_kw), toptim.OptimConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.init_state(jcfg, jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = toptim.init_state(tcfg, tp)
    assert_trees_close(ts, js, 0.0, "init")
    if kind == "adafactor":
        assert tuple(ts.vr["emb"].shape) == (2, 256) and tuple(ts.vc["emb"].shape) == (2, 128)
    for g in grads:
        jp, js, jm = joptim.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tg = {k: torch.tensor(v) for k, v in g.items()}
        tp2, ts, tm = toptim.apply_updates(tcfg, tp, tg, ts)
        assert tp2 is tp  # updated in place
        assert_trees_close(tp, jp, OPT_TOL, "params")
        assert_trees_close(ts, js, OPT_TOL, "state")
        assert_close_scaled(tm["grad_norm"], jm["grad_norm"], OPT_TOL, "grad_norm")
        assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_state_from_numpy_carries_the_reference_state(kind):
    """The reference's state after one step, handed across, continues to
    the same params as the reference's second step; a wrong shape raises."""
    params, grads = opt_inputs(7)
    cfg_kw = dict(kind=kind, lr=1e-2)
    jcfg, tcfg = joptim.OptimConfig(**cfg_kw), toptim.OptimConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    jp, js, _ = joptim.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, grads[0]), joptim.init_state(jcfg, jp))
    js_np = jax.tree.map(np.asarray, js)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    ts = toptim.state_from_numpy(tcfg, tp, js_np)
    assert_trees_close(ts, js, 0.0, "handed across")
    jp, js, _ = joptim.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, grads[1]), js)
    toptim.apply_updates(tcfg, tp, {k: torch.tensor(v) for k, v in grads[1].items()}, ts)
    assert_trees_close(tp, jp, OPT_TOL, "params")
    if kind != "sgd":  # the numpy state is not written through
        assert_trees_close(toptim.state_from_numpy(tcfg, tp, js_np), jax.tree.map(np.asarray, js_np), 0.0)
        bad = js_np._replace(**{js_np._fields[1]: {**js_np[1], "w": np.zeros((3, 3), np.float32)}})
        with pytest.raises(ValueError):
            toptim.state_from_numpy(tcfg, tp, bad)


def test_abstract_state_is_on_meta():
    cfg = tdlrm.make_config()
    st = toptim.abstract_state(get_arch("dlrm-rm2").optim, trecsys.abstract_params(cfg))
    assert all(t.device.type == "meta" for t in tree.leaves(st))
    assert tuple(st.mu["tables"].shape) == (26, 1_000_000, 64)
    assert [n for n, _ in tree.flatten_with_paths(st)][:3] == ["step", "mu/bot/b0", "mu/bot/b1"]


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_fm_train_step_matches_reference(size):
    """A whole fm step under FP32 from the same params and batch: loss,
    grad_norm, params and state within 1e-6 of their scale."""
    jcfg, tcfg, jp, batch = grad_case("fm", size, "FP32")
    opt = get_arch("fm").optim
    js = joptim.init_state(opt, jp)
    jp2, js2, jm = jax.jit(jstep.make_recsys_train_step(jcfg, opt))(jp, js, jbatch(batch))
    tp = port_params(tcfg, jp)
    tp2, ts2, tm = tstep.make_recsys_train_step(tcfg, opt)(tp, toptim.init_state(opt, tp), batch)
    assert_close_scaled(tm["loss"], jm["loss"], OPT_TOL, "loss")
    assert_close_scaled(tm["grad_norm"], jm["grad_norm"], OPT_TOL, "grad_norm")
    assert_trees_close(tp2, jp2, OPT_TOL, "params")
    assert_trees_close(ts2, js2, OPT_TOL, "state")


@pytest.mark.parametrize("arch", ["fm", "bert4rec"])
def test_micro_batches_match_reference(arch):
    """``_accumulating_step`` with two micro batches (f32 accumulation,
    division by 2, mean loss) against the reference's scan, reduced
    config under FP32."""
    jcfg, tcfg, jp, batch = grad_case(arch, "reduced", "FP32")
    batch = dict(batch, neg_ids=batch["neg_ids"][:48]) if arch == "bert4rec" else batch
    opt = get_arch(arch).optim
    jfn = jstep._accumulating_step(functools.partial(jrecsys.loss_fn, jcfg), opt, 2,
                                   jstep._split_leading)
    jp2, js2, jm = jfn(jp, joptim.init_state(opt, jp), jbatch(batch))
    tfn = tstep._accumulating_step(functools.partial(trecsys.loss_fn, tcfg), opt, 2,
                                   tstep._split_leading)
    tp = port_params(tcfg, jp)
    tp2, ts2, tm = tfn(tp, toptim.init_state(opt, tp), batch)
    assert_close_scaled(tm["loss"], jm["loss"], OPT_TOL, "loss")
    assert_close_scaled(tm["grad_norm"], jm["grad_norm"], OPT_TOL, "grad_norm")
    assert_trees_close(ts2.mu, js2.mu, 1e-5, "first moments")
    assert_trees_close(tp2, jp2, OPT_TOL, "params")


# ---------------------------------------------------------------------------
# The loop, checkpoints, resume, the watchdog
# ---------------------------------------------------------------------------


def fm_setup(arch="fm", batch_size=16):
    """The reduced config (under FP32) with the reference's perturbed
    params (numpy), the port's copy, and launch/train.py's batch stream of
    each package."""
    jspec, tspec = jlaunch_spec(arch), get_arch(arch)
    jcfg = dataclasses.replace(jspec.make_reduced(), precision=jcommon.FP32)
    tcfg = dataclasses.replace(tspec.make_reduced(), precision=tcommon.FP32)
    jp = perturb(jrecsys.init_params(jcfg, jax.random.PRNGKey(0)), np.random.default_rng(3))
    return (jspec, jcfg, jp, jlaunch.make_batch_fn(jspec, jcfg, batch_size, 64),
            tspec, tcfg, port_params(tcfg, jp),
            tlaunch.make_batch_fn(tspec, tcfg, batch_size, 64, "cpu"))


def jlaunch_spec(arch):
    from repro.configs.registry import get_arch as jget_arch
    return jget_arch(arch)


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2", "bert4rec"])
def test_loop_losses_match_reference(arch):
    """20 steps of each package's loop on launch/train.py's stream from the
    same params, under FP32 (bf16 logits would differ by a rounding step
    at once): the batches equal, the losses within rtol 1e-5."""
    jspec, jcfg, jp, jbatches, tspec, tcfg, tp, tbatches = fm_setup(arch)
    for s in (0, 19):
        for k, v in jbatches(s).items():
            np.testing.assert_array_equal(tbatches(s)[k].numpy(), np.asarray(v))
    lcfg = dict(total_steps=20, ckpt_every=100, ckpt_dir=None, log_every=0)
    _, _, jres = jloop.run(jax.jit(jstep.make_recsys_train_step(jcfg, jspec.optim)), jp,
                           joptim.init_state(jspec.optim, jp), jbatches, jloop.LoopConfig(**lcfg))
    _, _, tres = tloop.run(tstep.make_recsys_train_step(tcfg, tspec.optim), tp,
                           toptim.init_state(tspec.optim, tp), tbatches, tloop.LoopConfig(**lcfg))
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    assert tres.final_step == 20 and tres.resumed_from is None and tres.checkpoints_written == 0


def manifest(path):
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["fm", "bert4rec"])
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """After a step of each package: the reference's checkpoint restores in
    the port and the port's in the reference, names, order, dtypes and
    values equal; each package writes the same manifest."""
    jspec, jcfg, jp, jbatches, tspec, tcfg, tp, tbatches = fm_setup(arch)
    jp, js, _ = jax.jit(jstep.make_recsys_train_step(jcfg, jspec.optim))(
        jp, joptim.init_state(jspec.optim, jp), jbatches(0))
    jckpt.save(str(tmp_path / "ref"), 1, (jp, js), extra={"loss": 0.5})
    tp, ts, _ = tstep.make_recsys_train_step(tcfg, tspec.optim)(
        tp, toptim.init_state(tspec.optim, tp), tbatches(0))
    tckpt.save(str(tmp_path / "port"), 1, (tp, ts), extra={"loss": 0.5})
    jm, tm = manifest(tmp_path / "ref" / "step_0000000001"), manifest(tmp_path / "port" / "step_0000000001")
    assert jm["leaves"] == tm["leaves"] and jm["extra"] == tm["extra"] == {"loss": 0.5}
    names = [r["name"] for r in tm["leaves"]]
    assert names[0] == ("0/blocks/b1" if arch == "bert4rec" else "0/bias")
    assert "1/step" in names and any(n.startswith("1/mu/") for n in names)

    (rp, rs), extra = tckpt.restore(str(tmp_path / "ref"), 1, (tp, ts))
    assert extra == {"loss": 0.5} and type(rs) is toptim.AdamWState
    assert rs.step.dtype == torch.int32 and int(rs.step) == 1
    assert_trees_close((rp, rs), (jp, js), 0.0, "reference → port")
    (qp, qs), _ = jckpt.restore(str(tmp_path / "port"), 1, (jp, js))
    assert_trees_close((tp, ts), (qp, qs), 0.0, "port → reference")
    assert str(qs.step.dtype) == "int32"


def test_checkpoint_retention_tmp_and_shape_rules(tmp_path):
    """The reference's TestCheckpoint rules on the port: latest and
    retention, a stale ``.tmp`` never listed, a shape mismatch raises."""
    *_, tspec, tcfg, tp, _ = fm_setup()
    ts = toptim.init_state(tspec.optim, tp)
    d = str(tmp_path)
    for s in (10, 20, 30, 40):
        tckpt.save(d, s, (tp, ts), keep=2)
    assert tckpt.latest_step(d) == 40 and tckpt.all_steps(d) == [30, 40]
    os.makedirs(tmp_path / "step_0000000050.tmp")
    (tmp_path / "step_0000000050.tmp" / "leaf_00000.npy").write_bytes(b"junk")
    assert tckpt.latest_step(d) == 40
    (p2, _), _ = tckpt.restore(d, 40, (tp, ts))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p2), tree.leaves(tp)))
    tckpt.save(d, 5, tp)
    bad = tree.tree_map(lambda p: torch.zeros(p.shape + (1,)), tp)
    with pytest.raises(ValueError):
        tckpt.restore(d, 5, bad)
    with pytest.raises(ValueError):
        tckpt.restore(d, 5, (tp, ts))


def test_resume_equals_uninterrupted(tmp_path):
    """The reference's TestPreemptionResume on the port: 12 steps with a
    checkpoint every 4; a crash at step 7, then a resume from step 4; the
    final loss within rtol 1e-4 of the uninterrupted run."""
    def setup():
        *_, tspec, tcfg, tp, tb = fm_setup()
        return (tstep.make_recsys_train_step(tcfg, tspec.optim), tp,
                toptim.init_state(tspec.optim, tp), tb)

    base = dict(total_steps=12, ckpt_every=4, log_every=0)
    step, p, o, b = setup()
    _, _, res_a = tloop.run(step, p, o, b, tloop.LoopConfig(ckpt_dir=str(tmp_path / "a"), **base))
    step, p, o, b = setup()
    with pytest.raises(tloop.SimulatedPreemption):
        tloop.run(step, p, o, b,
                  tloop.LoopConfig(ckpt_dir=str(tmp_path / "b"), crash_at_step=7, **base))
    step, p, o, b = setup()
    _, _, res_b = tloop.run(step, p, o, b, tloop.LoopConfig(ckpt_dir=str(tmp_path / "b"), **base))
    assert res_b.resumed_from == 4 and len(res_b.losses) == 8
    assert res_a.checkpoints_written == 3 and tckpt.all_steps(str(tmp_path / "a")) == [4, 8, 12]
    np.testing.assert_allclose(res_a.losses[-1], res_b.losses[-1], rtol=1e-4)


def test_straggler_watchdog_flags_slow_step():
    *_, tspec, tcfg, tp, tb = fm_setup()
    step = tstep.make_recsys_train_step(tcfg, tspec.optim)
    calls = itertools.count()

    def slow_step(p, o, b):
        if next(calls) == 9:
            time.sleep(0.5)
        return step(p, o, b)

    cfg_l = tloop.LoopConfig(total_steps=12, ckpt_every=100, ckpt_dir=None, log_every=0,
                             straggler_factor=3.0)
    _, _, res = tloop.run(slow_step, tp, toptim.init_state(tspec.optim, tp), tb, cfg_l)
    assert any(e["step"] == 9 for e in res.straggler_events), res.straggler_events


# ---------------------------------------------------------------------------
# Gradient compression (the reference's three tests, as parity cases)
# ---------------------------------------------------------------------------


def test_compression_error_feedback_convergence_matches_reference():
    """EF-compressed SGD on the reference's regression problem reaches a
    loss close to uncompressed SGD in both packages, the two losses within
    rtol 1e-4 of each other."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    y = x @ w_true

    def j_train(compressed):
        loss = lambda w: jnp.mean((x @ w - y) ** 2)  # noqa: E731
        gfn = jax.jit(jax.grad(loss))
        w = jnp.zeros((16,))
        err = jcompress.init_error_state(w)
        for _ in range(300):
            g = gfn(w)
            if compressed:
                comp, err = jcompress.compress_grads(g, err)
                g = jcompress.decompress_grads(comp)
            w = w - 0.05 * g
        return float(loss(w))

    xt, yt = torch.tensor(x), torch.tensor(y)

    def t_train(compressed):
        w = torch.zeros(16)
        err = tcompress.init_error_state(w)
        for _ in range(300):
            g = 2.0 * xt.T @ (xt @ w - yt) / len(yt)
            if compressed:
                comp, err = tcompress.compress_grads(g, err)
                g = tcompress.decompress_grads(comp)
            w = w - 0.05 * g
        return float(((xt @ w - yt) ** 2).mean())

    for comp in (False, True):
        jl, tl = j_train(comp), t_train(comp)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-9)
    l_plain, l_comp = t_train(False), t_train(True)
    assert l_comp < max(5 * l_plain, 1e-3), (l_plain, l_comp)


def test_compression_ratio_matches_reference():
    g = {"a": np.ones((128, 128), np.float32), "b": np.ones((64,), np.float32)}
    jcomp, _ = jcompress.compress_grads(jax.tree.map(jnp.asarray, g),
                                        jcompress.init_error_state(g))
    tg = {k: torch.tensor(v) for k, v in g.items()}
    tcomp, _ = tcompress.compress_grads(tg, tcompress.init_error_state(tg))
    raw = sum(v.size * 4 for v in g.values())
    assert tcompress.compressed_bytes(tcomp) == jcompress.compressed_bytes(jcomp)
    assert tcompress.compressed_bytes(tcomp) * 4 <= raw + 1024
    assert all(q.dtype == torch.int8 for q in tree.leaves(tcomp.q))


def test_compression_roundtrip_matches_reference():
    """The same int8 codes and scales as the reference, the error state the
    exact residual, the round trip within half a step."""
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "v": rng.normal(size=(9,)).astype(np.float32)}
    e = {"w": (rng.normal(size=(64, 64)) * 0.01).astype(np.float32),
         "v": np.zeros(9, np.float32)}
    jcomp, jerr = jcompress.compress_grads(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    tg = {k: torch.tensor(v) for k, v in g.items()}
    tcomp, terr = tcompress.compress_grads(tg, {k: torch.tensor(v) for k, v in e.items()})
    assert_trees_close(tcomp.q, jcomp.q, 0.0, "codes")
    assert_trees_close(tcomp.scale, jcomp.scale, 0.0, "scales")
    assert_trees_close(terr, jerr, 1e-6, "error state")
    back = tcompress.decompress_grads(tcomp)
    for k in g:
        total = g[k] + e[k]
        scale = float(np.abs(total).max()) / 127.0
        assert float(np.abs(back[k].numpy() - total).max()) <= scale * 0.5 + 1e-6
        np.testing.assert_allclose(terr[k].numpy(), total - back[k].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2", "xdeepfm", "bert4rec"])
def test_launch_train_runs_on_cpu(arch, tmp_path, capsys):
    """``--device cpu`` trains the reduced config with checkpoints, and a
    second run resumes from the last of them."""
    argv = ["--arch", arch, "--steps", "6", "--batch-size", "8", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "4", "--device", "cpu"]
    res = tlaunch.main(argv)
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert res.checkpoints_written == 2 and tckpt.all_steps(str(tmp_path)) == [4, 6]
    assert f"[done] {arch}: loss" in capsys.readouterr().out
    res2 = tlaunch.main([*argv[:3], "8", *argv[4:]])
    assert res2.resumed_from == 6 and len(res2.losses) == 2


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "graphcast"])
def test_launch_train_runs_lm_and_gnn(arch, capsys):
    """The LM and GNN families train through ``main`` on the CPU (their
    branches: the family's parameters, step and batches)."""
    res = tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert res.checkpoints_written == 0 and res.resumed_from is None
    assert f"[done] {arch}: loss" in capsys.readouterr().out


def test_train_retrieval_example_on_cpu(capsys):
    """The example trains fm for 300 steps with checkpoints (the loss
    falls), then serves hybrid retrieval through the brute backend, every
    returned item matching user 0's attributes."""
    out = train_retrieval.main(["--device", "cpu"])
    assert len(out["losses"]) == train_retrieval.STEPS
    assert out["losses"][-1] < out["losses"][0] - 0.1
    assert out["backend"] == "brute" and out["ids"].shape == (256, 10)
    assert out["matched"] == int((out["ids"][0] >= 0).sum())
    assert "3 checkpoints, resumed_from=None" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The gradient of fm_interaction
# ---------------------------------------------------------------------------

FM_SHAPES = [(1, 1, 1), (5, 39, 10), (3, 7, 64), (17, 2, 3), (0, 4, 5)]


@pytest.mark.parametrize("shape", FM_SHAPES, ids=["x".join(map(str, s)) for s in FM_SHAPES])
def test_fm_interaction_gradient(shape):
    """The ``Function``'s forward equals the plain version bit for bit; its
    gradient under a random upstream equals autograd through the plain
    version and JAX's gradient of ``fm_interaction_ref`` within 1e-6 of
    their scale."""
    rng = np.random.default_rng(sum(shape))
    e_np = (rng.normal(size=shape) * 0.3).astype(np.float32)
    w_np = rng.normal(size=shape[:1]).astype(np.float32)
    w = torch.tensor(w_np)
    e = torch.tensor(e_np, requires_grad=True)
    out = fm_interaction(e)
    assert out.grad_fn is not None and torch.equal(out.detach(), fm_interaction_ref(e.detach()))
    (got,) = torch.autograd.grad((out * w).sum(), e)
    e2 = torch.tensor(e_np, requires_grad=True)
    (plain,) = torch.autograd.grad((fm_interaction_ref(e2) * w).sum(), e2)
    want = jax.grad(lambda x: (j_fm_ref(x) * w_np).sum())(jnp.asarray(e_np))
    assert got.shape == e.shape and got.dtype == torch.float32
    assert_close_scaled(got, plain.numpy(), OPT_TOL, "against the plain version's autograd")
    assert_close_scaled(got, want, OPT_TOL, "against JAX")
