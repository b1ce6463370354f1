"""The port's LM training (``train.step.make_lm_train_step``, the remat of
``models/transformer.py``, the LM branch of ``launch/train.py``) against the
reference on the CPU.

The reference's ``init_params`` (perturbed, so that the norm weights are
not their constant ones) crosses as numpy arrays through
``params_from_numpy``; both packages run the same numpy tokens. Each LM
arch runs at its reduced config under ``FP32`` and ``MIXED``, with
``micro_batches`` 1 and the spec's (2 to 8), at B = 8, S = 16: the loss,
the gradient norm and the updated parameters of one call of the jitted
reference step and of the port's step, and the accumulated gradients
(``train.step.accumulated_grads``, the port step's own) against the
reference's ``value_and_grad`` summed over the same slices.

Tolerances, as |Δ| ≤ tol·max|ref| over a tensor:

- ``FP32``: 1e-5 (the same f32 products summed in other orders; the
  largest difference seen is 1.0e-6 of a leaf's scale);
- ``MIXED``: 0.03 (bf16 keeps 8 significant bits; the dense archs agree
  within 7.6e-3);
- each updated parameter within 2·lr + 1e-6 of the reference's: an Adam
  step moves a weight by about lr whatever the gradient's size, so a
  gradient near 0 whose sign differs moves it the other way.

MoE under ``MIXED``: a bf16 rounding step moves router logits by up to
≈ 4e-3, so a token near a router tie may pick other experts in one package
than in the other, and its gradient then differs by the scale of an
expert's gradient (0.36 of max|ref| for mixtral-smoke, 0.41 for kimi-smoke
at B = 8, S = 16). Gradients sum over every token, so a single such token
moves every expert weight it reaches. Their gradients are held on
micro-batches (one sequence of ``MOE_S`` tokens each) drawn from a fixed
seeded list where ``transformer.unsettled_tokens`` (EPS = 0.01, of the
port's router logits, which differ from the reference's by less than EPS/2)
marks no token; how many were held is reported, and at least half must be.
The held micro-batches are accumulated as one micro-batched step (each
routed alone, as the step routes its slices), since one two-token
sequence's gradient is dominated by bf16 cancellation (up to 8% of a
leaf's scale between the two packages, as far as either lies from the f32
gradient). The loss, a mean over tokens, and the updated parameters are
held whole.
"""
import dataclasses
import functools
import itertools
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

LM_IDS = sorted(a for a, spec in jregistry.ARCHS.items() if spec.family == "lm")
MOE_IDS = ("kimi-k2-1t-a32b", "mixtral-8x7b")
TOL = {"FP32": 1e-5, "MIXED": 0.03}
EPS = 0.01  # router logit gap below which a MIXED token may route differently
B, S = 8, 16
MOE_BATCHES, MOE_S = 8, 2  # the seeded list of MoE MIXED gradient batches


def perturb(tree_, rng):
    """Each leaf plus 0.3 of its spread (0.1 for a constant leaf) times
    N(0, 1), as numpy."""
    def one(a):
        a = np.asarray(a)
        s = float(a.std()) or 0.1
        return (a + 0.3 * s * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(one, tree_)


def configs(arch, prec, **kw):
    jcfg = dataclasses.replace(jregistry.get_arch(arch).make_reduced(),
                               precision=getattr(jcommon, prec), **kw)
    tcfg = dataclasses.replace(get_arch(arch).make_reduced(),
                               precision=getattr(tcommon, prec), **kw)
    return jcfg, tcfg


def lm_batch(rng, vocab, b, s):
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.copy(v)) for k, v in batch.items()}


def ref_grads(cfg, micro, params, batch):
    """The reference's gradient accumulation (``train/step.py``'s scan):
    each slice's gradients summed in f32 in slice order, over their
    count; the loss the slices' mean."""
    if micro == 1:
        return jax.value_and_grad(functools.partial(jtfm.loss_fn, cfg))(params, batch)
    sliced = jstep._split_leading(batch, micro)

    def mb(acc, m):
        loss, g = jax.value_and_grad(functools.partial(jtfm.loss_fn, cfg))(params, m)
        return jax.tree.map(lambda a, b: a + b.astype(jnp.float32), acc, g), loss

    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    grads, losses = jax.lax.scan(mb, zeros, sliced)
    return losses.mean(), jax.tree.map(lambda g: g / micro, grads)


@functools.cache
def ref_params(arch, prec):
    jcfg, _ = configs(arch, prec)
    rng = np.random.default_rng(len(arch) + 7)
    return perturb(jtfm.init_params(jcfg, jax.random.PRNGKey(1)), rng)


def port_params(arch, prec, **kw):
    """The reference's parameters as the port's (a copy: the port's step
    updates in place, and ``params_from_numpy`` shares numpy memory)."""
    _, tcfg = configs(arch, prec, **kw)
    return tcfg, ttfm.params_from_numpy(tcfg, jax.tree.map(np.copy, ref_params(arch, prec)),
                                        device="cpu")


def assert_close(got, want, tol, what, atol=None):
    """max|Δ| ≤ tol·max|want|, or ≤ ``atol`` where given."""
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    bound = atol if atol is not None else tol * np.abs(want).max()
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= bound, f"{what}: max|Δ| {err:.3e} > {bound:.3e}"


def assert_trees_close(got, want, tol, what, atol=None):
    for (name, g), w in zip(tree.flatten_with_paths(got), jax.tree.leaves(want), strict=True):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, name)
        assert_close(g, w, tol, f"{what} {name}", atol)


def unsettled(tcfg, params, tokens):
    """``unsettled_tokens`` of the port's router logits on ``tokens``."""
    stats = {}
    with torch.no_grad():
        ttfm.forward(tcfg, params, tokens, stats)
    return ttfm.unsettled_tokens(tcfg, stats["router_logits"], EPS)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro", ["1", "spec"])
@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_train_step_matches_reference(arch, prec, micro):
    spec = get_arch(arch)
    m = 1 if micro == "1" else spec.micro_batches
    jcfg, _ = configs(arch, prec)
    opt = spec.optim
    params = ref_params(arch, prec)
    batch = lm_batch(np.random.default_rng(len(arch)), jcfg.vocab, B, S)
    jp, jb = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch)
    new_p, _, metrics = jax.jit(jstep.make_lm_train_step(jcfg, opt, micro_batches=m))(
        jp, joptim.init_state(opt, jp), jb)

    tcfg, tp = port_params(arch, prec)
    tb = to_torch(batch)
    tol = TOL[prec]
    moe_mixed = arch in MOE_IDS and prec == "MIXED"
    if not moe_mixed:  # the MoE MIXED gradients: test_moe_mixed_gradients_on_settled_batches
        want_l, want_g = jax.jit(functools.partial(ref_grads, jcfg, m))(jp, jb)
        got_l, got_g = tstep.accumulated_grads(functools.partial(ttfm.loss_fn, tcfg), tp, tb, m,
                                               tstep._split_leading)
        assert_close(got_l, want_l, tol, "accumulated loss")
        assert_trees_close(got_g, want_g, tol, "gradient")
    tp, _, tm = tstep.make_lm_train_step(tcfg, opt, micro_batches=m)(
        tp, toptim.init_state(opt, tp), tb)
    assert_close(tm["loss"], metrics["loss"], tol, "step loss")
    if not moe_mixed:
        assert_close(tm["grad_norm"], metrics["grad_norm"], tol, "grad norm")
    assert_trees_close(tp, new_p, None, "updated param", atol=2 * opt.lr + 1e-6)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_moe_mixed_gradients_on_settled_batches(arch):
    """MIXED MoE gradients over the micro-batches that ``unsettled_tokens``
    marks no token of: the spec's ``micro_batches`` sequences of MOE_S
    tokens from each of MOE_BATCHES seeds (0, 1, ...); the settled ones
    (at least half) accumulated as one micro-batched step (a micro-batch a
    sequence, each routed alone) in both packages, the loss and every
    gradient held to 0.03."""
    spec = get_arch(arch)
    jcfg, _ = configs(arch, "MIXED")
    tcfg, tp = port_params(arch, "MIXED")
    seqs = [lm_batch(np.random.default_rng(seed), jcfg.vocab, spec.micro_batches, MOE_S)
            for seed in range(MOE_BATCHES)]
    seqs = [{k: v[i:i + 1] for k, v in b.items()} for b in seqs for i in range(spec.micro_batches)]
    held = [b for b in seqs if not bool(unsettled(tcfg, tp, to_torch(b)["tokens"]).any())]
    print(f"{arch}: {len(held)} of {len(seqs)} micro-batches settled and held")
    assert len(held) >= len(seqs) / 2, f"{arch}: only {len(held)} of {len(seqs)} settled"
    batch = {k: np.concatenate([b[k] for b in held]) for k in held[0]}
    want_l, want_g = jax.jit(functools.partial(ref_grads, jcfg, len(held)))(
        jax.tree.map(jnp.asarray, ref_params(arch, "MIXED")), jax.tree.map(jnp.asarray, batch))
    got_l, got_g = tstep.accumulated_grads(functools.partial(ttfm.loss_fn, tcfg), tp,
                                           to_torch(batch), len(held), tstep._split_leading)
    assert_close(got_l, want_l, TOL["MIXED"], "loss")
    assert_trees_close(got_g, want_g, TOL["MIXED"], "gradient")


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_remat_changes_no_gradient(arch, prec):
    """The gradients with each layer checkpointed equal those without, bit
    for bit; a checkpointed forward records its MoE statistics once."""
    tcfg, tp = port_params(arch, prec)
    assert tcfg.remat
    tb = to_torch(lm_batch(np.random.default_rng(5), tcfg.vocab, 2, S))
    on_l, on_g = tstep.loss_and_grads(functools.partial(ttfm.loss_fn, tcfg), tp, tb)
    off = dataclasses.replace(tcfg, remat=False)
    off_l, off_g = tstep.loss_and_grads(functools.partial(ttfm.loss_fn, off), tp, tb)
    assert torch.equal(on_l, off_l)
    for (name, a), b in zip(tree.flatten_with_paths(on_g), tree.leaves(off_g), strict=True):
        assert torch.equal(a, b), name
    if tcfg.moe:
        stats = {}
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
        logits = ttfm.forward(tcfg, tree.unflatten(tp, leaves), tb["tokens"], stats)
        torch.autograd.grad(logits.sum(), leaves)
        assert len(stats["router_logits"]) == tcfg.n_layers
        assert stats["assignments"] == tcfg.n_layers * tb["tokens"].numel() * tcfg.moe.top_k


# ---------------------------------------------------------------------------
# tests/test_archs_smoke.py:28, for the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_smoke(arch):
    spec = get_arch(arch)
    cfg = spec.make_reduced()
    params = ttfm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 64
    batch = to_torch(lm_batch(rng, cfg.vocab, b, s))
    logits = ttfm.forward(cfg, params, batch["tokens"])
    assert logits.shape == (b, s, cfg.vocab) and bool(torch.isfinite(logits).all())

    opt_cfg = dataclasses.replace(spec.optim, lr=1e-3)
    state = toptim.init_state(opt_cfg, params)
    step = tstep.make_lm_train_step(cfg, opt_cfg, micro_batches=2)
    new_p, _, metrics = step(params, state, batch)
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(new_p))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert float(metrics["loss"]) > 0

    cache = ttfm.init_cache(cfg, b, 32, device="cpu")
    cache, lg = ttfm.decode_step(cfg, new_p, cache, batch["tokens"][:, :1])
    assert lg.shape == (b, cfg.vocab) and bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's TestPreemptionResume, for the port
# ---------------------------------------------------------------------------


def tiny_setup():
    """phi3 reduced from the reference's PRNGKey(0) parameters, its AdamW,
    the step-keyed stream of (4, 32) tokens from ``default_rng(1000 + s)``."""
    spec = get_arch("phi3-mini-3.8b")
    cfg = spec.make_reduced()
    params = ttfm.params_from_numpy(
        cfg, jax.tree.map(np.array, ref_tiny_params()), device="cpu")
    opt = toptim.init_state(spec.optim, params)
    step = tstep.make_lm_train_step(cfg, spec.optim)

    def batch_for_step(s):
        return to_torch(lm_batch(np.random.default_rng(1000 + s), cfg.vocab, 4, 32))

    return params, opt, step, batch_for_step


@functools.cache
def ref_tiny_params():
    jcfg = jregistry.get_arch("phi3-mini-3.8b").make_reduced()
    return jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.PRNGKey(0)))


@functools.cache
def ref_tiny_losses():
    """The reference's uninterrupted 12 steps on the same stream."""
    spec = jregistry.get_arch("phi3-mini-3.8b")
    cfg = spec.make_reduced()
    params = jax.tree.map(jnp.asarray, ref_tiny_params())
    step = jax.jit(jstep.make_lm_train_step(cfg, spec.optim))

    def batches(s):
        return jax.tree.map(jnp.asarray, lm_batch(np.random.default_rng(1000 + s), cfg.vocab,
                                                  4, 32))

    _, _, res = jloop.run(step, params, joptim.init_state(spec.optim, params), batches,
                          jloop.LoopConfig(total_steps=12, ckpt_every=100, log_every=0))
    return res.losses


def test_resume_equals_uninterrupted(tmp_path):
    """A crash at step 7 and a resume from step 4's checkpoint end at the
    uninterrupted run's loss (rtol 1e-4, the reference's bar); the
    uninterrupted losses follow the reference's on the same stream
    (MIXED: within 0.03 of each)."""
    cfg_l = tloop.LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "a"),
                             log_every=0)
    params, opt, step, batches = tiny_setup()
    _, _, res_a = tloop.run(step, params, opt, batches, cfg_l)
    np.testing.assert_allclose(res_a.losses, ref_tiny_losses(), rtol=TOL["MIXED"])

    cfg_b = tloop.LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "b"),
                             log_every=0, crash_at_step=7)
    params2, opt2, step2, batches2 = tiny_setup()
    with pytest.raises(tloop.SimulatedPreemption):
        tloop.run(step2, params2, opt2, batches2, cfg_b)
    assert tckpt.all_steps(str(tmp_path / "b")) == [4]
    cfg_b2 = dataclasses.replace(cfg_b, crash_at_step=None)
    params3, opt3, step3, batches3 = tiny_setup()
    _, _, res_b = tloop.run(step3, params3, opt3, batches3, cfg_b2)
    assert res_b.resumed_from == 4
    np.testing.assert_allclose(res_a.losses[-1], res_b.losses[-1], rtol=1e-4)


def test_straggler_watchdog_flags_slow_step():
    """A step that sleeps 1 s at call 9 is flagged, in the port's loop as
    in the reference's, on the same stream."""
    params, opt, step, batches = tiny_setup()
    calls = itertools.count()

    def slow_step(p, o, b):
        if next(calls) == 9:
            time.sleep(1.0)
        return step(p, o, b)

    cfg_l = tloop.LoopConfig(total_steps=12, ckpt_every=100, ckpt_dir=None, log_every=0,
                             straggler_factor=3.0)
    _, _, res = tloop.run(slow_step, params, opt, batches, cfg_l)
    assert any(e["step"] == 9 for e in res.straggler_events), res.straggler_events
    np.testing.assert_allclose(res.losses, ref_tiny_losses(), rtol=TOL["MIXED"])


# ---------------------------------------------------------------------------
# launch/train.py's LM branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_IDS)
def test_make_batch_fn_lm_equals_reference(arch):
    """Tokens and labels (the tokens rolled by −1) equal the reference's
    bit for bit at steps 0 and 5."""
    spec, jspec = get_arch(arch), jregistry.get_arch(arch)
    cfg, jcfg = spec.make_reduced(), jspec.make_reduced()
    got = tlaunch.make_batch_fn(spec, cfg, 4, 24, "cpu")
    want = jlaunch.make_batch_fn(jspec, jcfg, 4, 24)
    for s in (0, 5):
        g, w = got(s), want(s)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert torch.equal(g["labels"], g["tokens"].roll(-1, dims=1))


def test_launch_train_lm_on_cpu(tmp_path, capsys):
    """``main`` trains phi3's reduced config on the CPU with checkpoints,
    prints its ``[done]`` line, and a second run resumes."""
    argv = ["--arch", "phi3-mini-3.8b", "--steps", "6", "--batch-size", "4", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--device", "cpu"]
    res = tlaunch.main(argv)
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert res.checkpoints_written == 2
    assert "[done] phi3-mini-3.8b: loss" in capsys.readouterr().out
    res2 = tlaunch.main([*argv[:3], "8", *argv[4:]])
    assert res2.resumed_from == 6 and len(res2.losses) == 2
