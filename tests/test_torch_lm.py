"""The port's LM family (``models/transformer.py``, the prefill and decode
steps, the five LM configs and ``lm_shapes``) against the reference on the
CPU.

The reference's ``init_params`` (perturbed, so that the norm weights are
not their constant ones) crosses as numpy arrays through
``params_from_numpy``; both packages run the same numpy tokens. Each LM
arch runs at its reduced config under ``FP32`` and under ``MIXED``:
``forward`` at B = 2, S = 96 (a chunk multiple only for mixtral-smoke,
whose window of 32 makes its attention banded), ``forward_last`` through
``make_lm_prefill_step``, ``loss_fn``, and 40 tokens through
``make_lm_decode_step`` against a cache of 36 rows: past its end for the
full-attention archs (the last slot overwritten), wrapped for mixtral-smoke
(a rolling cache of 32).

Tolerances, as |Δ| ≤ tol·max|ref| over an output:

- ``FP32``: 1e-5. The two packages sum the same f32 products in other
  orders; the largest difference seen is 6.9e-7 of the logits' scale.
- ``MIXED``: 0.03. bf16 keeps 8 significant bits (a step of 2^-8 ≈ 0.4%).
  The dense archs agree within 4.1e-4; the MoE archs within 1.41% on the
  tokens held, where each expert's N(0, 1)/√d weights carry a rounding
  step of its input to the output.

Tie rules:

- The router picks the top k of E f32 logits, the lower expert first on a
  tie (``lax.top_k``); the port sorts stably. Under ``MIXED`` the two
  packages' bf16 products differ by a rounding step here and there, which
  moves a router logit by up to ≈ 4e-3 on these configs (their logits
  have a spread of ≈ 0.2). A token whose k-th largest reference logit lies
  within ``EPS`` = 0.01 of the next, in some layer, may pick other
  experts, and its row then differs by half the logits' scale; such a
  move can also push a later token's rank across the capacity (kimi-smoke
  decodes at C = 1). ``unsettled_tokens`` marks both from the reference's
  router logits (recorded through ``jax.debug.callback``); they are
  counted (at most half) and left out, and every other token is held to
  0.03. Under ``FP32`` every token is held, and the port's own routing
  marks the same tokens as the reference's.
- Decode tokens follow the same rule, step by step; the loss, a mean over
  all 192 tokens, is held whole.
- ``moe_ffn`` on the same bf16 input in both: the kept set must be equal
  for every settled token, and the dropped count where all are settled.
"""
import dataclasses
import functools
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.build import build_cell  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

LM_IDS = sorted(a for a, spec in jregistry.ARCHS.items() if spec.family == "lm")
MOE_IDS = ("kimi-k2-1t-a32b", "mixtral-8x7b")
TOL = {"FP32": 1e-5, "MIXED": 0.03}
EPS = 0.01  # router logit gap below which a MIXED token may route differently
B, S = 2, 96
DECODE_STEPS, DECODE_MAX_LEN = 40, 36


def perturb(tree, rng):
    """Each leaf plus 0.3 of its spread (0.1 for a constant leaf) times
    N(0, 1), as numpy."""
    def one(a):
        a = np.asarray(a)
        s = float(a.std()) or 0.1
        return (a + 0.3 * s * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(one, tree)


def configs(arch, prec):
    jcfg = dataclasses.replace(jregistry.get_arch(arch).make_reduced(),
                               precision=getattr(jcommon, prec))
    tcfg = dataclasses.replace(get_arch(arch).make_reduced(), precision=getattr(tcommon, prec))
    return jcfg, tcfg


def recording_moe(calls):
    """The reference's ``moe_ffn``, which also hands its f32 router logits
    to ``calls``, in call order."""
    orig = jtfm.moe_ffn

    def moe_ffn(cfg, x, p):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), logits, ordered=True)
        return orig(cfg, x, p)

    return moe_ffn


def unsettled(tcfg, calls, shape):
    """``unsettled_tokens`` of the reference's router logits (none without
    MoE)."""
    if not calls:
        return np.zeros(shape, bool)
    return ttfm.unsettled_tokens(tcfg, [torch.from_numpy(a) for a in calls], EPS) \
        .numpy().reshape(shape)


@functools.cache
def case(arch, prec):
    """The reference's results on one reduced config, with the numpy
    parameters and inputs they came from."""
    jcfg, tcfg = configs(arch, prec)
    rng = np.random.default_rng(len(arch))
    params = perturb(jtfm.init_params(jcfg, jax.random.PRNGKey(1)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    dec_tokens = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtfm, "moe_ffn", recording_moe(calls))
        logits = np.asarray(jax.jit(functools.partial(jtfm.forward, jcfg))(jp, tokens))
        jax.effects_barrier()
        unsure = unsettled(tcfg, calls, (B, S))
        last = np.asarray(jax.jit(functools.partial(jtfm.forward_last, jcfg))(jp, tokens))
        loss = float(jax.jit(functools.partial(jtfm.loss_fn, jcfg))(
            jp, {"tokens": tokens, "labels": labels}))
        step = jax.jit(functools.partial(jtfm.decode_step, jcfg))
        cache = jtfm.init_cache(jcfg, B, DECODE_MAX_LEN)
        dec_logits, dec_unsure = [], []
        for i in range(DECODE_STEPS):
            calls.clear()
            cache, lg = step(jp, cache, dec_tokens[i])
            jax.effects_barrier()
            dec_logits.append(np.asarray(lg))
            dec_unsure.append(unsettled(tcfg, calls, (B,)))
    return SimpleNamespace(params=params, tokens=tokens, labels=labels, dec_tokens=dec_tokens,
                           logits=logits, unsure=unsure, last=last, loss=loss,
                           dec_logits=np.stack(dec_logits), dec_unsure=np.stack(dec_unsure),
                           cache_len=int(cache["len"]))


def port(arch, prec):
    _, tcfg = configs(arch, prec)
    c = case(arch, prec)
    # params_from_numpy shares numpy memory: copy so no test can change the case
    params = jax.tree.map(np.copy, c.params)
    return tcfg, ttfm.params_from_numpy(tcfg, params, device="cpu"), c


def held(unsure, prec):
    """Tokens held to the tolerance: all under FP32; under MIXED the
    settled ones (at least half)."""
    keep = ~unsure if prec == "MIXED" else np.ones(unsure.shape, bool)
    assert keep.mean() >= 0.5, f"{(~keep).sum()} of {keep.size} tokens unsettled"
    return keep


def assert_close(got, want, tol, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if rows is not None:
        err = err[rows]
    assert err.max() <= tol * scale, f"max|Δ| {err.max():.3e} > {tol}·{scale:.3e}"


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------


def test_lm_shapes_equal_the_reference():
    assert [dataclasses.asdict(c) for c in tbase.LM_SHAPES] == \
        [dataclasses.asdict(c) for c in jbase.LM_SHAPES]
    for window in (None, 4096):
        assert [dataclasses.asdict(c) for c in tbase.lm_shapes(window)] == \
            [dataclasses.asdict(c) for c in jbase.lm_shapes(window)]


def _fields(cfg):
    """A config's fields, dtypes by name (the two packages' dtype objects
    differ)."""
    out = dataclasses.asdict(cfg)
    out["precision"] = {k: str(v).rsplit(".", 1)[-1].strip("'>")
                        for k, v in dataclasses.asdict(cfg.precision).items()}
    return out


@pytest.mark.parametrize("arch", LM_IDS)
def test_configs_and_param_counts_equal_the_reference(arch):
    """Full and reduced configs field for field; ``param_count``,
    ``active_param_count`` and ``q_per_kv`` of the full one exactly; the
    reduced parameters' shapes key for key."""
    spec, ref = get_arch(arch), jregistry.get_arch(arch)
    for make in ("make_config", "make_reduced"):
        got, want = getattr(spec, make)(), getattr(ref, make)()
        assert _fields(got) == _fields(want)
    cfg, jcfg = spec.make_config(), ref.make_config()
    assert (cfg.param_count, cfg.active_param_count, cfg.q_per_kv) == \
        (jcfg.param_count, jcfg.active_param_count, jcfg.q_per_kv)
    assert tcommon.count_params(ttfm.abstract_params(cfg)) == cfg.param_count
    rcfg, rjcfg = spec.make_reduced(), ref.make_reduced()
    want = jax.tree.map(lambda a: tuple(a.shape), jtfm.abstract_params(rjcfg))
    got = jax.tree.map(lambda t: tuple(t.shape), ttfm.abstract_params(rcfg))
    assert got == want


@pytest.mark.parametrize("arch", LM_IDS)
def test_model_flops_equal_the_reference_build_cell(arch):
    spec = get_arch(arch)
    cfg = spec.make_config()
    mesh = make_local_mesh(1, 1)
    for cell in spec.shapes:
        if cell.skipped or cell.kind == "train":  # train: the training slice
            continue
        want = build_cell(jregistry.get_arch(arch), cell, mesh).meta["model_flops"]
        assert ttfm.model_flops(cfg, cell) == want


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b"])
def test_init_params_shapes_and_scales(arch):
    """The port's draws at the reference's scales: each leaf's shape and
    dtype as the reference's, its spread within 10% of the reference's
    (the norms ones)."""
    spec = get_arch(arch)
    cfg = spec.make_reduced()
    got = ttfm.init_params(cfg, seed=3, device="cpu")
    want = jtfm.init_params(jregistry.get_arch(arch).make_reduced(), jax.random.PRNGKey(3))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0])
    assert set(flat_g) == set(flat_w)
    for path, w in flat_w.items():
        g = flat_g[path]
        assert g.shape == w.shape and g.dtype == np.asarray(w).dtype, path
        if float(np.std(w)) == 0.0:
            assert (g == 1).all(), path
        else:
            assert abs(float(g.std()) / float(np.std(w)) - 1) < 0.1, path


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = get_arch("phi3-mini-3.8b").make_reduced()
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jregistry.get_arch("phi3-mini-3.8b").make_reduced(), jax.random.PRNGKey(0)))
    ttfm.params_from_numpy(cfg, tree, device="cpu")
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head: shape"):
        ttfm.params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "ln2"})
    with pytest.raises(ValueError, match="parameters layers/"):
        ttfm.params_from_numpy(cfg, bad, device="cpu")


def test_sharding_fields_raise():
    """The sharding fields no longer raise: they are layout hints, and a
    config that sets one computes what one without computes, bit for bit."""
    cfg = get_arch("mixtral-8x7b").make_reduced()
    params = ttfm.init_params(cfg, device="cpu")
    tokens = torch.arange(8, dtype=torch.int32)[None] * 37 % cfg.vocab
    want = ttfm.forward(cfg, params, tokens)
    _, want_step = ttfm.decode_step(cfg, params, ttfm.init_cache(cfg, 1, 8, device="cpu"),
                                    tokens[:, :1])
    for field, value in (("act_dp_axes", ("data",)), ("act_seq_axis", "model"),
                         ("moe_expert_axis", "model"), ("moe_capacity_axes", ("data",)),
                         ("moe_ff_axis", "model")):
        sharded = dataclasses.replace(cfg, **{field: value})
        assert torch.equal(ttfm.forward(sharded, params, tokens), want)
        _, got = ttfm.decode_step(sharded, params, ttfm.init_cache(sharded, 1, 8, device="cpu"),
                                  tokens[:, :1])
        assert torch.equal(got, want_step)


def test_cache_shapes_equal_the_reference():
    for arch in LM_IDS:
        jcfg, tcfg = configs(arch, "MIXED")
        for max_len in (8, 36, 100):
            want = jtfm.abstract_cache(jcfg, 3, max_len)
            got = ttfm.abstract_cache(tcfg, 3, max_len)
            made = ttfm.init_cache(tcfg, 3, max_len, device="cpu")
            for key in ("k", "v", "len"):
                assert tuple(got[key].shape) == tuple(made[key].shape) == want[key].shape
                assert got[key].dtype == made[key].dtype
            assert made["k"].dtype == torch.bfloat16 and made["len"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 90, 6, 16)).astype(np.float32)
    pos = (np.arange(90)[None] + np.array([[0], [524_200]])).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jtfm.rope(jx, jnp.asarray(pos), theta).astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ttfm.rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    # the angles reach 5e5 rad: cos/sin of f32 arguments that large differ
    # between the two libraries by a few ulps of the argument
    assert_close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 0.01)


ATTN_CASES = {"full": None, "banded": 24, "band_clipped": 80, "window_above_s": 128}


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("kind", sorted(ATTN_CASES))
def test_attention(kind, prec):
    """q-chunked attention at S = 90 (chunks of 32, padded to 96): full
    causal, banded (window 24: bands of 56 keys), a window of 80 (a band of
    all 96 keys, its start clipped to 0) and a window above S (the full
    path)."""
    jcfg = jtfm.TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=6, n_kv_heads=2,
                                  d_head=16, d_ff=64, vocab=64, q_chunk=32,
                                  sliding_window=ATTN_CASES[kind],
                                  precision=getattr(jcommon, prec))
    tcfg = ttfm.TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=6, n_kv_heads=2,
                                  d_head=16, d_ff=64, vocab=64, q_chunk=32,
                                  sliding_window=ATTN_CASES[kind],
                                  precision=getattr(tcommon, prec))
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 90, 2, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 90, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 90, 2, 16)).astype(np.float32)
    cdt = jcfg.precision.compute_dtype
    jq, jk, jv = (jnp.asarray(a).astype(cdt) for a in (q, k, v))
    want = np.asarray(jax.jit(functools.partial(jtfm.attention, jcfg))(jq, jk, jv)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(tcfg.precision.compute_dtype) for a in (jq, jk, jv))
    got = ttfm.attention(tcfg, tq, tk, tv)
    assert got.shape == (2, 90, 2, 3, 16) and got.dtype == tq.dtype
    assert_close(got.float().numpy(), want, TOL[prec])


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_swiglu(prec):
    rng = np.random.default_rng(7)
    cdt = getattr(jcommon, prec).compute_dtype
    x, w1, w3, w2 = (jnp.asarray(rng.normal(size=s).astype(np.float32) / math.sqrt(s[-2]
                                 if len(s) == 2 else 1)).astype(cdt)
                     for s in ((2, 37, 48), (48, 80), (48, 80), (80, 48)))
    want = np.asarray(jtfm.swiglu(x, w1, w3, w2).astype(jnp.float32))
    tdt = getattr(tcommon, prec).compute_dtype
    got = ttfm.swiglu(*(torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt)
                        for a in (x, w1, w3, w2)))
    assert_close(got.float().numpy(), want, TOL[prec])


def test_rank_within_expert():
    ids = np.random.default_rng(8).integers(0, 7, (300,)).astype(np.int32)
    want = np.asarray(jtfm._rank_within_expert(jnp.asarray(ids), 7))
    got = ttfm._rank_within_expert(torch.from_numpy(ids).long(), 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_moe_ffn_drops_the_reference_tokens(prec):
    """At capacity factor 0.5 (C = 8 of 128 assignments over 8 experts)
    about half the assignments drop: the kept set, the dropped count and
    each held token's output equal the reference's."""
    moe = dict(n_experts=8, top_k=2, d_ff_expert=48, capacity_factor=0.5)
    kw = dict(name="m", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_head=16, d_ff=48,
              vocab=64)
    jcfg = jtfm.TransformerConfig(**kw, moe=jtfm.MoEConfig(**moe),
                                  precision=getattr(jcommon, prec))
    tcfg = ttfm.TransformerConfig(**kw, moe=ttfm.MoEConfig(**moe),
                                  precision=getattr(tcommon, prec))
    lp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jtfm.init_params(jcfg, jax.random.PRNGKey(4))["layers"]["ffn"])
    cdt = jcfg.precision.compute_dtype
    x = jnp.asarray(np.random.default_rng(9).normal(size=(64, 32)).astype(np.float32)).astype(cdt)
    want = np.asarray(jtfm.moe_ffn(jcfg, x, jax.tree.map(jnp.asarray, lp)).astype(jnp.float32))
    # the reference's routing, from its own helpers, on its router logits
    logits = x.astype(jnp.float32) @ jnp.asarray(lp["router"])
    ref_keep = np.asarray(jtfm._rank_within_expert(jax.lax.top_k(logits, 2)[1].reshape(-1), 8)
                          < 8).reshape(64, 2)

    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tcfg.precision.compute_dtype)
    stats = {}
    got = ttfm.moe_ffn(tcfg, tx, {k: torch.from_numpy(v) for k, v in lp.items()}, stats)
    assert got.dtype == tx.dtype and stats["assignments"] == 128
    # the same input, so the same router logits up to the f32 sum order
    ours = stats["router_logits"][0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(logits), rtol=1e-6, atol=1e-6)
    top_e = torch.sort(ours, dim=1, descending=True, stable=True)[1][:, :2]
    keep = (ttfm._rank_within_expert(top_e.reshape(-1), 8) < 8).view(64, 2).numpy()
    rows = held(unsettled(tcfg, [np.asarray(logits)], (64,)), prec)
    np.testing.assert_array_equal(keep[rows], ref_keep[rows])
    dropped = int((~ref_keep).sum())
    assert 0 < dropped < ref_keep.size
    if rows.all():
        assert int(stats["dropped"]) == dropped
    assert_close(got.float().numpy(), want, TOL[prec], rows)
    # an all-dropped token gives exactly 0 in both
    gone = ~ref_keep.any(1) & rows
    assert (got.float().numpy()[gone] == 0).all() and (want[gone] == 0).all()


def test_moe_router_tie_picks_the_lower_expert():
    """Experts 1 and 3 (and 4 and 6) share a router column, so every token
    ties between them: the reference's ``lax.top_k`` keeps the lower one,
    and so must the port (the experts' weights differ, so the outputs show
    it)."""
    moe = dict(n_experts=8, top_k=3, d_ff_expert=24)
    kw = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_head=8, d_ff=24,
              vocab=64, precision=jcommon.FP32)
    jcfg = jtfm.TransformerConfig(**kw, moe=jtfm.MoEConfig(**moe))
    tcfg = ttfm.TransformerConfig(**dict(kw, precision=tcommon.FP32), moe=ttfm.MoEConfig(**moe))
    lp = jax.tree.map(lambda a: np.array(a[0]),
                      jtfm.init_params(jcfg, jax.random.PRNGKey(5))["layers"]["ffn"])
    lp["router"][:, 3] = lp["router"][:, 1]
    lp["router"][:, 6] = lp["router"][:, 4]
    x = np.random.default_rng(10).normal(size=(24, 16)).astype(np.float32)
    want = np.asarray(jtfm.moe_ffn(jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, lp)))
    got = ttfm.moe_ffn(tcfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()})
    assert_close(got.numpy(), want, TOL["FP32"])


# ---------------------------------------------------------------------------
# the model and its steps, at each reduced config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_forward_equals_the_reference(arch, prec):
    tcfg, params, c = port(arch, prec)
    stats = {}
    got = ttfm.forward(tcfg, params, torch.from_numpy(c.tokens), stats)
    assert got.shape == (B, S, tcfg.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), c.logits, TOL[prec], held(c.unsure, prec))
    if arch in MOE_IDS:
        assert stats["assignments"] == tcfg.n_layers * B * S * tcfg.moe.top_k
        assert len(stats["router_logits"]) == tcfg.n_layers
        if prec == "FP32":  # the port's routing is the reference's
            ours = unsettled(tcfg, [a.numpy() for a in stats["router_logits"]], (B, S))
            np.testing.assert_array_equal(ours, c.unsure)


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_prefill_step_equals_the_reference_forward_last(arch, prec):
    tcfg, params, c = port(arch, prec)
    got = tstep.make_lm_prefill_step(tcfg)(params, {"tokens": torch.from_numpy(c.tokens)})
    assert got.shape == (B, tcfg.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), c.last, TOL[prec], held(c.unsure, prec)[:, -1])
    assert_close(c.last, c.logits[:, -1], TOL[prec])


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_loss_equals_the_reference(arch, prec):
    tcfg, params, c = port(arch, prec)
    got = ttfm.loss_fn(tcfg, params, {"tokens": torch.from_numpy(c.tokens),
                                      "labels": torch.from_numpy(c.labels)})
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - c.loss) <= TOL[prec] * abs(c.loss)


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_decode_steps_equal_the_reference(arch, prec):
    """40 tokens from an empty cache of 36 rows, each step's logits held
    (MIXED: but tokens near a router tie); the cache is updated in place
    and its length counts the tokens."""
    tcfg, params, c = port(arch, prec)
    cache = ttfm.init_cache(tcfg, B, DECODE_MAX_LEN, device="cpu")
    k_buf = cache["k"]
    step = tstep.make_lm_decode_step(tcfg)
    got = []
    for i in range(DECODE_STEPS):
        out, lg = step(params, cache, {"tokens": torch.from_numpy(c.dec_tokens[i])})
        assert out is cache and cache["k"] is k_buf
        got.append(lg.numpy())
    got = np.stack(got)
    assert got.shape == (DECODE_STEPS, B, tcfg.vocab)
    assert int(cache["len"]) == c.cache_len == DECODE_STEPS
    assert_close(got, c.dec_logits, TOL[prec], held(c.dec_unsure, prec))
