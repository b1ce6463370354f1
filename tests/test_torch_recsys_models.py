"""The port's dlrm-rm2, xdeepfm and bert4rec models, ``embedding_bag`` and
the ``models/common.py`` helpers against the reference on the CPU.

The reference's ``init_params`` (perturbed, so that biases, norm weights
and bert4rec's stacked blocks are not their constant inits) crosses as
numpy arrays through ``params_from_numpy``; both packages run the same
numpy inputs. Each kind runs at its reduced config and at its full widths
with a cut vocabulary (V = 1,000; bert4rec ``n_items`` = 2,000), under
``FP32`` and under ``MIXED``.

Tolerances, as |Δ| ≤ tol·max|ref| over an output:

- ``FP32``: 1e-5. The two packages sum the same f32 products in other
  orders; the largest difference seen is 6e-7 of the output's scale.
- ``MIXED``: 0.03. bf16 keeps 8 significant bits (a step of 2^-8 ≈ 0.4%).
  The reference rounds each op of its tanh GELU to bf16, where
  ``F.gelu(approximate="tanh")`` rounds once (40% of bf16 GELU values
  differ by a step), and the difference runs on through the encoder: the
  largest seen is 1.03% of bert4rec's scale; dlrm and xdeepfm agree
  exactly. Three times that margin.

Retrieval: sq-dists rtol 1e-5, atol 1e-6 and ids equal except at
near-ties, as in ``test_torch_recsys.py``. Where the user tower itself runs
in bf16 (bert4rec under ``MIXED``), the reference's head scores the port's
user vectors, so the head is held to f32 tolerance and the tower to the
bf16 one above. ``bert4rec_serve_topk`` under ``MIXED`` must choose items
whose reference scores reach the reference's k-th score less the
tolerance.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import bert4rec as jbert  # noqa: E402
from repro.configs import dlrm_rm2 as jdlrm  # noqa: E402
from repro.configs import fm as jfm  # noqa: E402
from repro.configs import xdeepfm as jxdeepfm  # noqa: E402
from repro.launch.build import build_cell  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro_torch.configs import bert4rec as tbert  # noqa: E402
from repro_torch.configs import dlrm_rm2 as tdlrm  # noqa: E402
from repro_torch.configs import fm as tfm  # noqa: E402
from repro_torch.configs import xdeepfm as txdeepfm  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.graph_ops import largest_k  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

MODULES = {"dlrm-rm2": (jdlrm, tdlrm, {"vocab_per_field": 1000}),
           "xdeepfm": (jxdeepfm, txdeepfm, {"vocab_per_field": 1000}),
           "bert4rec": (jbert, tbert, {"n_items": 2000})}
ALL_MODULES = {**MODULES, "fm": (jfm, tfm, {"vocab_per_field": 1000})}
TOL = {"FP32": 1e-5, "MIXED": 0.03}
RTOL, ATOL = 1e-5, 1e-6
B, N_ITEMS, K = 6, 960, 10


def perturb(tree, rng):
    """Each leaf plus 0.3 of its spread (0.1 for a constant leaf) times
    N(0, 1), as numpy."""
    def one(a):
        a = np.asarray(a)
        s = float(a.std()) or 0.1
        return (a + 0.3 * s * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(one, tree)


def configs(arch, size, prec):
    jmod, tmod, cut = MODULES[arch]
    if size == "reduced":
        jcfg, tcfg = jmod.make_reduced(), tmod.make_reduced()
    else:
        jcfg = dataclasses.replace(jmod.make_config(), **cut)
        tcfg = dataclasses.replace(tmod.make_config(), **cut)
    return (dataclasses.replace(jcfg, precision=getattr(jcommon, prec)),
            dataclasses.replace(tcfg, precision=getattr(tcommon, prec)))


def make_batch(cfg, rng, b=B, s=None):
    """Ids over [−V, V) (negative ids wrap), dense N(0, 1), attribute
    targets in [0, 3)."""
    if cfg.kind == "bert4rec":
        n = cfg.n_items
        batch = {"items": rng.integers(-n, n, (b, s or cfg.seq_len)).astype(np.int32)}
    else:
        v = cfg.vocab_per_field
        batch = {"sparse": rng.integers(-v, v, (b, cfg.n_sparse)).astype(np.int32)}
        if cfg.n_dense:
            batch["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    batch["query_attrs"] = rng.integers(0, 3, (b, cfg.n_attr_dims)).astype(np.int32)
    return batch


CASES = [(a, s, p) for a in MODULES for s in ("reduced", "full") for p in ("FP32", "MIXED")]


@functools.lru_cache(maxsize=None)
def build_case(arch, size, prec):
    """(arch, precision, reference cfg, port cfg, reference params (numpy),
    port params, batch, items)."""
    jcfg, tcfg = configs(arch, size, prec)
    rng = np.random.default_rng(CASES.index((arch, size, prec)))
    jp = perturb(jrecsys.init_params(jcfg, jax.random.PRNGKey(0)), rng)
    tp = trecsys.params_from_numpy(tcfg, jp, "cpu")
    batch = make_batch(tcfg, rng)
    d = tcfg.embed_dim
    items = {"item_embs": rng.normal(size=(N_ITEMS, d)).astype(np.float32),
             "item_attrs": rng.integers(0, 3, (N_ITEMS, tcfg.n_attr_dims)).astype(np.int32)}
    return arch, prec, jcfg, tcfg, jp, tp, batch, items


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request):
    return build_case(*request.param)


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close_scaled(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: max|Δ| {err:.3e}"


def assert_topk_match(jd, ji, td, ti, rtol=RTOL, atol=ATOL):
    """Values allclose; ids equal except at near-ties."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=atol)
    for r in range(jd.shape[0]):
        tie = atol + rtol * np.abs(jd[r])
        for p in np.flatnonzero(ji[r] != ti[r]):
            near = np.abs(jd[r] - jd[r, p]) <= 2 * tie[p]
            near[p] = False
            assert near.any(), f"row {r} slot {p}: id {ti[r, p]} != {ji[r, p]}, no near-tie"


def torch_dtype_name(t):
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# The models against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference(case):
    """Logits of the serve step, in the reference's dtype (dlrm returns the
    compute dtype; bert4rec (B, S, n_items) f32)."""
    arch, prec, jcfg, tcfg, jp, tp, batch, _ = case
    want = jrecsys.forward(jcfg, jp, jbatch(batch))
    got = tstep.make_recsys_serve_step(tcfg)(tp, batch)
    assert torch_dtype_name(got) == str(want.dtype)
    assert_close_scaled(got, want.astype(jnp.float32), TOL[prec], "logits")


def test_user_tower_matches_reference(case):
    arch, prec, jcfg, tcfg, jp, tp, batch, _ = case
    want = np.asarray(jrecsys.user_tower(jcfg, jp, jbatch(batch)))
    got = trecsys.user_tower(tcfg, tp, batch)
    assert got.dtype == torch.float32
    assert_close_scaled(got, want, TOL[prec], "user vectors")


@pytest.mark.parametrize("shards", [1, 4])
def test_retrieval_step_matches_reference(case, shards):
    arch, prec, jcfg, tcfg, jp, tp, batch, items = case
    full = {**batch, **items}
    td, ti = tstep.make_recsys_retrieval_step(tcfg, k=K, topk_shards=shards)(tp, full)
    if tcfg.kind == "bert4rec" and prec == "MIXED":  # a bf16 tower: the head on the port's
        u = trecsys.user_tower(tcfg, tp, batch).numpy()
        jd, ji = jrecsys.hybrid_retrieval_topk(
            jnp.asarray(u), jnp.asarray(batch["query_attrs"]), jnp.asarray(items["item_embs"]),
            jnp.asarray(items["item_attrs"]), K, topk_shards=shards)
    else:
        jd, ji = jrecsys.retrieval_step(
            jcfg, jp, jbatch(batch), jnp.asarray(items["item_embs"]),
            jnp.asarray(items["item_attrs"]), k=K, topk_shards=shards)
    assert_topk_match(jd, ji, td, ti)
    one_d, one_i = tstep.make_recsys_retrieval_step(tcfg, k=K)(tp, full)
    assert torch.equal(td, one_d) and torch.equal(ti, one_i)  # the merge is exact


@pytest.mark.parametrize("size,prec", [c[1:] for c in CASES if c[0] == "bert4rec"])
def test_bert4rec_serve_topk_matches_reference(size, prec):
    arch, prec, jcfg, tcfg, jp, tp, batch, _ = build_case("bert4rec", size, prec)
    k = 20
    td, ti = trecsys.bert4rec_serve_topk(tcfg, tp, batch["items"], k=k, batch_chunk=4)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32 and ti.shape == (B, k)
    jd, ji = jrecsys.bert4rec_serve_topk(jcfg, jp, jnp.asarray(batch["items"]), k=k,
                                         batch_chunk=4)
    if prec == "FP32":
        assert_topk_match(jd, ji, td, ti, rtol=1e-5, atol=1e-5)
        return
    # bf16 encodings: every chosen item reaches the reference's k-th score
    # less the tolerance, and its score matches the reference's for it
    ref = np.asarray(jrecsys.forward(jcfg, jp, jbatch(batch)))[:, -1]  # (B, n_items)
    tol = TOL[prec] * float(np.abs(ref).max())
    chosen = np.take_along_axis(ref, ti.numpy().astype(np.int64), 1)
    assert np.all(chosen >= np.asarray(jd)[:, -1:] - tol)
    assert np.all(np.abs(chosen - td.numpy()) <= tol)
    assert all(len(set(r)) == k for r in ti.numpy().tolist())


def test_bert4rec_serve_topk_ids_do_not_depend_on_the_chunk():
    """Mirrors the reference's own chunking test (10 histories, k = 5,
    chunks of 4 and 16), plus the chunk equal to the batch."""
    cfg = tbert.make_reduced()
    jp = jrecsys.init_params(jbert.make_reduced(), jax.random.PRNGKey(0))
    tp = trecsys.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    items = np.random.default_rng(1).integers(0, cfg.n_items, (10, cfg.seq_len)).astype(np.int32)
    outs = [trecsys.bert4rec_serve_topk(cfg, tp, items, k=5, batch_chunk=c) for c in (4, 16, 10)]
    for s, i in outs[1:]:
        assert torch.equal(i, outs[0][1]) and torch.equal(s, outs[0][0])
    _, ji = jrecsys.bert4rec_serve_topk(jbert.make_reduced(), jp, jnp.asarray(items), k=5,
                                        batch_chunk=4)
    assert np.array_equal(np.asarray(ji), outs[0][1].numpy())


def test_bert4rec_short_sequences_and_bounds():
    """A history shorter than seq_len takes the first position embeddings,
    as the reference does; a longer one raises."""
    jcfg, tcfg = configs("bert4rec", "reduced", "FP32")
    rng = np.random.default_rng(3)
    jp = perturb(jrecsys.init_params(jcfg, jax.random.PRNGKey(0)), rng)
    tp = trecsys.params_from_numpy(tcfg, jp, "cpu")
    batch = make_batch(tcfg, rng, b=3, s=tcfg.seq_len - 5)
    want = np.asarray(jrecsys.user_tower(jcfg, jp, jbatch(batch)))
    assert_close_scaled(trecsys.user_tower(tcfg, tp, batch), want, TOL["FP32"])
    with pytest.raises(ValueError, match="longer than seq_len"):
        trecsys.user_tower(tcfg, tp, make_batch(tcfg, rng, b=2, s=tcfg.seq_len + 1))
    bad = make_batch(tcfg, rng, b=2)
    bad["items"][1, 3] = tcfg.n_items
    with pytest.raises(IndexError):
        trecsys.bert4rec_serve_topk(tcfg, tp, bad["items"], k=3)


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_cin_row_blocks_equal_the_unblocked_product(prec):
    """The xdeepfm CIN in row blocks (of 1, 3 and the default) against one
    block over the whole batch, at the full widths: rows are independent,
    so only a product's rounding may differ (the tolerance above)."""
    jcfg, tcfg = configs("xdeepfm", "full", prec)
    rng = np.random.default_rng(5)
    tp = trecsys.params_from_numpy(
        tcfg, perturb(jrecsys.init_params(jcfg, jax.random.PRNGKey(1)), rng), "cpu")
    emb = trecsys.embedding_lookup(tp["tables"], make_batch(tcfg, rng, b=7)["sparse"])
    emb = emb.to(tcfg.precision.compute_dtype)
    whole = trecsys._cin(tcfg, tp, emb, row_block=7)
    assert whole.shape == (7, sum(tcfg.cin_layers)) and whole.dtype == emb.dtype
    for rows in (1, 3, None):
        assert_close_scaled(trecsys._cin(tcfg, tp, emb, row_block=rows), whole.float(),
                            TOL[prec], f"row_block={rows}")


def test_cin_default_block_bounds_the_serve_bulk_product():
    cfg = txdeepfm.make_config()
    widest = max(cfg.n_sparse, *cfg.cin_layers) * cfg.n_sparse * cfg.embed_dim
    rows = trecsys.CIN_BLOCK_ELEMS // widest
    assert rows == 6882 and rows * widest * 2 <= 2**30  # 1 GiB of bf16 a block
    assert 262_144 * widest * 2 / 1e9 > 40  # the reference's unblocked product


# ---------------------------------------------------------------------------
# Parameters, configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ALL_MODULES))
def test_param_count_on_meta_equals_reference(arch):
    jmod, tmod, _ = ALL_MODULES[arch]
    tcfg = tmod.make_config()
    assert tcfg.param_count == jmod.make_config().param_count
    assert tmod.make_reduced().param_count == jmod.make_reduced().param_count
    ab = trecsys.abstract_params(tcfg)
    leaves = list(tcommon.leaves(ab))
    assert leaves and all(t.device.type == "meta" and t.dtype == torch.float32 for t in leaves)
    ref = jax.tree.map(lambda a: tuple(a.shape), jrecsys.abstract_params(jmod.make_config()))
    mine = tcommon.map_shapes(trecsys.param_shapes(tcfg), lambda _, s: tuple(s))
    assert mine == ref
    assert tcommon.tree_bytes(ab) == 4 * tcfg.param_count


def test_param_counts_at_full_size():
    """The numbers chip_smoke.py prints beside the reference's formula."""
    assert tdlrm.make_config().param_count == 1_664_762_177
    assert txdeepfm.make_config().param_count == 432_742_001
    assert tbert.make_config().param_count == 64_112_128


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_init_params_is_seeded_shaped_and_scaled(arch):
    _, tmod, _ = MODULES[arch]
    cfg = tmod.make_reduced()
    a = trecsys.init_params(cfg, seed=3, device="cpu")
    b = trecsys.init_params(cfg, seed=3, device="cpu")
    c = trecsys.init_params(cfg, seed=4, device="cpu")
    pairs = list(zip(tcommon.leaves(a), tcommon.leaves(b)))
    assert all(torch.equal(x, y) for x, y in pairs)
    assert not all(torch.equal(x, y) for x, y in zip(tcommon.leaves(a), tcommon.leaves(c)))
    shapes = tcommon.map_shapes(trecsys.param_shapes(cfg), lambda _, s: tuple(s))
    assert tcommon.map_shapes(a, lambda _, t: tuple(t.shape)) == shapes
    if cfg.kind == "bert4rec":
        assert torch.equal(a["blocks"]["wq"][0], a["blocks"]["wq"][-1])  # stacked, as the reference
        assert float(a["item_embed"].std()) == pytest.approx(0.02, rel=0.1)
        assert float(a["blocks"]["w1"].abs().max()) <= 1 / np.sqrt(cfg.embed_dim)
    else:
        assert float(a["tables"].std()) == pytest.approx(0.01, rel=0.1)


def test_params_from_numpy_checks_keys_and_shapes():
    jcfg, tcfg = configs("xdeepfm", "reduced", "FP32")
    jp = jax.tree.map(np.asarray, jrecsys.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = trecsys.params_from_numpy(tcfg, jp, "cpu")
    assert torch.equal(tp["cin"]["w1"], torch.tensor(jp["cin"]["w1"]))
    missing = {**jp, "cin": {"w0": jp["cin"]["w0"]}}
    with pytest.raises(ValueError, match="cin/"):
        trecsys.params_from_numpy(tcfg, missing, "cpu")
    wrong = {**jp, "dnn": {**jp["dnn"], "w0": jp["dnn"]["w0"][:-1]}}
    with pytest.raises(ValueError, match="dnn/w0"):
        trecsys.params_from_numpy(tcfg, wrong, "cpu")


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_configs_match_reference(arch):
    jmod, tmod, _ = MODULES[arch]
    for name in ("make_config", "make_reduced"):
        jd = dataclasses.asdict(getattr(jmod, name)())
        td = dataclasses.asdict(getattr(tmod, name)())
        jd.pop("precision"), td.pop("precision")
        assert jd == td
    assert dataclasses.asdict(tmod.SPEC.optim) == dataclasses.asdict(jmod.SPEC.optim)
    assert (tmod.SPEC.arch_id, tmod.SPEC.source) == (jmod.SPEC.arch_id, jmod.SPEC.source)
    assert get_arch(arch) is tmod.SPEC


@pytest.mark.parametrize("arch", sorted(ALL_MODULES))
def test_model_flops_equal_the_reference_build_cell(arch):
    jmod, tmod, _ = ALL_MODULES[arch]
    mesh = make_local_mesh(1, 1)
    for cell in tmod.SPEC.shapes:
        want = build_cell(jmod.SPEC, jmod.SPEC.cell(cell.name), mesh).meta["model_flops"]
        assert trecsys.model_flops(tmod.make_config(), cell) == want, cell.name


def test_unknown_kind_raises_value_error():
    cfg = trecsys.RecsysConfig(name="x", kind="wide-and-deep")
    for fn in (lambda: trecsys.param_shapes(cfg), lambda: trecsys.forward(cfg, {}, {}),
               lambda: trecsys.user_tower(cfg, {}, {}), lambda: cfg.param_count):
        with pytest.raises(ValueError, match="unknown recsys kind"):
            fn()


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, masked):
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(3, 20, 8)).astype(np.float32)
    ids = rng.integers(-20, 20, (4, 3, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (4, 3, 5)).astype(np.int32) if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jrecsys.embedding_bag(jnp.asarray(tables), jnp.asarray(ids), mask_j, mode))
    got = trecsys.embedding_bag(torch.from_numpy(tables), ids, mask, mode)
    assert got.shape == (4, 3, 8)
    # five terms of magnitude up to 8 summed in another order: an f32 step
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_embedding_bag_sum_against_a_dense_loop_and_ragged():
    """Mirrors the reference's own test: the masked sum against a loop, and
    the ragged bags of field 0 against the padded ones."""
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(3, 20, 8)).astype(np.float32)
    ids = rng.integers(0, 20, (4, 3, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (4, 3, 5)).astype(np.int32)
    out = trecsys.embedding_bag(torch.from_numpy(tables), ids, mask, mode="sum")
    want = np.zeros((4, 3, 8), np.float32)
    for b, f, j in zip(*np.nonzero(mask)):
        want[b, f] += tables[f, ids[b, f, j]]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
    b_idx, j_idx = np.nonzero(mask[:, 0])
    ragged = trecsys.embedding_bag_ragged(torch.from_numpy(tables[0]), ids[b_idx, 0, j_idx],
                                          b_idx, 4)
    np.testing.assert_allclose(ragged.numpy(), want[:, 0], rtol=1e-5)


def test_embedding_bag_ragged_matches_segment_sum():
    """Negative ids wrap; bag ids outside [0, n_bags) drop their row, as
    ``segment_sum`` drops them."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    flat = rng.integers(-30, 30, 40).astype(np.int32)
    bags = rng.integers(-1, 6, 40).astype(np.int32)  # -1 and 5 fall outside 5 bags
    want = np.asarray(jrecsys.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                                   jnp.asarray(bags), 5))
    got = trecsys.embedding_bag_ragged(torch.from_numpy(table), flat, bags, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_embedding_bag_ids_out_of_range_raise():
    tables = torch.zeros(2, 10, 4)
    ids = np.zeros((1, 2, 3), np.int32)
    ids[0, 1, 2] = 10
    with pytest.raises(IndexError):
        trecsys.embedding_bag(tables, ids)
    with pytest.raises(IndexError):
        trecsys.embedding_bag_ragged(tables[0], [0, -11], [0, 0], 1)
    with pytest.raises(ValueError):
        trecsys.embedding_bag(tables, ids.clip(0, 9), mode="median")


# ---------------------------------------------------------------------------
# The common.py helpers and the tie-ordered top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7, 24)).astype(np.float32) * 3 + 1
    w, bias = rng.normal(size=24).astype(np.float32), rng.normal(size=24).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = TOL["FP32" if dtype == "float32" else "MIXED"]
    for jf, tf, args in ((jcommon.layer_norm, tcommon.layer_norm, (w, bias)),
                         (jcommon.rms_norm, tcommon.rms_norm, (w,))):
        want = jf(xj, *map(jnp.asarray, args))
        got = tf(xt, *map(torch.from_numpy, args))
        assert torch_dtype_name(got) == str(want.dtype)
        assert_close_scaled(got, want.astype(jnp.float32), tol / 10, jf.__name__)


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_apply_matches_reference(final):
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.asarray, jcommon.mlp_params(jax.random.PRNGKey(3), [9, 16, 8, 2]))
    jp = perturb(jp, rng)
    x = rng.normal(size=(11, 9)).astype(np.float32)
    want = jcommon.mlp_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             final_act=None if final is None else jax.nn.sigmoid)
    got = tcommon.mlp_apply({k: torch.from_numpy(v) for k, v in jp.items()}, torch.from_numpy(x),
                            final_act=None if final is None else torch.sigmoid)
    assert_close_scaled(got, want, TOL["FP32"])
    assert tcommon.mlp_param_shapes([9, 16, 8, 2]) == {k: v.shape for k, v in jp.items()}


def test_bce_with_logits_matches_reference():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=300) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 300).astype(np.float32)
    want = float(jcommon.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tcommon.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_loss_matches_reference(z_loss):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 5, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 5)).astype(np.int32)
    want = float(jcommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss))
    got = float(tcommon.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                           z_loss))
    assert got == pytest.approx(want, rel=1e-6)


def test_inits_are_seeded_and_scaled():
    g = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(g, 400, 300)
    e = tcommon.embed_init(g, 2000, 64)
    assert w.shape == (400, 300) and float(w.abs().max()) <= 1 / 20
    assert float(w.std()) == pytest.approx(1 / 20 / np.sqrt(3), rel=0.02)
    assert float(e.std()) == pytest.approx(0.02, rel=0.02)
    again = tcommon.dense_init(torch.Generator().manual_seed(0), 400, 300)
    assert torch.equal(w, again)


@pytest.mark.parametrize("seed", range(6))
def test_largest_k_equals_lax_top_k(seed):
    """Tie-heavy rows (few distinct values) and float rows; k below, at and
    past the row length."""
    rng = np.random.default_rng(seed)
    r, n = int(rng.integers(1, 30)), int(rng.integers(2, 400))
    x = rng.integers(0, int(rng.integers(1, 6)), (r, n)).astype(np.float32)
    if seed % 2:
        x = rng.normal(size=(r, n)).astype(np.float32)
    for k in (1, n // 2 or 1, n - 1 or 1, n):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = largest_k(torch.from_numpy(x), k)
        assert np.array_equal(np.asarray(jv), tv.numpy())
        assert np.array_equal(np.asarray(ji), ti.numpy())
