"""The port's FM serving path against the reference: the reference's
``init_params`` crosses as numpy arrays (``params_from_numpy``), then CTR
logits from ``make_recsys_serve_step``, ``user_tower`` and the STABLE
retrieval head (``make_recsys_retrieval_step`` / ``hybrid_retrieval_topk``,
one-stage and two-stage) run in both packages on the same numpy inputs.
Configs: the fm reduced config (F = 8, V = 50, D = 8) and the full fm widths
with a cut vocabulary (F = 39, D = 10, V = 1,000).

Tolerances: logits |Δ| ≤ 1e-6 + 1e-5·|ref| and user vectors rtol 1e-6,
atol 1e-7 (f32 sums over the fields in another order; the logits are
≈ 0.1). Retrieval sq-dists rtol 1e-5, atol 1e-6 (‖q‖² + ‖x‖² − 2q·x
cancels); ids must be equal except where two candidates' sq-dists lie within
that tolerance of each other (near-ties).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import bert4rec as jbert  # noqa: E402
from repro.configs import dlrm_rm2 as jdlrm  # noqa: E402
from repro.configs import fm as jfm  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.configs import xdeepfm as jxdeepfm  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import bert4rec as tbert  # noqa: E402
from repro_torch.configs import dlrm_rm2 as tdlrm  # noqa: E402
from repro_torch.configs import fm as tfm  # noqa: E402
from repro_torch.configs import xdeepfm as txdeepfm  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import fm_interaction  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CONFIGS = {
    "reduced": (jfm.make_reduced(), tfm.make_reduced()),
    "full-width": (dataclasses.replace(jfm.make_config(), vocab_per_field=1000),
                   dataclasses.replace(tfm.make_config(), vocab_per_field=1000)),
}
N_ITEMS, N_USERS, K = 960, 6, 10


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """(reference cfg, port cfg, reference params, port params, batch) with
    ids over [−V, V), so negative ids (which wrap) are exercised too."""
    jcfg, tcfg = CONFIGS[request.param]
    jp = jrecsys.init_params(jcfg, jax.random.PRNGKey(0))
    tp = trecsys.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()}, "cpu")
    rng = np.random.default_rng(len(request.param))
    v, f, d = tcfg.vocab_per_field, tcfg.n_sparse, tcfg.embed_dim
    batch = {
        "sparse": rng.integers(-v, v, (N_USERS, f)).astype(np.int32),
        "query_attrs": rng.integers(0, 3, (N_USERS, tcfg.n_attr_dims)).astype(np.int32),
        # item factors at the scale of a user vector (a sum of F rows of 0.01)
        "item_embs": (rng.normal(size=(N_ITEMS, d)) * 0.01 * np.sqrt(f)).astype(np.float32),
        "item_attrs": rng.integers(0, 3, (N_ITEMS, tcfg.n_attr_dims)).astype(np.int32),
    }
    return jcfg, tcfg, jp, tp, batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_topk_match(jd, ji, td, ti, rtol=1e-5, atol=1e-6):
    """Sq-dists allclose; ids equal except at near-ties."""
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


def test_serve_logits_match_reference(case):
    jcfg, tcfg, jp, tp, batch = case
    want = np.asarray(jstep.make_recsys_serve_step(jcfg)(jp, jbatch(batch)))
    got = tstep.make_recsys_serve_step(tcfg)(tp, batch)
    assert got.dtype == torch.float32 and got.shape == (N_USERS,)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 + 1e-5 * np.abs(want))


def test_serve_step_runs_the_fm_kernel_wrapper(case):
    """The logits are second + lin + bias with second from ops.fm_interaction
    (plain version on the CPU), each example independent of the batch."""
    _, tcfg, _, tp, batch = case
    step = tstep.make_recsys_serve_step(tcfg)
    full = step(tp, batch)
    emb = trecsys.embedding_lookup(tp["tables"], batch["sparse"])
    lin = tp["linear"][torch.arange(tcfg.n_sparse)[None, :],
                       torch.from_numpy(batch["sparse"]).long()]
    manual = fm_interaction(emb) + trecsys._sum_fields(lin) + tp["bias"]
    assert torch.equal(full, manual)
    one = step(tp, {"sparse": batch["sparse"][2:3]})
    assert torch.equal(one[0], full[2])


def test_user_tower_matches_reference(case):
    jcfg, tcfg, jp, tp, batch = case
    want = np.asarray(jrecsys.user_tower(jcfg, jp, jbatch(batch)))
    got = trecsys.user_tower(tcfg, tp, batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shards", [1, 2, 4, 16])
def test_retrieval_step_matches_reference(case, shards):
    jcfg, tcfg, jp, tp, batch = case
    jd, ji = jstep.make_recsys_retrieval_step(jcfg, k=K, topk_shards=shards)(jp, jbatch(batch))
    td, ti = tstep.make_recsys_retrieval_step(tcfg, k=K, topk_shards=shards)(tp, batch)
    assert_topk_match(jd, ji, td, ti)


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("shards", [1, 2, 4, 16])
def test_hybrid_retrieval_topk_matches_reference(mode, shards):
    rng = np.random.default_rng(shards)
    u = rng.normal(size=(3, 12)).astype(np.float32)
    ua = rng.integers(0, 3, (3, 4)).astype(np.int32)
    e = rng.normal(size=(N_ITEMS, 12)).astype(np.float32)
    ea = rng.integers(0, 3, (N_ITEMS, 4)).astype(np.int32)
    jd, ji = jrecsys.hybrid_retrieval_topk(
        jnp.asarray(u), jnp.asarray(ua), jnp.asarray(e), jnp.asarray(ea), k=K, alpha=0.8,
        mode=mode, topk_shards=shards)
    td, ti = trecsys.hybrid_retrieval_topk(
        torch.from_numpy(u), ua, e, ea, k=K, alpha=0.8, mode=mode, topk_shards=shards)
    assert_topk_match(jd, ji, td, ti)
    one_d, one_i = trecsys.hybrid_retrieval_topk(
        torch.from_numpy(u), ua, e, ea, k=K, alpha=0.8, mode=mode, topk_shards=1)
    assert torch.equal(td, one_d) and torch.equal(ti, one_i)  # the merge is exact


def test_non_divisible_shards_fall_back_to_one_stage():
    rng = np.random.default_rng(7)
    u = rng.normal(size=(2, 12)).astype(np.float32)
    ua = rng.integers(0, 3, (2, 4)).astype(np.int32)
    e = rng.normal(size=(N_ITEMS + 1, 12)).astype(np.float32)  # 961 % 16 != 0
    ea = rng.integers(0, 3, (N_ITEMS + 1, 4)).astype(np.int32)
    jd, ji = jrecsys.hybrid_retrieval_topk(
        jnp.asarray(u), jnp.asarray(ua), jnp.asarray(e), jnp.asarray(ea), k=5, topk_shards=16)
    td, ti = trecsys.hybrid_retrieval_topk(torch.from_numpy(u), ua, e, ea, k=5, topk_shards=16)
    assert_topk_match(jd, ji, td, ti)
    d0, i0 = trecsys.hybrid_retrieval_topk(torch.from_numpy(u), ua, e, ea, k=5, topk_shards=1)
    assert torch.equal(td, d0) and torch.equal(ti, i0)


def test_embedding_lookup_wraps_negative_ids_and_raises_out_of_range():
    jcfg, tcfg = CONFIGS["reduced"]
    jp = jrecsys.init_params(jcfg, jax.random.PRNGKey(1))
    tables = torch.from_numpy(np.array(jp["tables"]))
    ids = np.array([[0, -1, 49, -50, 3, 7, -7, 25]], np.int32)
    want = np.asarray(jrecsys.embedding_lookup(jp["tables"], jnp.asarray(ids)))
    assert np.array_equal(trecsys.embedding_lookup(tables, ids).numpy(), want)
    for bad in (50, -51):
        wrong = ids.copy()
        wrong[0, 3] = bad
        with pytest.raises(IndexError):
            trecsys.embedding_lookup(tables, wrong)


def test_param_count_and_abstract_params():
    assert tfm.make_config().param_count == jfm.make_config().param_count == 429_000_001
    assert tfm.make_reduced().param_count == jfm.make_reduced().param_count
    ab = trecsys.abstract_params(tfm.make_config())
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in ab.values())
    ref = jrecsys.abstract_params(jfm.make_config())
    assert {k: tuple(t.shape) for k, t in ab.items()} == {k: v.shape for k, v in ref.items()}


def test_init_params_is_seeded_and_scaled():
    cfg = dataclasses.replace(tfm.make_config(), vocab_per_field=2000)
    a = trecsys.init_params(cfg, seed=3, device="cpu")
    b = trecsys.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tuple(a["tables"].shape) == (39, 2000, 10) and a["bias"].shape == ()
    assert abs(float(a["tables"].std()) - 0.01) < 2e-4
    assert abs(float(a["linear"].std()) - 0.01) < 5e-4


def test_configs_match_reference():
    """All four recsys configs, their shape cells and optimizer settings."""
    for jmod, tmod in ((jfm, tfm), (jdlrm, tdlrm), (jxdeepfm, txdeepfm), (jbert, tbert)):
        for name in ("make_config", "make_reduced"):
            j, t = getattr(jmod, name)(), getattr(tmod, name)()
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            jd.pop("precision"), td.pop("precision")
            assert jd == td
        assert dataclasses.asdict(tmod.SPEC.optim) == dataclasses.asdict(jmod.SPEC.optim)
        assert tmod.SPEC.cell("retrieval_cand").n_candidates == 1_000_000
        assert get_arch(tmod.SPEC.arch_id) is tmod.SPEC
    assert [dataclasses.asdict(c) for c in tbase.RECSYS_SHAPES] == \
        [dataclasses.asdict(c) for c in jbase.RECSYS_SHAPES]


RECSYS_IDS = sorted(a for a, spec in jregistry.ARCHS.items() if spec.family == "recsys")
LM_IDS = sorted(a for a, spec in jregistry.ARCHS.items() if spec.family == "lm")


def test_get_arch_returns_the_ported_gnn_spec():
    """graphcast, the reference's one GNN id, resolves to the port's spec:
    its family, source, optimizer and shape table equal the reference's."""
    spec, ref = get_arch("graphcast"), jregistry.get_arch("graphcast")
    assert spec.family == ref.family == "gnn"
    assert (spec.arch_id, spec.source, spec.micro_batches) == \
        (ref.arch_id, ref.source, ref.micro_batches)
    assert [dataclasses.asdict(c) for c in spec.shapes] == \
        [dataclasses.asdict(c) for c in ref.shapes]
    assert dataclasses.asdict(spec.optim) == dataclasses.asdict(ref.optim)


def test_every_reference_arch_is_ported():
    """Every id of the reference's registry resolves, and an unknown id
    still raises ``KeyError``."""
    for arch_id in jregistry.ARCHS:
        assert get_arch(arch_id).arch_id == arch_id
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("graphcast-v2")


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_get_arch_returns_the_ported_lm_spec(arch_id):
    spec, ref = get_arch(arch_id), jregistry.get_arch(arch_id)
    assert spec.family == ref.family == "lm"
    assert (spec.arch_id, spec.source, spec.micro_batches) == \
        (ref.arch_id, ref.source, ref.micro_batches)
    assert [c.name for c in spec.shapes] == [c.name for c in ref.shapes]
    assert [c.skip_reason for c in spec.shapes] == [c.skip_reason for c in ref.shapes]
    assert dataclasses.asdict(spec.optim) == dataclasses.asdict(ref.optim)


@pytest.mark.parametrize("arch_id", sorted(set(RECSYS_IDS) - {"fm"}))
def test_get_arch_returns_the_ported_recsys_spec(arch_id):
    spec = get_arch(arch_id)
    ref = jregistry.get_arch(arch_id)
    assert spec.family == "recsys"
    assert (spec.arch_id, spec.source) == (ref.arch_id, ref.source)
    assert spec.make_config().kind == ref.make_config().kind
    assert [c.name for c in spec.shapes] == [c.name for c in ref.shapes]


def test_registry_holds_every_recsys_and_lm_id():
    assert set(RECSYS_IDS + LM_IDS) <= set(ARCHS)
    assert sorted(ARCHS) == sorted(jregistry.ARCHS)


def test_unported_kinds_raise():
    """Every recsys kind of the reference is ported: only a kind the
    reference does not have raises (``ValueError``, as the reference's),
    and an unknown arch id ``KeyError``."""
    cfg = trecsys.RecsysConfig(name="d", kind="wide-and-deep")
    with pytest.raises(ValueError, match="unknown recsys kind"):
        trecsys.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown recsys kind"):
        trecsys.forward(cfg, {}, {})
    with pytest.raises(ValueError, match="unknown recsys kind"):
        trecsys.user_tower(cfg, {}, {})
    for spec in ARCHS.values():
        if spec.family == "recsys":
            assert trecsys.abstract_params(spec.make_reduced())
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
