"""The port's hand-written CUDA kernels on the card (``cuda`` marker; they
have no CPU mode, so these skip without a card). This file imports neither
JAX nor the reference, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same card tensors
(gather_auto rtol 1e-5; fused_auto |Δ| ≤ (1e-5·(‖q‖² + ‖x‖²) + 1e-6)·pen²
+ 1e-6·|ref|), must be bitwise batch-invariant, and a search on integer-
valued data must equal the CPU's plain-version search bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Engine, QueryBatch, SearchParams  # noqa: E402
from repro_torch.core.index import index_from_numpy  # noqa: E402
from repro_torch.data.synthetic import make_hybrid_dataset  # noqa: E402
from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ref import penalty_sa  # noqa: E402

pytestmark = pytest.mark.cuda

ALPHA = 0.8


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def inputs(b, n, m, l, seed, dev):
    g = torch.Generator().manual_seed(seed)
    qv = torch.randn(b, m, generator=g) * 30
    xv = torch.randn(n, m, generator=g) * 30
    qa = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32)
    xa = torch.randint(0, 4, (n, l), generator=g, dtype=torch.int32)
    other = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32)
    iv = torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1)
    mask = torch.randint(0, 2, (b, l), generator=g, dtype=torch.int32)
    cand = torch.randint(-1, n, (b, 520), generator=g, dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (qv, xv, qa, xa, iv, mask, cand)]


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("kind", ["point", "interval", "masked"])
@pytest.mark.parametrize("m", [128, 100])  # float4 path and scalar path
def test_kernels_match_plain_versions(cuda_dev, kind, mode, m):
    qv, xv, qa, xa, iv, mask, cand = inputs(130, 1003, m, 5, seed=m, dev=cuda_dev)
    qa_t = iv if kind == "interval" else qa
    mk = mask if kind == "masked" else None
    g0, f0 = gather_auto.launches, fused_auto.launches
    g = gather_auto(qv, qa_t, xv, xa, cand, ALPHA, mode, mk)
    f = fused_auto(qv, qa_t, xv, xa, ALPHA, mode, mk)
    torch.cuda.synchronize()
    assert (gather_auto.launches, fused_auto.launches) == (g0 + 1, f0 + 1)
    torch.testing.assert_close(
        g, gather_auto_ref(qv, qa_t, xv, xa, cand, ALPHA, mode, mk), rtol=1e-5, atol=1e-6
    )
    fr = fused_auto_ref(qv, qa_t, xv, xa, ALPHA, mode, mk).double()
    pen2 = 1.0
    if mode == "auto":
        sa = penalty_sa(qa_t, xa[None].expand(qv.shape[0], -1, -1), mk).double()
        pen2 = (1.0 + sa / ALPHA) ** 2
    norms = (qv.double() ** 2).sum(1)[:, None] + (xv.double() ** 2).sum(1)[None, :]
    tol = (1e-5 * norms + 1e-6) * pen2 + 1e-6 * fr.abs()
    assert bool(((f.double() - fr).abs() <= tol).all())


@pytest.mark.parametrize("mode", ["auto", "l2"])
def test_kernels_batch_invariant_bitwise(cuda_dev, mode):
    qv, xv, qa, xa, iv, mask, cand = inputs(128, 777, 128, 5, seed=3, dev=cuda_dev)
    full_g = gather_auto(qv, iv, xv, xa, cand, ALPHA, mode, mask)
    full_f = fused_auto(qv, iv, xv, xa, ALPHA, mode, mask)
    for r in (0, 77, 127):
        sl = slice(r, r + 1)
        one_g = gather_auto(qv[sl].contiguous(), iv[sl].contiguous(), xv, xa,
                            cand[sl].contiguous(), ALPHA, mode, mask[sl].contiguous())
        one_f = fused_auto(qv[sl].contiguous(), iv[sl].contiguous(), xv, xa, ALPHA, mode,
                           mask[sl].contiguous())
        assert torch.equal(one_g[0], full_g[r]) and torch.equal(one_f[0], full_f[r])


def test_search_on_card_equals_cpu_on_integer_data(cuda_dev):
    ds = make_hybrid_dataset(n=3000, n_queries=32, profile="sift", n_clusters=8,
                             attr_cluster_corr=0.6, seed=1)
    f = np.clip(np.round(ds.features / 33.5 * 4), -20, 20).astype(np.float32)
    qf = np.clip(np.round(ds.query_features / 33.5 * 4), -20, 20).astype(np.float32)
    cpu = Engine.build(f, ds.attrs, device="cpu")
    idx = cpu.index
    parts = (idx.features.numpy(), idx.attrs.numpy(), idx.graph.numpy())
    meta = [{k: getattr(c, k) for k in c.__dataclass_fields__}
            for c in (idx.metric_cfg, idx.help_cfg, idx.stats)]
    card = Engine(index_from_numpy(*parts, *meta, device=cuda_dev))
    for q in (QueryBatch.match(qf, ds.query_attrs),
              QueryBatch.match(qf, ds.query_attrs, active=[0, 1])):
        for backend in ("graph", "brute"):
            a = cpu.search(q, SearchParams(k=10, backend=backend))
            b = card.search(q, SearchParams(k=10, backend=backend))
            assert torch.equal(a.ids, b.ids.cpu())
            assert torch.equal(a.sqdists, b.sqdists.cpu())
            assert torch.equal(a.n_dist_evals, b.n_dist_evals.cpu())
            assert int(a.n_hops) == int(b.n_hops)
