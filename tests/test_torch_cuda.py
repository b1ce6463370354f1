"""The port's hand-written CUDA kernels on the card (``cuda`` marker; they
have no CPU mode, so these skip without a card). This file imports neither
JAX nor the reference, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same card tensors
(gather_auto rtol 1e-5; fused_auto |Δ| ≤ (1e-5·(‖q‖² + ‖x‖²) + 1e-6)·pen²
+ 1e-6·|ref|; adc_scan, adc_scan4 and fm_interaction bit for bit), must be
bitwise batch-invariant, and a search on integer-valued data must equal the
CPU's plain-version search bit for bit, exact and quantized. The fm serve
and retrieval steps on the card must agree with the CPU's, and so must the
dlrm-rm2, xdeepfm and bert4rec steps at full width with a cut vocabulary
(|Δ| ≤ 1e-5·max|cpu| under FP32, 0.03·max|cpu| under MIXED); so must a
train step's loss and gradients for all four kinds, and ``apply_updates``
on identical gradients within 1e-6·max|cpu|. fm_interaction's gradient on
the card equals the CPU's bit for bit, and fm's tables train through it
(a regression test for a gradient the kernel's result would drop). A serve_loop
trace on the card returns, for every request, what its query returns
searched alone, bit for bit, on both backends. A merge of the mutable
engine on the card gives the CPU's adjacency (and codes, for pq and pq4)
on integer data, the delta scan equals its plain version, and the old
index's memory is freed after the swap. A sharded index on a (data=1,
model=4) mesh on the card: the exhaustive merge equals a brute oracle
scored by the same kernel, data=2 equals data=1 and a save and load
equals the index saved, bit for bit. The ring matmuls on a (1, 4) mesh on
the card equal the plain sums of their partials in ring order, bit for
bit, and fm's train_batch cell built on a (1, 1) mesh holds exactly the
dry run's argument bytes on the card and counts its FLOPs.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    ANY, BETWEEN, MATCH, ONE_OF, Engine, Query, QueryBatch, SearchParams,
)
from repro_torch.configs import fm  # noqa: E402
from repro_torch.core.index import index_from_numpy  # noqa: E402
from repro_torch.data.synthetic import make_hybrid_dataset  # noqa: E402
from repro_torch.kernels.adc_scan.ops import (  # noqa: E402
    adc_scan4_ref, adc_scan4_scores, adc_scan_ref, adc_scan_scores,
)
from repro_torch.kernels.fm_interaction.ops import fm_interaction, fm_interaction_ref  # noqa: E402
from repro_torch.kernels.fused_auto.ops import MAX_ATTRS, fused_auto, fused_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ref import penalty_sa  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    QuantConfig, QuantizedVectors, codec_spec, pack_nibbles, quant_from_numpy, unpack_nibbles,
)
from repro_torch.serve import Request, TenantPolicy, TenantRegistry, serve_loop  # noqa: E402
from repro_torch.train.step import make_recsys_retrieval_step, make_recsys_serve_step  # noqa: E402

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


@pytest.mark.parametrize("l", [1, 4, 5, 9])
@pytest.mark.parametrize("m", [10, 100, 128, 130])
@pytest.mark.parametrize("n", [1003, 20011])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 48, 49, 63, 64, 65, 130])
def test_fused_auto_tiles_exact_on_integer_data(cuda_dev, b, n, m, l):
    """Every tile of the kernel (B <= 48, <= 64, wider) and every chunking of
    M (whole rows, full and ragged chunks) equals the plain version bit for
    bit on integer-valued data, and a batch's rows equal the same rows
    scored by another tile (a single-row call, the first 17 or 49 rows)."""
    g = torch.Generator().manual_seed(b * 1000 + n + m + l)
    qv = torch.randint(-20, 21, (b, m), generator=g).float().to(cuda_dev)
    xv = torch.randint(-20, 21, (n, m), generator=g).float().to(cuda_dev)
    qa = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    xa = torch.randint(0, 4, (n, l), generator=g, dtype=torch.int32).to(cuda_dev)
    other = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    iv = torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1).contiguous()
    mask = torch.randint(0, 2, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    for qt, mk in ((qa, None), (iv, None), (qa, mask)):
        for mode in ("auto", "l2"):
            full = fused_auto(qv, qt, xv, xa, ALPHA, mode, mk)
            assert torch.equal(full, fused_auto_ref(qv, qt, xv, xa, ALPHA, mode, mk))
            for rows in (slice(0, 1), slice(b - 1, b), slice(0, min(b, 17)),
                         slice(0, min(b, 49))):
                part = fused_auto(qv[rows].contiguous(), qt[rows].contiguous(), xv, xa, ALPHA,
                                  mode, None if mk is None else mk[rows].contiguous())
                assert torch.equal(part, full[rows])


@pytest.mark.parametrize("l", [MAX_ATTRS, MAX_ATTRS + 1, 200])
@pytest.mark.parametrize("b", [1, 49, 130])
def test_fused_auto_any_attribute_count(cuda_dev, b, l):
    """Auto mode takes any L on every tile at its largest shared-memory
    footprint (two feature buffers, M = 130): staged up to MAX_ATTRS, read
    from device memory above it, bit for bit on integer data either way,
    with point, interval and masked targets; l2 mode too."""
    g = torch.Generator().manual_seed(b * 1000 + l)
    n, m = 1003, 130
    qv = torch.randint(-20, 21, (b, m), generator=g).float().to(cuda_dev)
    xv = torch.randint(-20, 21, (n, m), generator=g).float().to(cuda_dev)
    qa = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    xa = torch.randint(0, 4, (n, l), generator=g, dtype=torch.int32).to(cuda_dev)
    other = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    iv = torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1).contiguous()
    mask = torch.randint(0, 2, (b, l), generator=g, dtype=torch.int32).to(cuda_dev)
    for qt, mk in ((qa, None), (iv, None), (qa, mask)):
        assert torch.equal(fused_auto(qv, qt, xv, xa, ALPHA, "auto", mk),
                           fused_auto_ref(qv, qt, xv, xa, ALPHA, "auto", mk))
    assert torch.equal(fused_auto(qv, qa, xv, xa, ALPHA, "l2"),
                       fused_auto_ref(qv, qa, xv, xa, ALPHA, "l2"))


@pytest.mark.parametrize("c", [32, 37])
@pytest.mark.parametrize("m", [128, 100, 12289, 20000])
def test_gather_auto_any_width_and_span(cuda_dev, m, c):
    """gather_auto at widths above a 48 KB query row (M > 12,288; float4 and
    scalar loads), at the build's narrow C = 32 and an odd C (a span cut
    short), against its plain version (rtol 1e-5), for every target kind
    and mode; rows 0, 77 and B-1 equal single-row calls bit for bit."""
    b = 80
    qv, xv, qa, xa, iv, mask, _ = inputs(b, 1003, m, 5, seed=m + c, dev=cuda_dev)
    g = torch.Generator().manual_seed(m * c)
    cand = torch.randint(-1, 1003, (b, c), generator=g, dtype=torch.int32).to(cuda_dev)
    for qt, mk in ((qa, None), (iv, None), (qa, mask)):
        for mode in ("auto", "l2"):
            full = gather_auto(qv, qt, xv, xa, cand, ALPHA, mode, mk)
            torch.testing.assert_close(
                full, gather_auto_ref(qv, qt, xv, xa, cand, ALPHA, mode, mk), rtol=1e-5, atol=1e-6)
            assert bool((full[cand < 0] == 3.0e38).all())
            for r in (0, 77, b - 1):
                sl = slice(r, r + 1)
                one = gather_auto(qv[sl].contiguous(), qt[sl].contiguous(), xv, xa,
                                  cand[sl].contiguous(), ALPHA, mode,
                                  None if mk is None else mk[sl].contiguous())
                assert torch.equal(one[0], full[r])


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


def adc_inputs(b, n, s, k, l, seed, dev):
    g = torch.Generator().manual_seed(seed)
    lut = torch.rand(b, s, k, generator=g) * 40
    codes = torch.randint(0, k, (n, s), generator=g).to(torch.uint8)
    qa = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32)
    xa = torch.randint(0, 4, (n, l), generator=g, dtype=torch.int32)
    other = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32)
    iv = torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1)
    mask = torch.randint(0, 2, (b, l), generator=g, dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (lut, codes, qa, xa, iv, mask)]


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("kind", ["point", "interval", "masked"])
@pytest.mark.parametrize("s", [1, 7, 33, 64, 65, 200])
def test_adc_kernels_bitwise_equal_plain_versions(cuda_dev, kind, mode, s):
    """S below one 32-subspace chunk, at one, across a partial second chunk,
    and S = 200 at K = 256 only (224 padded subspaces: 224 KB of table, one
    query a block; the 4-bit scanner is checked up to S = 65)."""
    lut, codes, qa, xa, iv, mask = adc_inputs(130, 3001, s, 256, 5, seed=s, dev=cuda_dev)
    qa_t = iv if kind == "interval" else qa
    mk = mask if kind == "masked" else None
    a0, a40 = adc_scan_scores.launches, adc_scan4_scores.launches
    got = adc_scan_scores(lut, codes, qa_t, xa, ALPHA, mode, mk)
    torch.cuda.synchronize()
    assert adc_scan_scores.launches == a0 + 1
    assert torch.equal(got, adc_scan_ref(lut, codes, qa_t, xa, ALPHA, mode, mk))
    if s == 200:
        return
    lut4, codes4 = lut[:, :, :16].contiguous(), (codes & 0xF).contiguous()
    packed = pack_nibbles(codes4)
    got4 = adc_scan4_scores(lut4, packed, qa_t, xa, ALPHA, mode, mk)
    torch.cuda.synchronize()
    assert adc_scan4_scores.launches == a40 + 1
    assert torch.equal(got4, adc_scan4_ref(lut4, packed, qa_t, xa, ALPHA, mode, mk))
    # the packed scanner equals the 8-bit one on the same codes unpacked
    assert torch.equal(got4, adc_scan_scores(lut4, codes4, qa_t, xa, ALPHA, mode, mk))
    assert torch.equal(unpack_nibbles(packed, s).to(torch.uint8), codes4)


@pytest.mark.parametrize("mode", ["auto", "l2"])
def test_adc_kernels_batch_invariant_bitwise(cuda_dev, mode):
    lut, codes, qa, xa, iv, mask = adc_inputs(128, 2000, 64, 256, 5, seed=9, dev=cuda_dev)
    lut4, packed = lut[:, :, :16].contiguous(), pack_nibbles(codes & 0xF)
    full = adc_scan_scores(lut, codes, iv, xa, ALPHA, mode, mask)
    full4 = adc_scan4_scores(lut4, packed, iv, xa, ALPHA, mode, mask)
    for r in (0, 77, 127):
        sl = slice(r, r + 1)
        one = adc_scan_scores(lut[sl].contiguous(), codes, iv[sl].contiguous(), xa, ALPHA, mode,
                              mask[sl].contiguous())
        one4 = adc_scan4_scores(lut4[sl].contiguous(), packed, iv[sl].contiguous(), xa, ALPHA,
                                mode, mask[sl].contiguous())
        assert torch.equal(one[0], full[r]) and torch.equal(one4[0], full4[r])


@pytest.mark.parametrize("mode", ["auto", "l2"])
def test_adc_kernels_rows_equal_single_row_calls(cuda_dev, mode):
    """B = 130 (a ragged last query group) against single-query calls."""
    lut, codes, qa, xa, iv, mask = adc_inputs(130, 2003, 64, 256, 5, seed=13, dev=cuda_dev)
    lut4, packed = lut[:, :, :16].contiguous(), pack_nibbles(codes & 0xF)
    full = adc_scan_scores(lut, codes, iv, xa, ALPHA, mode, mask)
    full4 = adc_scan4_scores(lut4, packed, iv, xa, ALPHA, mode, mask)
    for r in (0, 77, 129):
        sl = slice(r, r + 1)
        one = adc_scan_scores(lut[sl].contiguous(), codes, iv[sl].contiguous(), xa, ALPHA, mode,
                              mask[sl].contiguous())
        one4 = adc_scan4_scores(lut4[sl].contiguous(), packed, iv[sl].contiguous(), xa, ALPHA,
                                mode, mask[sl].contiguous())
        assert torch.equal(one[0], full[r]) and torch.equal(one4[0], full4[r])


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("a", [1, 77, 1001])
def test_adc_kernels_position_invariant_bitwise(cuda_dev, mode, a):
    """Scanning codes[a:] and xa[a:] (odd a: each row moves to another lane,
    block and slice) gives the columns a: of the full scan bit for bit."""
    lut, codes, qa, xa, iv, mask = adc_inputs(48, 3001, 64, 256, 5, seed=a, dev=cuda_dev)
    lut4, packed = lut[:, :, :16].contiguous(), pack_nibbles(codes & 0xF)
    full = adc_scan_scores(lut, codes, iv, xa, ALPHA, mode, mask)
    full4 = adc_scan4_scores(lut4, packed, iv, xa, ALPHA, mode, mask)
    tail = adc_scan_scores(lut, codes[a:], iv, xa[a:], ALPHA, mode, mask)
    tail4 = adc_scan4_scores(lut4, packed[a:], iv, xa[a:], ALPHA, mode, mask)
    assert torch.equal(tail, full[:, a:]) and torch.equal(tail4, full4[:, a:])


def test_quantized_search_on_card_equals_cpu_on_integer_data(cuda_dev):
    """Integer features, a codebook with rounded centroids and sq8 with
    scale 1 and zero −128: every sum is exact, so the card's quantized
    graph and brute searches equal the CPU's bit for bit."""
    ds = make_hybrid_dataset(n=3000, n_queries=32, profile="sift", n_clusters=8,
                             attr_cluster_corr=0.6, seed=2)
    f = np.clip(np.round(ds.features / 33.5 * 4), -20, 20).astype(np.float32)
    qf = np.clip(np.round(ds.query_features / 33.5 * 4), -20, 20).astype(np.float32)
    cpu = Engine.build(f, ds.attrs, device="cpu")
    idx = cpu.index
    parts = (idx.features.numpy(), idx.attrs.numpy(), idx.graph.numpy())
    meta = [{k: getattr(c, k) for k in c.__dataclass_fields__}
            for c in (idx.metric_cfg, idx.help_cfg, idx.stats)]
    q = QueryBatch.match(qf, ds.query_attrs)
    for mode in ("sq8", "pq", "pq4"):
        store = QuantizedVectors.build(idx.features, QuantConfig(mode, pq_subspaces=16,
                                                                 pq_train_iters=3))
        if mode == "sq8":
            store.sq_params.scale.fill_(1.0)
            store.sq_params.zero.fill_(-128.0)
            store.codes.copy_(idx.features.to(torch.int8))
        else:
            store.codebook.centroids.round_()
            store.codes = store.encode_rows(idx.features)
        arrays = {"codes": store.codes.numpy()}
        if mode == "sq8":
            arrays.update(sq_scale=store.sq_params.scale.numpy(), sq_zero=store.sq_params.zero.numpy())
        else:
            arrays["centroids"] = store.codebook.centroids.numpy()
        qmeta = {"cfg": {k: getattr(store.cfg, k) for k in store.cfg.__dataclass_fields__},
                 "dim": None if store.codebook is None else store.codebook.dim,
                 "codec": codec_spec(store.cfg)}
        a = Engine(index_from_numpy(*parts, *meta, device="cpu",
                                    quant=quant_from_numpy(qmeta, arrays, "cpu")))
        b = Engine(index_from_numpy(*parts, *meta, device=cuda_dev,
                                    quant=quant_from_numpy(qmeta, arrays, cuda_dev)))
        for backend in ("graph", "brute"):
            ra = a.search(q, SearchParams(k=10, backend=backend))
            rb = b.search(q, SearchParams(k=10, backend=backend))
            assert torch.equal(ra.ids, rb.ids.cpu()) and torch.equal(ra.sqdists, rb.sqdists.cpu())
            assert torch.equal(ra.n_dist_evals, rb.n_dist_evals.cpu())
            assert torch.equal(ra.n_code_evals, rb.n_code_evals.cpu())
            assert int(ra.n_hops) == int(rb.n_hops)


#: (B, F, D): serve_p99 and serve_bulk at the fm widths; odd shapes, a run
#: of fewer than 32 examples a block (F·D = 700), an odd span (no float4
#: loads, F·D = 699) and an example too large to stage (read from memory)
FM_SHAPES = [(512, 39, 10), (262144, 39, 10), (7, 5, 3), (1000, 3, 5), (77, 100, 7),
             (50, 233, 3), (3, 2000, 9)]


@pytest.mark.parametrize("shape", FM_SHAPES)
def test_fm_interaction_bitwise_equal_and_batch_invariant(cuda_dev, shape):
    g = torch.Generator(device=cuda_dev).manual_seed(sum(shape))
    e = torch.randn(shape, generator=g, device=cuda_dev) * 0.3
    n0 = fm_interaction.launches
    got = fm_interaction(e)
    torch.cuda.synchronize()
    assert fm_interaction.launches == n0 + 1
    assert torch.equal(got, fm_interaction_ref(e))
    for r in (0, shape[0] - 1):
        assert torch.equal(fm_interaction(e[r:r + 1].contiguous())[0], got[r])
    # a buffer off 16-byte alignment takes the scalar loads
    buf = torch.empty(e.numel() + 1, device=cuda_dev)
    shifted = buf[1:].view(shape)
    shifted.copy_(e)
    assert torch.equal(fm_interaction(shifted), got)


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_auto_at_the_retrieval_shape(cuda_dev, mode, b):
    """M = 10, L = 4: the scalar (non-float4) path of the kernel."""
    qv, xv, qa, xa, iv, mask, cand = inputs(b, 20011, 10, 4, seed=b, dev=cuda_dev)
    got = fused_auto(qv, qa, xv, xa, 1.0, mode)
    fr = fused_auto_ref(qv, qa, xv, xa, 1.0, mode).double()
    pen2 = 1.0
    if mode == "auto":
        pen2 = (1.0 + penalty_sa(qa, xa[None].expand(b, -1, -1), None).double()) ** 2
    norms = (qv.double() ** 2).sum(1)[:, None] + (xv.double() ** 2).sum(1)[None, :]
    tol = (1e-5 * norms + 1e-6) * pen2 + 1e-6 * fr.abs()
    assert bool(((got.double() - fr).abs() <= tol).all())
    assert torch.equal(fused_auto(qv[:1].contiguous(), qa[:1].contiguous(), xv, xa, 1.0,
                                  mode)[0], got[0])


def test_fm_serve_and_retrieval_steps_on_card_match_cpu(cuda_dev):
    """Logits |Δ| ≤ 1e-6 + 1e-6·|cpu| (the kernel equals the plain version
    bit for bit and the gathers and field sums are exact, so the two are
    expected equal); retrieval sq-dists rtol 1e-5, atol 1e-6, ids equal
    except at near-ties."""
    cfg = dataclasses.replace(fm.make_config(), vocab_per_field=1000)
    cpu = recsys.init_params(cfg, seed=0, device="cpu")
    card = {k: v.to(cuda_dev) for k, v in cpu.items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(-1000, 1000, (512, 39)).astype(np.int32)
    n0 = fm_interaction.launches
    got = make_recsys_serve_step(cfg)(card, {"sparse": torch.from_numpy(ids).to(cuda_dev)})
    torch.cuda.synchronize()
    assert fm_interaction.launches == n0 + 1
    want = make_recsys_serve_step(cfg)(cpu, {"sparse": ids})
    assert bool(((got.cpu() - want).abs() <= 1e-6 + 1e-6 * want.abs()).all())
    batch = {
        "sparse": ids[:4], "query_attrs": rng.integers(0, 3, (4, 4)).astype(np.int32),
        "item_embs": (rng.normal(size=(20000, 10)) * 0.0625).astype(np.float32),
        "item_attrs": rng.integers(0, 3, (20000, 4)).astype(np.int32),
    }
    on_card = {k: torch.from_numpy(v).to(cuda_dev) for k, v in batch.items()}
    f0 = fused_auto.launches
    for shards in (1, 4):
        step = make_recsys_retrieval_step(cfg, k=100, topk_shards=shards)
        cd, ci = (t.cpu() for t in step(card, on_card))
        pd, pi = step(cpu, batch)
        torch.testing.assert_close(cd, pd, rtol=1e-5, atol=1e-6)
        tie = 1e-6 + 1e-5 * pd.abs()
        for r, p in zip(*torch.nonzero(ci != pi, as_tuple=True)):
            near = (pd[r] - pd[r, p]).abs() <= 2 * tie[r, p]
            near[p] = False
            assert bool(near.any())
    assert fused_auto.launches == f0 + 2


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("b", [1, 5, 512])
def test_fused_auto_at_the_m64_retrieval_shape(cuda_dev, mode, b):
    """M = 64, L = 4: the dlrm-rm2 and bert4rec user width (float4 loads)."""
    qv, xv, qa, xa, iv, mask, cand = inputs(b, 20011, 64, 4, seed=b + 64, dev=cuda_dev)
    got = fused_auto(qv, qa, xv, xa, 1.0, mode)
    fr = fused_auto_ref(qv, qa, xv, xa, 1.0, mode).double()
    pen2 = 1.0
    if mode == "auto":
        pen2 = (1.0 + penalty_sa(qa, xa[None].expand(b, -1, -1), None).double()) ** 2
    norms = (qv.double() ** 2).sum(1)[:, None] + (xv.double() ** 2).sum(1)[None, :]
    tol = (1e-5 * norms + 1e-6) * pen2 + 1e-6 * fr.abs()
    assert bool(((got.double() - fr).abs() <= tol).all())
    for r in (0, b - 1):
        assert torch.equal(fused_auto(qv[r:r + 1].contiguous(), qa[r:r + 1].contiguous(), xv, xa,
                                      1.0, mode)[0], got[r])


#: the recsys models at full width with a cut vocabulary (bert4rec: items)
RECSYS_CUT = {"dlrm-rm2": {"vocab_per_field": 1000}, "xdeepfm": {"vocab_per_field": 1000},
              "bert4rec": {"n_items": 20000}}
#: |Δ| ≤ tol·max|cpu|: f32 sums in other orders; bf16 steps of 2^-8 carried
#: through the layers (tests/test_torch_recsys_models.py states both)
RECSYS_TOL = {"FP32": 1e-5, "MIXED": 0.03}


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", sorted(RECSYS_CUT))
def test_recsys_model_steps_on_card_match_cpu(cuda_dev, arch, prec):
    """The same parameters on the card and the CPU: dlrm and xdeepfm
    logits (in the same dtype) and bert4rec_serve_topk's scores within the
    tolerance, its ids equal except at near-ties within it; the user tower
    too; the retrieval step launches fused_auto once and, with the CPU's
    head on the card's user vectors, gives the CPU's top-k (sq-dists rtol
    1e-5, atol 1e-6, ids except near-ties)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import common

    cfg = dataclasses.replace(get_arch(arch).make_config(), precision=getattr(common, prec),
                              **RECSYS_CUT[arch])
    tol = RECSYS_TOL[prec]
    cpu = recsys.init_params(cfg, seed=1, device="cpu")
    card = {k: ({kk: vv.to(cuda_dev) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(cuda_dev)) for k, v in cpu.items()}
    rng = np.random.default_rng(1)
    b = 64
    if cfg.kind == "bert4rec":
        batch = {"items": rng.integers(-cfg.n_items, cfg.n_items, (b, cfg.seq_len))}
    else:
        batch = {"sparse": rng.integers(-1000, 1000, (b, cfg.n_sparse))}
        if cfg.n_dense:
            batch["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    on_card = {k: v.to(cuda_dev) for k, v in batch.items()}

    def close(got, want):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float().cpu() - want.float()).abs().max()) <= tol * scale

    if cfg.kind == "bert4rec":
        cd, ci = (t.cpu() for t in recsys.bert4rec_serve_topk(cfg, card, on_card["items"], k=100,
                                                              batch_chunk=16))
        pd, pi = recsys.bert4rec_serve_topk(cfg, cpu, batch["items"], k=100, batch_chunk=16)
        close(cd, pd)
        atol = tol * float(pd.abs().max())
        for r, p in zip(*torch.nonzero(ci != pi, as_tuple=True)):
            near = (pd[r] - pd[r, p]).abs() <= 2 * atol
            near[p] = False
            assert bool(near.any())
    else:
        close(make_recsys_serve_step(cfg)(card, on_card), make_recsys_serve_step(cfg)(cpu, batch))
    users = recsys.user_tower(cfg, card, on_card)
    close(users, recsys.user_tower(cfg, cpu, batch))
    items = {"item_embs": (rng.normal(size=(20000, cfg.embed_dim)) * 0.0625).astype(np.float32),
             "item_attrs": rng.integers(0, 3, (20000, 4)).astype(np.int32)}
    qa = rng.integers(0, 3, (b, 4)).astype(np.int32)
    f0 = fused_auto.launches
    cd, ci = (t.cpu() for t in make_recsys_retrieval_step(cfg, k=100, topk_shards=4)(
        card, {**on_card, "query_attrs": torch.from_numpy(qa).to(cuda_dev),
               **{k: torch.from_numpy(v).to(cuda_dev) for k, v in items.items()}}))
    assert fused_auto.launches == f0 + 1
    pd, pi = recsys.hybrid_retrieval_topk(users.cpu(), qa, items["item_embs"], items["item_attrs"],
                                          100, topk_shards=4)
    torch.testing.assert_close(cd, pd, rtol=1e-5, atol=1e-6)
    tie = 1e-6 + 1e-5 * pd.abs()
    for r, p in zip(*torch.nonzero(ci != pi, as_tuple=True)):
        near = (pd[r] - pd[r, p]).abs() <= 2 * tie[r, p]
        near[p] = False
        assert bool(near.any())


#: fm_interaction's gradient: the training shape (train_batch at the fm
#: widths) and B x F x D around a block's edges
FM_GRAD_SHAPES = [(65536, 39, 10)] + [(b, f, d) for b in (1, 255, 257) for f in (1, 39)
                                      for d in (1, 10, 64)]


@pytest.mark.parametrize("shape", FM_GRAD_SHAPES, ids=["x".join(map(str, s)) for s in FM_GRAD_SHAPES])
def test_fm_interaction_gradient_on_card_equals_cpu(cuda_dev, shape):
    """The autograd ``Function`` on the card: the forward is the kernel
    (one launch, equal to the plain version bit for bit) and the gradient
    under a random upstream equals the CPU's bit for bit (the same plain
    ops in the same order on both devices)."""
    g = torch.Generator().manual_seed(sum(shape))
    e = torch.randn(shape, generator=g) * 0.3
    up = torch.randn(shape[0], generator=g)

    def run(e, up):
        x = e.clone().requires_grad_(True)
        out = fm_interaction(x)
        return out.detach(), torch.autograd.grad(out, x, up)[0]

    n0 = fm_interaction.launches
    got_out, got_grad = run(e.to(cuda_dev), up.to(cuda_dev))
    torch.cuda.synchronize()
    assert fm_interaction.launches == n0 + 1
    assert torch.equal(got_out, fm_interaction_ref(e.to(cuda_dev)))
    assert torch.equal(got_grad.cpu(), run(e, up)[1])


def test_fm_train_step_on_card_trains_the_tables(cuda_dev):
    """Regression: the tables enter fm's loss only through fm_interaction,
    so a zero or missing ``tables`` gradient on the card means the kernel's
    result dropped out of autograd. The gradient equals the CPU's within
    1e-5·max|cpu| (scatter-adds on the card sum in another order), and a
    step moves the touched rows by more than the weight decay."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import loss_and_grads, make_recsys_train_step

    cfg = dataclasses.replace(fm.make_config(), vocab_per_field=1000)
    cpu = recsys.init_params(cfg, seed=0, device="cpu")
    card = {k: v.to(cuda_dev) for k, v in cpu.items()}
    batch = make_batch_fn(fm.SPEC, cfg, 512, 64, cuda_dev)(0)
    n0 = fm_interaction.launches
    _, grads = loss_and_grads(functools.partial(recsys.loss_fn, cfg), card, batch)
    torch.cuda.synchronize()
    assert fm_interaction.launches == n0 + 1
    gt = grads["tables"]
    assert gt is not None and gt.shape == card["tables"].shape and bool(gt.abs().sum() > 0)
    _, want = loss_and_grads(functools.partial(recsys.loss_fn, cfg), cpu,
                             {k: v.cpu() for k, v in batch.items()})
    assert float((gt.cpu() - want["tables"]).abs().max()) <= 1e-5 * float(
        want["tables"].abs().max())
    before = card["tables"].clone()
    opt = fm.SPEC.optim
    make_recsys_train_step(cfg, opt)(card, init_state(opt, card), batch)
    decayed = before - opt.lr * opt.weight_decay * before
    rows = batch["sparse"].long()[0]
    moved = (card["tables"][torch.arange(cfg.n_sparse, device=cuda_dev), rows]
             - decayed[torch.arange(cfg.n_sparse, device=cuda_dev), rows]).abs()
    assert bool((moved.amax(-1) > 1e-4).all())


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", ["fm", *sorted(RECSYS_CUT)])
def test_recsys_train_step_on_card_matches_cpu(cuda_dev, arch, prec):
    """One train step at full width with a cut vocabulary, the card against
    the CPU from the same parameters and batch: the loss, the gradient
    norm and every gradient within RECSYS_TOL·max|cpu| (under MIXED, a leaf
    past it passes where the CPU's own bf16 gradient lies further than
    that from its f32 gradient and the card's at most twice as far: two
    bf16 roundings of one f32 gradient); then
    ``apply_updates`` on the CPU's gradients on both devices, params and
    AdamW state within 1e-6·max|cpu| (the same f32 ops in the same order;
    ``pow`` and the norm's reduction round otherwise)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import common
    from repro_torch.train.optim import _global_norm, apply_updates, init_state
    from repro_torch.train.step import loss_and_grads

    spec = get_arch(arch)
    cut = RECSYS_CUT.get(arch, {"vocab_per_field": 1000})
    cfg = dataclasses.replace(spec.make_config(), precision=getattr(common, prec), **cut)
    tol = RECSYS_TOL[prec]
    cpu = recsys.init_params(cfg, seed=2, device="cpu")
    card = tree.tree_map(lambda t: t.to(cuda_dev), cpu)
    batch = make_batch_fn(spec, cfg, 32 if arch == "bert4rec" else 256, 64, "cpu")(3)
    fn = functools.partial(recsys.loss_fn, cfg)
    want_l, want_g = loss_and_grads(fn, cpu, batch)
    got_l, got_g = loss_and_grads(fn, card, {k: v.to(cuda_dev) for k, v in batch.items()})

    def close(got, want, t):
        scale = float(want.float().abs().max()) or 1.0
        assert float((got.float().cpu() - want.float()).abs().max()) <= t * scale

    close(got_l, want_l, tol)
    close(_global_norm(got_g), _global_norm(want_g), tol)
    want32 = tree.leaves(loss_and_grads(functools.partial(
        recsys.loss_fn, dataclasses.replace(cfg, precision=common.FP32)), cpu, batch)[1])
    for g, w, w32 in zip(tree.leaves(got_g), tree.leaves(want_g), want32):
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape
        g = g.cpu()
        scale = float(w.abs().max()) or 1.0
        if float((g - w).abs().max()) > tol * scale:  # bf16 rounding, not a fault:
            ref_off = float((w - w32).abs().max())  # the CPU's bf16 gradient is as far off
            assert prec == "MIXED" and ref_off > tol * scale
            assert float((g - w32).abs().max()) <= 2.0 * ref_off
    same = tree.tree_map(lambda t: t.to(cuda_dev), want_g)
    _, cpu_state, mc = apply_updates(spec.optim, cpu, want_g, init_state(spec.optim, cpu))
    _, card_state, mg = apply_updates(spec.optim, card, same, init_state(spec.optim, card))
    close(mg["grad_norm"], mc["grad_norm"], 1e-6)
    for g, w in zip(tree.leaves((card, card_state)), tree.leaves((cpu, cpu_state))):
        close(g, w, 1e-6)


@pytest.mark.parametrize("backend", ["graph", "brute"])
def test_serve_loop_on_card_equals_solo_searches(cuda_dev, backend):
    """256 requests from 4 tenants (MATCH, subset, ONE_OF and BETWEEN in
    turn, Poisson arrivals at 8,000 a second) through serve_loop at
    n = 20,000: every response equals its query searched alone, bit for
    bit (both kernels are batch-invariant on the card)."""
    ds = make_hybrid_dataset(n=20_000, n_queries=256, profile="sift", seed=0)
    eng = Engine.build(ds.features, ds.attrs, device=cuda_dev)
    arrivals = np.cumsum(np.random.default_rng(0).exponential(1 / 8000.0, 256))
    queries = []
    for i in range(256):
        v, a = ds.query_features[i], [int(x) for x in ds.query_attrs[i]]
        queries.append(Query(v, [
            [MATCH(x) for x in a],
            [MATCH(a[0]), MATCH(a[1]), ANY, ANY, ANY],
            [ONE_OF(a[0], (a[0] + 1) % 3)] + [MATCH(x) for x in a[1:]],
            [BETWEEN(0, 1)] + [MATCH(x) for x in a[1:]],
        ][i % 4]))
    params = SearchParams(k=10, backend=backend)
    trace = [(float(t), Request(f"t{i % 4}", q)) for i, (t, q) in enumerate(zip(arrivals, queries))]
    resp, stats = serve_loop(eng, trace, TenantRegistry(default_policy=TenantPolicy(params=params)),
                             window_ms=2.0, buckets=(1, 8, 32, 128))
    assert stats.completed == 256 and stats.batches < 256
    for q, r in zip(queries, resp):
        alone = eng.search(QueryBatch.from_queries([q]), params)
        assert np.array_equal(alone.ids[0].cpu().numpy(), r.ids)
        assert np.array_equal(alone.dists[0].cpu().numpy(), r.dists)


# ---------------------------------------------------------------------------
# the partitioned backend on the card
# ---------------------------------------------------------------------------


def _part_batches(ds, b: int = 64):
    """MATCH, subset, ONE_OF and BETWEEN batches of ``b`` float queries."""
    qf, qa = ds.query_features[:b], ds.query_attrs[:b]
    return {
        "match": QueryBatch.match(qf, qa),
        "subset": QueryBatch.match(qf, qa, active=[0, 1]),
        "one_of": QueryBatch.from_queries([
            Query(qf[i], [ONE_OF(int(a[0]), (int(a[0]) + 1) % 3), MATCH(int(a[1])), ANY,
                          MATCH(int(a[3])), MATCH(int(a[4]))]) for i, a in enumerate(qa)]),
        "between": QueryBatch.from_queries([
            Query(qf[i], [BETWEEN(0, 1), MATCH(int(a[1])), MATCH(int(a[2])), ANY, ANY])
            for i, a in enumerate(qa)]),
    }


@pytest.mark.parametrize("mode", ["none", "pq", "pq4"])
def test_partitioned_full_probe_bit_exact_on_float_data(cuda_dev, mode):
    """n = 20,000 float rows, P = 16: the full probe with the brute
    sub-backend equals the flat brute engine bit for bit on the four
    predicate kinds (the kernels give a row the same bits in any batch,
    tile or partition)."""
    from repro_torch.partition import row_bucket

    ds = make_hybrid_dataset(n=20_000, n_queries=64, profile="sift", seed=3)
    qc = QuantConfig(mode, pq_subspaces=32)
    flat = Engine.build(ds.features, ds.attrs, quant_cfg=qc, build_graph=False, device=cuda_dev)
    part = Engine.build_partitioned(ds.features, ds.attrs, n_partitions=16, quant_cfg=qc,
                                    build_graph=False, device=cuda_dev)
    buckets = [row_bucket(int(r)) for r in part.index.summaries.n_rows]
    part.index.set_residency(sum(buckets) // 2)  # stream under a cap as well
    for kind, q in _part_batches(ds).items():
        want = flat.search(q, SearchParams(k=10, backend="brute"))
        got = part.search(q, SearchParams(k=10, nprobe=16, sub_backend="brute"))
        for f in ("ids", "dists", "sqdists"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f"{mode}/{kind}: {f}"
    assert part.index.store.stats()["evictions"] > 0


def _part_store(dev, n_parts: int = 4, rows: int = 3000):
    from repro_torch.partition import PartitionData, SegmentStore

    rng = np.random.default_rng(0)
    parts = {pid: PartitionData(
        features=rng.standard_normal((rows + pid, 64)).astype(np.float32),
        attrs=rng.integers(0, 3, (rows + pid, 5)).astype(np.int32),
        graph=rng.integers(-1, rows, (rows + pid, 12)).astype(np.int32),
        codes=rng.integers(0, 256, (rows + pid, 32)).astype(np.uint8),
        row_ids=np.arange(rows + pid, dtype=np.int64) * n_parts + pid,
    ) for pid in range(n_parts)}
    return SegmentStore(parts.__getitem__, cap_rows=4096 * n_parts, device=dev)


def test_prefetched_partition_equals_a_synchronous_load(cuda_dev):
    """A partition staged by the prefetch worker on the store's copy stream
    and claimed on the default stream holds what a synchronous load holds,
    and a kernel queued on the default stream right after the claim reads
    it whole."""
    store = _part_store(cuda_dev)
    store.prefetch(1)
    store.prefetch(2)
    claimed = store.get(1)
    tail = claimed.features.sum(1)  # queued on the default stream at once
    assert store.stats()["prefetch_hits"] == 1
    sync = _part_store(cuda_dev)._materialize(1)
    for f in ("features", "attrs", "graph", "codes", "row_ids"):
        a, b = getattr(claimed, f), getattr(sync, f)
        assert a.device.type == "cuda" and torch.equal(a, b), f
    assert torch.equal(tail, sync.features.sum(1))
    assert torch.equal(store.get(2).row_ids, _part_store(cuda_dev)._materialize(2).row_ids)


def test_evict_all_returns_device_memory(cuda_dev):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    store = _part_store(cuda_dev)
    for pid in range(4):
        store.prefetch((pid + 1) % 4)
        store.get(pid)
    assert torch.cuda.memory_allocated() > before
    store.evict_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# streaming mutability on the card
# ---------------------------------------------------------------------------


def _integer(x):
    return np.clip(np.round(x / 33.5 * 4), -20, 20).astype(np.float32)


def _writes(m, f, a, n0: int, inserts: int, seed: int = 0):
    """``inserts`` new rows, 50 overwrites (integer-valued) and 50 deletes."""
    for i in range(n0, n0 + inserts):
        m.upsert(f[i], a[i], id=i)
    rng = np.random.default_rng(seed)
    picked = rng.choice(n0, 100, replace=False)
    for i in picked[:50]:
        m.upsert(f[i] + 1.0, (a[i] + 1) % 3, id=int(i))
    for i in picked[50:]:
        assert m.delete(int(i))


def _cpu_copy(idx):
    parts = (idx.features.cpu().numpy(), idx.attrs.cpu().numpy(), idx.graph.cpu().numpy())
    meta = [{k: getattr(c, k) for k in c.__dataclass_fields__}
            for c in (idx.metric_cfg, idx.help_cfg, idx.stats)]
    return index_from_numpy(*parts, *meta, device="cpu")


def _integer_store(idx, mode: str) -> tuple[dict, dict]:
    """(meta, arrays) of a codec store over ``idx``'s rows whose state is
    integer-valued (rounded centroids), so every ADC sum is exact."""
    store = QuantizedVectors.build(idx.features, QuantConfig(mode, pq_subspaces=16,
                                                             pq_train_iters=3))
    store.codebook.centroids.round_()
    meta = {"cfg": {k: getattr(store.cfg, k) for k in store.cfg.__dataclass_fields__},
            "dim": store.codebook.dim, "codec": codec_spec(store.cfg)}
    return meta, {"codes": store.encode_rows(idx.features).numpy(),
                  "centroids": store.codebook.centroids.numpy()}


@pytest.mark.parametrize("codec", ["none", "pq", "pq4"])
def test_merge_on_card_equals_cpu_on_integer_data(cuda_dev, codec):
    """n = 20,000 integer rows, 200 inserts, 50 overwrites and 50 deletes
    merged on the card and on the CPU: the same adjacency (and codes, for a
    codec with integer centroids), the same linked and repaired counts, and
    the same federated searches on both backends after it."""
    from repro_torch.mutable import CompactionPolicy, MutableEngine

    ds = make_hybrid_dataset(n=20_200, n_queries=64, profile="sift", seed=0)
    f, qf = _integer(ds.features), _integer(ds.query_features)
    built = _cpu_copy(Engine.build(f[:20_000], ds.attrs[:20_000], device=cuda_dev).index)
    parts = (built.features.numpy(), built.attrs.numpy(), built.graph.numpy())
    meta = [{k: getattr(c, k) for k in c.__dataclass_fields__}
            for c in (built.metric_cfg, built.help_cfg, built.stats)]
    store = None if codec == "none" else _integer_store(built, codec)
    q = QueryBatch.match(qf, ds.query_attrs)
    out = {}
    for dev in (cuda_dev, torch.device("cpu")):
        quant = None if store is None else quant_from_numpy(*store, dev)
        m = MutableEngine(Engine(index_from_numpy(*parts, *meta, device=dev, quant=quant)),
                          CompactionPolicy(max_delta_rows=10 ** 9))
        _writes(m, f, ds.attrs, 20_000, 200)
        stats = m.merge()
        res = [m.search(q, SearchParams(k=10, backend=b)) for b in ("graph", "brute")]
        codes = None if codec == "none" else m.index.quant.codes.cpu()
        out[dev.type] = (m.index.graph.cpu(), stats, res, codes)
    card, cpu = out["cuda"], out["cpu"]
    assert torch.equal(card[0], cpu[0])
    for key in ("linked", "repaired", "tombstones", "n_main"):
        assert card[1][key] == cpu[1][key], key
    for a, b in zip(card[2], cpu[2]):
        assert torch.equal(a.ids.cpu(), b.ids) and torch.equal(a.sqdists.cpu(), b.sqdists)
        assert torch.equal(torch.as_tensor(a.n_code_evals).cpu(), torch.as_tensor(b.n_code_evals))
    if codec != "none":
        assert torch.equal(card[3], cpu[3])


@pytest.mark.parametrize("scan", ["oracle", "soft", "enforce"])
def test_delta_scan_on_card_equals_plain_version(cuda_dev, scan):
    """The delta segment's fused_auto scan on the card against the same
    segment on the CPU (the plain version) on integer rows: equal ids and
    distances for the four predicate kinds; 300 rows (one capacity
    doubling), overwrites and kills mirrored on the device."""
    from repro_torch.core.auto import MetricConfig
    from repro_torch.mutable import DeltaSegment

    ds = make_hybrid_dataset(n=300, n_queries=32, profile="sift", seed=2)
    f, qf = _integer(ds.features), _integer(ds.query_features)
    segs = {}
    for dev in (cuda_dev, torch.device("cpu")):
        d = DeltaSegment(f.shape[1], ds.attrs.shape[1], device=dev)
        for i in range(300):
            d.append(i % 280, f[i], ds.attrs[i])
        for i in range(0, 280, 7):
            d.kill(i)
        segs[dev.type] = d
    cfg = MetricConfig(mode="auto", alpha=ALPHA)
    for kind, q in _part_batches(SimpleNamespace(query_features=qf,
                                                 query_attrs=ds.query_attrs), 32).items():
        f0 = fused_auto.launches
        got = segs["cuda"].topk(q, 10, cfg, oracle=scan == "oracle", enforce=scan == "enforce")
        want = segs["cpu"].topk(q, 10, cfg, oracle=scan == "oracle", enforce=scan == "enforce")
        assert fused_auto.launches == f0 + 1
        assert torch.equal(got[0].cpu(), want[0]), kind
        assert torch.equal(got[1].cpu(), want[1]), kind


def test_merge_releases_the_old_index(cuda_dev):
    """After a merge swaps the index, the old index's device memory is
    freed once nothing holds it: what stays allocated above the engine's
    own footprint is the appended rows and small buffers, not a second
    index."""
    import gc

    from repro_torch.mutable import CompactionPolicy, MutableEngine

    ds = make_hybrid_dataset(n=20_300, n_queries=8, profile="sift", seed=4)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    m = MutableEngine(Engine.build(ds.features[:20_000], ds.attrs[:20_000], device=cuda_dev),
                      CompactionPolicy(max_delta_rows=10 ** 9))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    idx = m.index
    index_bytes = sum(t.numel() * t.element_size() for t in (idx.features, idx.attrs, idx.graph))
    del idx
    _writes(m, ds.features, ds.attrs, 20_000, 300)
    assert m.merge()["linked"] == 350
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_allocated() - base
    row_bytes = index_bytes // 20_000
    assert grown < 300 * row_bytes + index_bytes // 4, (grown, index_bytes)


# ---------------------------------------------------------------------------
# hot/cold tiering on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiered_case():
    """A float sift-profile corpus at n = 20,000 on the card with a graph
    and a pq codec (S = 16), and 64 queries per predicate kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    ds = make_hybrid_dataset(n=20_000, n_queries=64, profile="sift", seed=6)
    eng = Engine.build(ds.features, ds.attrs, quant_cfg=QuantConfig("pq", pq_subspaces=16),
                       device="cuda")
    return ds, eng


@pytest.mark.parametrize("enforce", [False, True])
@pytest.mark.parametrize("kind", ["match", "one_of", "between"])
def test_rerank_gathered_equals_emit_topk_on_card(tiered_case, kind, enforce):
    """The pool head's rows staged in a buffer of their own (half from a
    device slice, half copied from the host) and scored by
    ``rerank_gathered`` give the bits ``emit_topk`` gives over
    ``idx.features``: the kernel's per-pair sum does not depend on where a
    row sits."""
    from repro_torch.cache import HotTier
    from repro_torch.core import routing

    ds, eng = tiered_case
    idx = eng.index
    q = _part_batches(ds)[kind]
    dev = idx.features.device
    qv = torch.from_numpy(q.vectors).to(dev)
    qa = torch.from_numpy(np.ascontiguousarray(q.targets)).to(dev)
    cfg = routing.RoutingConfig(k=10, pool_size=40, quant_mode="pq", enforce_equality=enforce)
    entry = routing.make_entry_ids(idx.features.shape[0], qv.shape[0], 40, 0, device=dev)
    r_ids, evals, hops = routing.search_pool(idx.attrs, idx.graph, qv, qa, entry, idx.metric_cfg,
                                             cfg, idx.features.shape[0], None,
                                             idx.quant.routing_operand(qv))
    tier = HotTier(idx.features.cpu().numpy(), hot_rows=10_000, device=dev)
    counts = np.zeros(idx.features.shape[0])
    counts[r_ids.cpu().numpy()[:, ::2].ravel().clip(0)] = 1.0
    tier.promote(counts)
    cv = tier.gather(r_ids.cpu().numpy())
    st = tier.stats()
    assert st["hot_row_hits"] > 0 and st["cold_row_gathers"] > 0
    g0 = gather_auto.launches
    got = routing.rerank_gathered(cv, idx.attrs, r_ids, qv, qa, idx.metric_cfg, cfg, None,
                                  evals, hops)
    assert gather_auto.launches == g0 + 1
    want = routing.search(idx.features, idx.attrs, idx.graph, qv, qa, idx.metric_cfg, cfg,
                          entry_ids=entry, quant=idx.quant)
    for field in ("ids", "dists", "sqdists", "n_dist_evals", "n_code_evals"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("backend", ["graph", "brute"])
@pytest.mark.parametrize("codec", ["pq", "pq4"])
def test_tiered_engine_on_card_equals_untiered(tiered_case, codec, backend):
    """n = 20,000: a TieredEngine (the brute backend through
    ``_TieredBruteSearcher``, the graph backend through ``search_pool`` and
    ``rerank_gathered``) equals the untiered engine bit for bit cold, warm
    and churned, on the four predicate kinds."""
    from repro_torch.cache import TieredEngine

    ds, eng = tiered_case
    if codec == "pq4":
        store = QuantizedVectors.build(eng.index.features, QuantConfig("pq4", pq_subspaces=16))
        eng = Engine(dataclasses.replace(eng.index, quant=store))
    params = SearchParams(k=10, backend=backend)
    batches = _part_batches(ds)
    refs = {kind: eng.search(q, params) for kind, q in batches.items()}
    tiered = TieredEngine(eng, hot_rows=2_500, epoch_queries=64)
    for state in ("cold", "warm", "churned"):
        if state == "churned":
            tiered.tracker.observe(np.tile(np.arange(5_000, 7_000), 4))
            tiered.refresh_tier()
        for kind, q in batches.items():
            got = tiered.search(q, params)
            for field in ("ids", "dists", "sqdists", "n_dist_evals", "n_code_evals"):
                assert torch.equal(getattr(got, field), getattr(refs[kind], field)), (
                    state, kind, field)
    st = tiered.tier_stats()
    assert st["hot_row_hits"] > 0 and st["cold_row_gathers"] > 0 and st["demotions"] > 0


@pytest.fixture(scope="module")
def sharded_case():
    """Float sift-profile data, n = 8,192, on a (data=1, model=4) mesh on
    the card: the exact sharded index and a pq one (S = 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from repro_torch.core.auto import MetricConfig, sample_stats
    from repro_torch.distributed import ShardedStableIndex
    from repro_torch.launch.mesh import make_local_mesh

    ds = make_hybrid_dataset(n=8_192, n_queries=64, profile="sift", seed=3)
    mc = MetricConfig(alpha=sample_stats(ds.features, ds.attrs).alpha)
    mesh = make_local_mesh(1, 4)
    return ds, mc, {codec: ShardedStableIndex.build(mesh, ds.features, ds.attrs, mc,
                                                    quant_cfg=QuantConfig(codec, pq_subspaces=16))
                    for codec in ("none", "pq")}


def test_sharded_exhaustive_merge_on_card_equals_brute_oracle(sharded_case):
    """Pool = shard rows: each shard's search is exhaustive, so the merge
    equals a brute oracle that scores every row with the same kernel
    (gather_auto over all ids, then the stable top-k): sqdists bit for bit,
    ids except at exact ties."""
    from repro_torch.core.graph_ops import smallest_k
    from repro_torch.core.routing import RoutingConfig
    from repro_torch.distributed import ShardedStableIndex
    from repro_torch.launch.mesh import make_local_mesh

    ds, mc, _ = sharded_case
    n = 2_048
    idx = ShardedStableIndex.build(make_local_mesh(1, 4), ds.features[:n], ds.attrs[:n], mc)
    cfg = RoutingConfig(k=10, pool_size=n // 4, pioneer_size=16, refine_max_iters=n)
    res = idx.search(ds.query_features, ds.query_attrs, k=10, routing_cfg=cfg)
    dev = idx.device
    qv = torch.from_numpy(ds.query_features).to(dev)
    every = torch.arange(n, dtype=torch.int32, device=dev).expand(len(qv), -1).contiguous()
    want_sq, want_ids = smallest_k(gather_auto(
        qv, torch.from_numpy(ds.query_attrs).to(dev), torch.from_numpy(ds.features[:n]).to(dev),
        torch.from_numpy(ds.attrs[:n]).to(dev), every, mc.alpha, mc.mode), 10)
    assert torch.equal(res.sqdists, want_sq)
    for r, p in zip(*torch.nonzero(res.ids != want_ids.to(torch.int32), as_tuple=True)):
        assert int((want_sq[r] == want_sq[r, p]).sum()) > 1


@pytest.mark.parametrize("codec", ["none", "pq"])
def test_sharded_data_axis_bit_equal_on_card(sharded_case, codec):
    """data=2 and data=1 give the same ids and sqdists bit for bit, on the
    four predicate kinds."""
    from repro_torch.launch.mesh import make_local_mesh

    ds, _, idxs = sharded_case
    one = Engine(idxs[codec])
    two = Engine(dataclasses.replace(idxs[codec], mesh=make_local_mesh(2, 4)))
    for kind, q in _part_batches(ds).items():
        a, b = one.search(q, SearchParams(k=10)), two.search(q, SearchParams(k=10))
        for field in ("ids", "sqdists", "n_dist_evals", "n_code_evals"):
            assert torch.equal(getattr(a, field), getattr(b, field)), (kind, field)


@pytest.mark.parametrize("codec", ["none", "pq"])
def test_sharded_save_load_on_card_bit_equal(sharded_case, codec, tmp_path):
    ds, _, idxs = sharded_case
    eng = Engine(idxs[codec])
    eng.save(str(tmp_path / codec))
    back = Engine.load(str(tmp_path / codec))
    assert back.is_sharded and back.index.mesh.shape == {"data": 1, "model": 4}
    for name in ("features", "attrs", "graphs") + (("codes",) if codec == "pq" else ()):
        assert torch.equal(getattr(back.index, name), getattr(idxs[codec], name)), name
    for kind, q in _part_batches(ds).items():
        a, b = eng.search(q, SearchParams(k=10)), back.search(q, SearchParams(k=10))
        for field in ("ids", "sqdists", "n_dist_evals", "n_code_evals", "n_hops"):
            assert torch.equal(getattr(a, field), getattr(b, field)), (kind, field)


# ---------------------------------------------------------------------------
# the LM family (no kernel of the port lies on it: plain PyTorch on the card)
# ---------------------------------------------------------------------------

LM_IDS = ("kimi-k2-1t-a32b", "mistral-large-123b", "mixtral-8x7b", "phi3-mini-3.8b", "yi-34b")
#: |Δ| ≤ tol·max|cpu| (tests/test_torch_lm.py states both); under MIXED a
#: MoE token within LM_EPS of a router tie, or whose rank such a tie could
#: move across the capacity, may route otherwise and is left out
LM_TOL, LM_EPS = {"FP32": 1e-5, "MIXED": 0.03}, 0.01


def _lm(arch, prec, dev):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import common
    from repro_torch.models import transformer as tfm

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev, copy=True) for k, v in tree.items()}

    cfg = dataclasses.replace(get_arch(arch).make_reduced(), precision=getattr(common, prec))
    cpu = tfm.init_params(cfg, seed=2, device="cpu")
    return cfg, cpu, to(cpu)


def _lm_close(got, want, tol, unsure=None):
    g, w = got.float().cpu(), want.float()
    err = (g - w).abs()
    if unsure is not None:
        err = err[~unsure]
    assert err.numel() == 0 or float(err.max()) <= tol * float(w.abs().max())


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_reduced_on_card_matches_cpu(cuda_dev, arch, prec):
    """forward at (2, 96), forward_last, loss_fn and 40 decode tokens
    against a cache of 36 rows: the card against the CPU with the same
    parameters."""
    from repro_torch.models import transformer as tfm

    cfg, cpu, card = _lm(arch, prec, cuda_dev)
    tol = LM_TOL[prec]
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96), dtype=np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96), dtype=np.int32))

    def unsettled(stats, shape):
        if prec == "FP32" or not cfg.moe:
            return torch.zeros(shape, dtype=torch.bool)
        return tfm.unsettled_tokens(cfg, stats["router_logits"], LM_EPS).view(shape)

    stats = {}
    want = tfm.forward(cfg, cpu, tokens, stats)
    unsure = unsettled(stats, (2, 96))
    assert float(unsure.float().mean()) <= 0.5
    _lm_close(tfm.forward(cfg, card, tokens.to(cuda_dev)), want, tol, unsure)
    _lm_close(tfm.forward_last(cfg, card, tokens.to(cuda_dev)),
              tfm.forward_last(cfg, cpu, tokens), tol, unsure[:, -1])
    batch = {"tokens": tokens, "labels": labels}
    _lm_close(tfm.loss_fn(cfg, card, {k: v.to(cuda_dev) for k, v in batch.items()})[None],
              tfm.loss_fn(cfg, cpu, batch)[None], tol)
    caches = [tfm.init_cache(cfg, 2, 36, device=d) for d in ("cpu", cuda_dev)]
    n_unsure = 0
    for _ in range(40):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32))
        st = {}
        _, w = tfm.decode_step(cfg, cpu, caches[0], t, st)
        _, g = tfm.decode_step(cfg, card, caches[1], t.to(cuda_dev))
        u = unsettled(st, (2,))
        n_unsure += int(u.sum())
        _lm_close(g, w, tol, u)
    assert n_unsure <= 40 and int(caches[1]["len"]) == 40


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "yi-34b"])
def test_lm_decode_equals_prefill_on_card(cuda_dev, arch):
    """A 64-token prompt decoded token by token from an empty cache: each
    position's logits against forward's there, within 0.03 of max|forward|
    at that position (MIXED)."""
    from repro_torch.models import transformer as tfm

    cfg, _, card = _lm(arch, "MIXED", cuda_dev)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 64), dtype=np.int32)).to(cuda_dev)
    want = tfm.forward(cfg, card, prompt)[0]
    cache = tfm.init_cache(cfg, 1, 64, device=cuda_dev)
    for pos in range(64):
        _, got = tfm.decode_step(cfg, card, cache, prompt[:, pos:pos + 1])
        _lm_close(got[0], want[pos].cpu(), LM_TOL["MIXED"])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_lm_decode_and_moe_never_wait_for_the_host(cuda_dev, arch):
    """decode_step (and moe_ffn alone) under sync debug mode "error": no
    operation on their path synchronises with the host."""
    from repro_torch.models import transformer as tfm

    cfg, _, card = _lm(arch, "MIXED", cuda_dev)
    cache = tfm.init_cache(cfg, 3, 36, device=cuda_dev)
    tokens = torch.zeros((3, 1), dtype=torch.int32, device=cuda_dev)
    x = torch.randn((40, cfg.d_model), device=cuda_dev).bfloat16()
    lp = {k: v[0] for k, v in card["layers"]["ffn"].items()}
    tfm.decode_step(cfg, card, cache, tokens)  # allocate outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            tfm.decode_step(cfg, card, cache, tokens)
        if cfg.moe:
            tfm.moe_ffn(cfg, x, lp, {})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache["len"]) == 4


# ---------------------------------------------------------------------------
# LM training and the GNN (no kernel of the port lies on either: plain
# PyTorch on the card, held to the CPU)
# ---------------------------------------------------------------------------


def _tree_close(got, want, tol, want32=None):
    """Every leaf within tol·max|cpu|; with ``want32`` (the CPU's f32
    gradients) a bf16 leaf past it passes where the CPU's own bf16 leaf
    lies further than that from the f32 one and the card's at most twice
    as far."""
    from repro_torch.core import tree

    w32s = tree.leaves(want32) if want32 is not None else [None] * len(tree.leaves(want))
    for (name, g), w, w32 in zip(tree.flatten_with_paths(got), tree.leaves(want), w32s):
        g, w = g.float().cpu(), w.float()
        scale = tol * float(w.abs().max())
        err = float((g - w).abs().max()) if w.numel() else 0.0
        if err <= scale:
            continue
        assert w32 is not None, f"{name}: max|Δ| {err:.3e} > {scale:.3e}"
        ref_off = float((w - w32).abs().max())
        assert ref_off > scale and float((g - w32).abs().max()) <= 2.0 * ref_off, name


def _lm_train_batch(cfg, spec, prec):
    """(batch, micro_batches): (8, 16) tokens with the spec's micro_batches;
    a MoE config under MIXED takes the 2-token sequences (the spec's
    micro_batches of them from each of 8 seeds) no router near-tie
    unsettles on the CPU, a micro-batch each (at least half of them)."""
    from repro_torch.models import transformer as tfm

    if not (cfg.moe and prec == "MIXED"):
        rng = np.random.default_rng(5)
        return ({k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16), dtype=np.int32))
                 for k in ("tokens", "labels")}, spec.micro_batches)
    params = tfm.init_params(cfg, seed=2, device="cpu")
    held, total = [], 0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        t, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (spec.micro_batches, 2),
                                                dtype=np.int32)) for _ in range(2))
        for j in range(spec.micro_batches):
            total += 1
            stats = {}
            with torch.no_grad():
                tfm.forward(cfg, params, t[j:j + 1], stats)
            if not bool(tfm.unsettled_tokens(cfg, stats["router_logits"], LM_EPS).any()):
                held.append((t[j:j + 1], lab[j:j + 1]))
    assert len(held) >= total / 2
    return ({"tokens": torch.cat([t for t, _ in held]),
             "labels": torch.cat([x for _, x in held])}, len(held))


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_train_step_on_card_matches_cpu(cuda_dev, arch, prec):
    """One micro-batched step's loss, gradient norm and accumulated
    gradients (the spec's micro_batches; MoE under MIXED on the settled
    sequences) on the card against the CPU, from the same parameters;
    then make_lm_train_step's updated parameters within 2·lr + 1e-6."""
    import functools

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.models import common
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import _global_norm, init_state
    from repro_torch.train.step import _split_leading, accumulated_grads, make_lm_train_step

    spec = get_arch(arch)
    cfg, cpu, card = _lm(arch, prec, cuda_dev)
    batch, micro = _lm_train_batch(cfg, spec, prec)
    card_batch = {k: v.to(cuda_dev) for k, v in batch.items()}
    fn = functools.partial(tfm.loss_fn, cfg)
    want_l, want_g = accumulated_grads(fn, cpu, batch, micro, _split_leading)
    got_l, got_g = accumulated_grads(fn, card, card_batch, micro, _split_leading)
    want32 = None
    if prec == "MIXED":
        fn32 = functools.partial(tfm.loss_fn, dataclasses.replace(cfg, precision=common.FP32))
        want32 = accumulated_grads(fn32, cpu, batch, micro, _split_leading)[1]
    tol = LM_TOL[prec]
    _lm_close(got_l[None], want_l[None], tol)
    _lm_close(_global_norm(got_g)[None], _global_norm(want_g)[None], tol)
    _tree_close(got_g, want_g, tol, want32)
    step = make_lm_train_step(cfg, spec.optim, micro)
    cpu, _, mc = step(cpu, init_state(spec.optim, cpu), batch)
    card, _, mg = step(card, init_state(spec.optim, card), card_batch)
    _lm_close(mg["loss"][None], mc["loss"][None], tol)
    for a, b in zip(tree.leaves(card), tree.leaves(cpu)):
        assert float((a.cpu().float() - b.float()).abs().max()) <= 2 * spec.optim.lr + 1e-6


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_remat_changes_no_gradient_on_card(cuda_dev, arch):
    """On the card, the gradients with every layer checkpointed equal those
    without, bit for bit (MIXED, one (2, 16) micro-batch)."""
    import functools

    from repro_torch.core import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.train.step import loss_and_grads

    cfg, _, card = _lm(arch, "MIXED", cuda_dev)
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)).to(cuda_dev)
             for k in ("tokens", "labels")}
    on = loss_and_grads(functools.partial(tfm.loss_fn, cfg), card, batch)
    off = loss_and_grads(functools.partial(tfm.loss_fn, dataclasses.replace(cfg, remat=False)),
                         card, batch)
    assert torch.equal(on[0], off[0])
    for (name, a), b in zip(tree.flatten_with_paths(on[1]), tree.leaves(off[1])):
        assert torch.equal(a, b), name


def _gnn_batch(cfg, seed=3, n=64, e=256):
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.arange(n), rng.integers(0, n, e)]).astype(np.int32)
    out = {"node_feats": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
           "src": rng.integers(0, n, dst.size).astype(np.int32), "dst": dst,
           "edge_mask": rng.random(dst.size) < 0.8,
           "targets": rng.normal(size=(n, cfg.d_out)).astype(np.float32),
           "node_mask": (rng.random(n) < 0.7).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_gnn_steps_on_card_match_cpu(cuda_dev, prec, aggregator):
    """graphcast-smoke on a 64-node graph (mean in-degree 5, masks): the
    loss and gradients, make_gnn_train_step's loss and updated parameters
    (within 2·lr + 1e-6) and make_gnn_infer_step's output on the card
    against the CPU."""
    import functools

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.models import common, gnn
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import loss_and_grads, make_gnn_infer_step, make_gnn_train_step

    spec = get_arch("graphcast")
    cfg = dataclasses.replace(spec.make_reduced(), precision=getattr(common, prec),
                              aggregator=aggregator)
    cpu = gnn.init_params(cfg, seed=4, device="cpu")
    card = {k: {n: v.to(cuda_dev, copy=True) for n, v in d.items()} for k, d in cpu.items()}
    batch = _gnn_batch(cfg)
    card_b = {k: v.to(cuda_dev) for k, v in batch.items()}
    tol = LM_TOL[prec]
    fn = functools.partial(gnn.loss_fn, cfg)
    want_l, want_g = loss_and_grads(fn, cpu, batch)
    got_l, got_g = loss_and_grads(fn, card, card_b)
    want32 = None
    if prec == "MIXED":
        fn32 = functools.partial(gnn.loss_fn, dataclasses.replace(cfg, precision=common.FP32))
        want32 = loss_and_grads(fn32, cpu, batch)[1]
    _lm_close(got_l[None], want_l[None], tol)
    _tree_close(got_g, want_g, tol, want32)
    infer = make_gnn_infer_step(cfg)
    _lm_close(infer(card, card_b), infer(cpu, batch), tol)
    step = make_gnn_train_step(cfg, spec.optim)
    cpu, _, mc = step(cpu, init_state(spec.optim, cpu), batch)
    card, _, mg = step(card, init_state(spec.optim, card), card_b)
    _lm_close(mg["loss"][None], mc["loss"][None], tol)
    for a, b in zip(tree.leaves(card), tree.leaves(cpu)):
        assert float((a.cpu() - b).abs().max()) <= 2 * spec.optim.lr + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["scatter_sum", "scatter_max", "scatter_mean",
                                "degree_normalized_adjacency_apply"])
def test_graph_ops_on_card_match_cpu(cuda_dev, op, dtype):
    """The four graph ops on the card against the CPU, with dropped ids
    (−1, n, n + 3), empty segments and tied maxima: the max bit for bit
    (no sum), the others within 1e-6·max (f32, sums in another order) or
    one bf16 step (a sum in f32 rounded once); the gradients alike, but a
    bf16 input's gradient through the gather of
    ``degree_normalized_adjacency_apply`` within 0.03·max (the gather's
    backward adds in bf16, one term at a time on the CPU; 2 steps apart at
    ≈ 12 terms a row)."""
    from repro_torch.core import graph_ops

    n, e = 16, 200
    rng = np.random.default_rng(7)
    m = torch.from_numpy((rng.integers(-8, 9, (e, 8)) * 0.5).astype(np.float32)).to(
        getattr(torch, dtype))
    dst = torch.from_numpy(np.concatenate([rng.integers(0, n - 2, e - 4), [-1, n, n + 3, -1]])
                           .astype(np.int32))
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    up = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    if op == "degree_normalized_adjacency_apply":
        dst = dst.clamp(0, n - 1)

    def run(dev):
        x = m.to(dev).requires_grad_(True)
        fn = getattr(graph_ops, op)
        y = fn(x[:n], src.to(dev), dst.to(dev), n) if op.startswith("degree") else \
            fn(x, dst.to(dev), n)
        yf = y.float()
        (g,) = torch.autograd.grad((torch.where(torch.isfinite(yf), yf, 0.0) * up.to(dev)).sum(),
                                   x)
        return y.detach().cpu(), g.cpu()

    (y_card, g_card), (y_cpu, g_cpu) = run(cuda_dev), run("cpu")
    assert y_card.dtype == y_cpu.dtype
    if op == "scatter_max":
        assert torch.equal(y_card, y_cpu) and torch.equal(g_card, g_cpu)
        return
    tol = 1e-6 if dtype == "float32" else 2.0**-8
    grad_tol = 0.03 if dtype == "bfloat16" and op.startswith("degree") else tol
    for got, want, t in ((y_card, y_cpu, tol), (g_card, g_cpu, grad_tol)):
        assert float((got.float() - want.float()).abs().max()) <= t * float(
            want.float().abs().max())


# ---------------------------------------------------------------------------
# The sharded and dry-run side on the card
# ---------------------------------------------------------------------------


def test_ring_matmuls_on_card_equal_the_plain_partial_sums(cuda_dev):
    """Both ring matmuls on a (data 1, model 4) mesh on the one card: each
    shard's result is the plain sum of the same partials in ring order,
    bit for bit, and within 1e-5·max of one matmul."""
    from repro_torch.distributed.collective_matmul import (
        ring_allreduce_matmul, ring_reduce_scatter_matmul,
    )
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 4)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    x = torch.randn((1024, 2048), generator=g, device=cuda_dev)
    w = torch.randn((2048, 512), generator=g, device=cuda_dev)
    xs = NamedSharding(mesh, P(None, "model")).split(x)
    ws = NamedSharding(mesh, P("model", None)).split(w)
    partials = [torch.matmul(a, b) for a, b in zip(xs, ws)]

    def ring_order(parts, i):
        acc = parts[(i + 1) % 4]
        for s in range(2, 5):
            acc = acc + parts[(i + s) % 4]
        return acc

    ar = ring_allreduce_matmul(mesh, xs, ws)
    rs = ring_reduce_scatter_matmul(mesh, xs, ws)
    for i in range(4):
        assert ar[i].is_cuda and torch.equal(ar[i], ring_order(partials, i))
        assert torch.equal(rs[i], ring_order([p[i * 256:(i + 1) * 256] for p in partials], i))
    ref = torch.matmul(x, w)  # f32: PyTorch leaves TF32 off for matmuls by default
    assert float((torch.cat(rs) - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_build_cell_fm_train_arguments_on_card_hold_the_dry_run_bytes(cuda_dev):
    """fm's train_batch cell built on a (1, 1) mesh: its arguments drawn on
    the card (the initialisers, the AdamW state, the launcher's batch)
    request exactly the dry run's argument bytes, and one step counts on
    the card the FLOPs the meta count counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree as tree_mod
    from repro_torch.distributed.sharding import sharded_bytes
    from repro_torch.launch import dryrun
    from repro_torch.launch.build import build_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.train.optim import init_state

    spec = get_arch("fm")
    cell = spec.cell("train_batch")
    mesh = make_local_mesh(1, 1)
    build = build_cell(spec, cell, mesh)
    want = sharded_bytes(mesh, build.abstract_args, build.in_specs)
    meta_flops = dryrun.count_step(build)["flops"]
    warm = torch.zeros(1, device=cuda_dev)  # the allocator's statistics exist from here
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    cfg = spec.make_config()
    params = recsys.init_params(cfg, 0, cuda_dev)
    args = (params, init_state(spec.optim, params),
            make_batch_fn(spec, cfg, cell.global_batch, 64, cuda_dev)(0))
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["requested_bytes.all.current"] - before == want
    assert [(tuple(t.shape), t.dtype) for t in tree_mod.leaves(args)] == \
        [(tuple(t.shape), t.dtype) for t in tree_mod.leaves(build.abstract_args)]
    before = fm_interaction.launches
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = build.step(*args)
    assert fc.get_total_flops() == meta_flops
    assert fm_interaction.launches > before and bool(torch.isfinite(metrics["loss"]))
    del warm
