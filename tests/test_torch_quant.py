"""The port's codecs (``repro_torch.quant``) against the reference's
(``repro.quant``) on the same numpy inputs: sq8 codes bit-equal, nibble
packing exact, PQ codes equal under one codebook except at near-ties
(each miss shown to be a tie), ADC tables within rtol 1e-6, trained
codebooks with reconstruction error within 2% of the reference's for the
same seed, and the codec spec rejecting what the reference rejects."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import dataset  # noqa: E402
from repro import quant as jq  # noqa: E402
from repro_torch import quant as tq  # noqa: E402

MODES = ("sq8", "pq", "pq4", "opq-pq", "opq-pq4")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def floats():
    f, _, qf, _ = dataset(n=2000, n_queries=16, integer=False, seed=3)
    return f, qf


def test_sq8_codes_and_params_bit_equal(floats):
    f, qf = floats
    jcodes, jp = jq.sq8_encode(jnp.asarray(f))
    tcodes, tp = tq.sq8_encode(t(f))
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.zero), tp.zero.numpy())
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    # frozen params on unseen rows (queries fall outside the fitted range)
    np.testing.assert_array_equal(
        np.asarray(jq.sq8_encode(jnp.asarray(qf), jp)[0]), tq.sq8_encode(t(qf), tp)[0].numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jq.sq8_decode(jcodes, jp)), tq.sq8_decode(tcodes, tp).numpy()
    )


@pytest.mark.parametrize("s", [1, 7, 8, 33])
def test_nibble_pack_unpack_exact(s):
    codes = np.random.default_rng(s).integers(0, 16, size=(57, s))
    jpacked = np.asarray(jq.pack_nibbles(jnp.asarray(codes, jnp.int32)))
    tpacked = tq.pack_nibbles(t(codes))
    assert tpacked.dtype == torch.uint8 and tuple(tpacked.shape) == (57, (s + 1) // 2)
    np.testing.assert_array_equal(jpacked, tpacked.numpy())
    np.testing.assert_array_equal(tq.unpack_nibbles(tpacked, s).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jq.unpack_nibbles(jnp.asarray(jpacked), s)), tq.unpack_nibbles(tpacked, s).numpy()
    )
    if s % 2:  # the pad nibble is zero
        assert (tpacked.numpy()[:, -1] >> 4 == 0).all()


@pytest.fixture(scope="module")
def jax_codebook(floats):
    f, _ = floats
    return jq.pq_train(jnp.asarray(f), n_subspaces=16, n_centroids=64, n_iters=4, seed=0)


def test_pq_encode_equal_except_at_near_ties(floats, jax_codebook):
    """Both packages encode with the reference's codebook. A code may
    differ only where the two nearest centroids are within f32 rounding of
    each other (|Δd²| ≤ 1e-5 of d² in f64); at most 0.5% of codes may."""
    f, _ = floats
    cents = np.asarray(jax_codebook.centroids)
    jcodes = np.asarray(jq.pq_encode(jnp.asarray(f), jax_codebook))
    tcodes = tq.pq_encode(t(f), tq.PQCodebook(t(cents), jax_codebook.dim)).numpy()
    assert tcodes.dtype == np.uint8
    miss = np.argwhere(jcodes != tcodes)
    assert len(miss) <= 0.005 * jcodes.size, len(miss)
    xs = f.reshape(len(f), 16, -1).astype(np.float64)  # M = 128: no padding
    for n, s in miss:
        d = ((xs[n, s][None, :] - cents[s].astype(np.float64)) ** 2).sum(-1)
        dj, dt = d[jcodes[n, s]], d[tcodes[n, s]]
        assert abs(dj - dt) <= 1e-5 * max(dj, dt, 1e-6), (n, s, dj, dt)


def test_adc_lut_within_rtol(floats, jax_codebook):
    """Each entry ‖q_s − c‖² by the ‖q‖² + ‖c‖² − 2q·c decomposition:
    within rtol 1e-6, plus the cancellation bound 1e-6·(‖q_s‖² + ‖c‖²)."""
    _, qf = floats
    cb = tq.PQCodebook(t(np.asarray(jax_codebook.centroids)), jax_codebook.dim)
    want = np.asarray(jq.adc_lut(jnp.asarray(qf), jax_codebook), np.float64)
    got = tq.adc_lut(t(qf), cb).numpy().astype(np.float64)
    qs = qf.reshape(len(qf), 16, -1).astype(np.float64)
    cents = np.asarray(jax_codebook.centroids, np.float64)
    norms = (qs ** 2).sum(-1)[:, :, None] + (cents ** 2).sum(-1)[None]
    assert got.shape == want.shape and (got >= 0).all()
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-6 * norms).all()


def test_adc_gathered_sqdist_matches_reference():
    rng = np.random.default_rng(4)
    lut = rng.integers(0, 50, size=(3, 6, 16)).astype(np.float32)
    codes = rng.integers(0, 16, size=(3, 11, 6))
    want = np.asarray(jq.adc_gathered_sqdist(jnp.asarray(lut), jnp.asarray(codes, jnp.int32)))
    np.testing.assert_array_equal(tq.adc_gathered_sqdist(t(lut), t(codes)).numpy(), want)


def _pq_mse(x, codes, cents, dim):
    rec = tq.pq_decode(t(codes).to(torch.uint8), tq.PQCodebook(t(cents), dim)).numpy()
    return float(np.mean((rec - x) ** 2))


def test_pq_train_reconstruction_within_2_percent(floats):
    f, _ = floats
    kw = dict(n_subspaces=16, n_centroids=64, n_iters=6, n_samples=1500, seed=1)
    jcb = jq.pq_train(jnp.asarray(f), **kw)
    tcb = tq.pq_train(t(f), **kw)
    assert tuple(tcb.centroids.shape) == tuple(jcb.centroids.shape) and tcb.dim == jcb.dim
    j_mse = _pq_mse(f, np.asarray(jq.pq_encode(jnp.asarray(f), jcb)), np.asarray(jcb.centroids), f.shape[1])
    t_mse = _pq_mse(f, tq.pq_encode(t(f), tcb).numpy(), tcb.centroids.numpy(), f.shape[1])
    assert abs(t_mse - j_mse) <= 0.02 * j_mse, (t_mse, j_mse)


def test_opq_train_reconstruction_within_2_percent_and_orthogonal():
    rng = np.random.default_rng(5)  # low rank + noise: where a rotation pays
    x = (rng.normal(size=(1500, 16)) @ rng.normal(size=(16, 60))).astype(np.float32)
    x += 0.05 * rng.normal(size=x.shape).astype(np.float32)
    kw = dict(n_subspaces=8, n_centroids=16, n_iters=5, opq_iters=3, n_samples=1500, seed=0,
              anisotropic=0.5)
    jrot, jcb = jq.opq_train(jnp.asarray(x), **kw)
    trot, tcb = tq.opq_train(t(x), **kw)
    r = trot.numpy().astype(np.float64)
    assert r.shape == (64, 64) and tcb.dim == jcb.dim == 64
    np.testing.assert_allclose(r.T @ r, np.eye(64), atol=1e-4)

    def mse(rot_codes_cb, pkg):
        rot, cb = rot_codes_cb
        if pkg is jq:
            codes = jq.pq_encode(jq.rotate(jnp.asarray(x), rot), cb)
            rec = np.asarray(jq.opq_reconstruct(codes, cb, rot, x.shape[1]))
        else:
            codes = tq.pq_encode(tq.rotate(t(x), rot), cb)
            rec = tq.opq_reconstruct(codes, cb, rot, x.shape[1]).numpy()
        return float(np.mean((rec - x) ** 2))

    j_mse, t_mse = mse((jrot, jcb), jq), mse((trot, tcb), tq)
    assert abs(t_mse - j_mse) <= 0.02 * j_mse, (t_mse, j_mse)


@pytest.mark.parametrize("mode", MODES)
def test_store_layout_matches_reference(floats, mode):
    f, qf = floats
    cfg_kw = dict(mode=mode, pq_subspaces=16, pq_train_iters=3, opq_iters=2)
    js = jq.QuantizedVectors.build(jnp.asarray(f), jq.QuantConfig(**cfg_kw))
    ts = tq.QuantizedVectors.build(t(f), tq.QuantConfig(**cfg_kw))
    assert tuple(ts.codes.shape) == tuple(js.codes.shape)
    assert str(ts.codes.dtype).split(".")[-1] == str(np.asarray(js.codes).dtype)
    assert (ts.code_bytes, ts.code_bytes_per_row) == (js.code_bytes, js.code_bytes_per_row)
    assert ts.packed == js.packed
    assert torch.equal(ts.encode_rows(f[:50]), ts.codes[:50])
    op = ts.routing_operand(t(qf))
    if mode == "sq8":
        assert len(op) == 3
    else:
        assert tuple(op[1].shape) == tuple(np.asarray(js.lut(jnp.asarray(qf))).shape)


SPEC_CASES = [
    ("pq", dict(version=1, bits=8, rotation=False)),
    ("pq4", dict(version=2, bits=4, rotation=False)),
    ("pq4", dict(version=3, bits=4, rotation=False)),  # newer than the reader
    ("opq-pq4", None),  # a v2 mode without a spec block
    ("pq", None),  # a pre-versioning plain store
    ("sq8", None),
    ("pq4", dict(version=1, bits=8, rotation=False)),  # spec of another mode
    ("opq-pq", dict(version=2, bits=8, rotation=False)),
    ("sq8", dict(version=1, bits=8, rotation=False)),
]


@pytest.mark.parametrize("mode,spec", SPEC_CASES)
def test_codec_spec_rejects_what_the_reference_rejects(mode, spec):
    jcfg, tcfg = jq.QuantConfig(mode=mode), tq.QuantConfig(mode=mode)
    assert tq.codec_spec(tcfg) == jq.codec_spec(jcfg)
    outcome = []
    for check, cfg in ((jq.store.check_codec_spec, jcfg), (tq.store.check_codec_spec, tcfg)):
        try:
            check(spec, cfg)
            outcome.append("ok")
        except ValueError:
            outcome.append("rejected")
    assert outcome[0] == outcome[1], outcome


def test_bad_configs_rejected():
    for bad in ("int2", "opq-pq2", "fp4"):
        with pytest.raises(ValueError):
            tq.QuantConfig(mode=bad)
    assert tq.QuantConfig(mode="pq4", pq_centroids=256).effective_centroids == 16
    assert dataclasses.asdict(tq.QuantConfig()) == dataclasses.asdict(jq.QuantConfig())
    assert tq.QUANT_MODES == jq.QUANT_MODES and tq.PQ_MODES == jq.PQ_MODES
    assert tq.CODEC_VERSION == jq.CODEC_VERSION
