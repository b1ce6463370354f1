"""The port's two scorers against the reference: the plain PyTorch versions
(what a CPU tensor runs) against the Pallas kernels in interpret mode and
against their jnp twins on the main path, over point, interval and masked
targets in auto and l2 modes, with ragged shapes. The hand-written CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: gather_auto sums M positive squares in another order, so
rtol 1e-5; fused_auto's ‖q‖² + ‖x‖² − 2q·x cancels, so
|Δ| ≤ (1e-5·(‖q‖² + ‖x‖²) + 1e-6)·(1 + S_A/α)². Integer-valued inputs
must agree exactly with the jnp twins as the reference's main path runs
them (jitted, α static).
"""
import functools
import inspect

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import auto as jauto  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core.auto import MetricConfig as JMetric  # noqa: E402
from repro.kernels.fused_auto.fused_auto import fused_auto_scores  # noqa: E402
from repro.kernels.gather_auto.gather_auto import gather_auto_scores  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_auto.ops import MAX_ATTRS, fused_auto, fused_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref  # noqa: E402
from repro_torch.kernels.gather_auto.ref import penalty_sa  # noqa: E402

ALPHA = 0.8
TARGETS = ("point", "interval", "masked")
MODES = ("auto", "l2")


def make_inputs(b, n, m, l, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        qv = rng.integers(-20, 21, (b, m)).astype(np.float32)
        xv = rng.integers(-20, 21, (n, m)).astype(np.float32)
    else:
        qv = rng.normal(size=(b, m)).astype(np.float32) * 30
        xv = rng.normal(size=(n, m)).astype(np.float32) * 30
    qa = rng.integers(0, 4, (b, l)).astype(np.int32)
    xa = rng.integers(0, 4, (n, l)).astype(np.int32)
    other = rng.integers(0, 4, (b, l)).astype(np.int32)
    iv = np.stack([np.minimum(qa, other), np.maximum(qa, other)], -1)
    mask = rng.integers(0, 2, (b, l)).astype(np.int32)
    return qv, xv, qa, xa, iv, mask


def targets(kind, qa, iv, mask):
    """(targets, mask) numpy operands for a target kind."""
    return {"point": (qa, None), "interval": (iv, None), "masked": (qa, mask)}[kind]


def t(x, dtype=None):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def routing_twin(xv, xa, cand, qv, qa_t, mode, mask):
    """The reference traversal's scorer as its main path runs it: under
    jit with the metric config static (XLA then multiplies by 1/α)."""
    fn = jax.jit(functools.partial(
        jrouting._score_candidates, metric_cfg=JMetric(mode=mode, alpha=ALPHA),
        quant=(), quant_mode="none",
    ))
    return np.asarray(fn(
        jnp.asarray(xv), jnp.asarray(xa), jnp.asarray(cand), jnp.asarray(qv),
        jnp.asarray(qa_t), mask=None if mask is None else jnp.asarray(mask),
    ))


def fused_tol(qv, xv, qa_t, xa, mask, mode, want):
    qsq = (qv.astype(np.float64) ** 2).sum(1)[:, None]
    xsq = (xv.astype(np.float64) ** 2).sum(1)[None, :]
    pen2 = 1.0
    if mode == "auto":
        sa = penalty_sa(t(qa_t), t(xa)[None].expand(qv.shape[0], -1, -1), t(mask)).double().numpy()
        pen2 = (1.0 + sa / ALPHA) ** 2
    return (1e-5 * (qsq + xsq) + 1e-6) * pen2 + 1e-6 * np.abs(want)


# ---------------------------------------------------------------------------
# gather_auto
# ---------------------------------------------------------------------------


class TestGatherAuto:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("kind", TARGETS)
    @pytest.mark.parametrize("b,n,c,m,l", [
        (5, 70, 33, 24, 4), (9, 131, 130, 64, 5),
        # the build's narrow C = 32 over 78 queries; a width above the
        # 48 KB query row the CUDA kernel once staged, and not a multiple of 4
        (78, 50, 32, 16, 3), (2, 40, 37, 12289, 2),
    ])
    def test_matches_pallas_and_routing_twin(self, b, n, c, m, l, kind, mode):
        qv, xv, qa, xa, iv, mask = make_inputs(b, n, m, l, seed=b * c)
        qa_t, mk = targets(kind, qa, iv, mask)
        rng = np.random.default_rng(c)
        cand = rng.integers(-1, n, (b, c)).astype(np.int32)
        got = gather_auto(t(qv), t(qa_t), t(xv), t(xa), t(cand), ALPHA, mode, t(mk)).numpy()
        assert got.shape == (b, c)
        assert (got[cand < 0] == np.float32(3.0e38)).all()
        valid = cand >= 0
        # the Pallas kernel over pre-gathered rows (INVALID → row 0, masked after)
        safe = np.maximum(cand, 0)
        pallas = np.asarray(gather_auto_scores(
            jnp.asarray(qv), jnp.asarray(qa_t), jnp.asarray(xv[safe]), jnp.asarray(xa[safe]),
            alpha=ALPHA, mode=mode, mask=None if mk is None else jnp.asarray(mk),
            interpret=True,
        ))
        np.testing.assert_allclose(got[valid], pallas[valid], rtol=1e-5, atol=1e-6)
        # the jnp twin the reference's traversal runs
        twin = routing_twin(xv, xa, cand, qv, qa_t, mode, mk)
        np.testing.assert_allclose(got[valid], twin[valid], rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("kind", TARGETS)
    def test_integer_inputs_exact_against_twin(self, kind):
        b, n, c, m, l = 6, 90, 57, 32, 5
        qv, xv, qa, xa, iv, mask = make_inputs(b, n, m, l, seed=3, integer=True)
        qa_t, mk = targets(kind, qa, iv, mask)
        cand = np.random.default_rng(4).integers(-1, n, (b, c)).astype(np.int32)
        got = gather_auto(t(qv), t(qa_t), t(xv), t(xa), t(cand), ALPHA, "auto", t(mk)).numpy()
        twin = routing_twin(xv, xa, cand, qv, qa_t, "auto", mk)
        np.testing.assert_array_equal(got[cand >= 0], twin[cand >= 0])

    def test_point_equals_degenerate_interval(self):
        qv, xv, qa, xa, _, _ = make_inputs(4, 50, 16, 3, seed=7)
        cand = np.random.default_rng(7).integers(0, 50, (4, 20)).astype(np.int32)
        deg = np.stack([qa, qa], -1)
        a = gather_auto(t(qv), t(qa), t(xv), t(xa), t(cand), ALPHA)
        b = gather_auto(t(qv), t(deg), t(xv), t(xa), t(cand), ALPHA)
        assert torch.equal(a, b)

    def test_row_alone_equals_row_in_batch(self):
        qv, xv, qa, xa, _, mask = make_inputs(8, 64, 24, 5, seed=9)
        cand = np.random.default_rng(9).integers(-1, 64, (8, 40)).astype(np.int32)
        full = gather_auto(t(qv), t(qa), t(xv), t(xa), t(cand), ALPHA, "auto", t(mask))
        one = gather_auto(t(qv[:1]), t(qa[:1]), t(xv), t(xa), t(cand[:1]), ALPHA, "auto", t(mask[:1]))
        assert torch.equal(one[0], full[0])


# ---------------------------------------------------------------------------
# fused_auto
# ---------------------------------------------------------------------------


class TestFusedAuto:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("kind", TARGETS)
    @pytest.mark.parametrize("b,n,m,l", [
        (4, 64, 32, 5), (9, 300, 96, 3), (1, 1, 8, 1),
        # the CUDA kernel's narrow tile (one and two query tiles), middle and
        # wide tiles; whole-row chunks (M <= 16), a full and a ragged chunk
        # (M = 100) and a ragged last chunk after eight full ones (M = 130)
        (1, 200, 10, 4), (17, 300, 10, 4), (49, 300, 100, 4), (65, 300, 130, 9),
    ])
    def test_matches_pallas_and_brute_twin(self, b, n, m, l, kind, mode):
        qv, xv, qa, xa, iv, mask = make_inputs(b, n, m, l, seed=b * 7 + n)
        qa_t, mk = targets(kind, qa, iv, mask)
        got = fused_auto(t(qv), t(qa_t), t(xv), t(xa), ALPHA, mode, t(mk)).numpy()
        assert got.shape == (b, n)
        jmask = None if mk is None else jnp.asarray(mk)
        pallas = np.asarray(fused_auto_scores(
            jnp.asarray(qv), jnp.asarray(qa_t), jnp.asarray(xv), jnp.asarray(xa),
            alpha=ALPHA, mode=mode, mask=jmask, interpret=True,
        ))
        twin = np.asarray(jauto.brute_fused_sqdist(
            jnp.asarray(qv), jnp.asarray(qa_t), jnp.asarray(xv), jnp.asarray(xa),
            JMetric(mode=mode, alpha=ALPHA), jmask,
        ))
        tol = fused_tol(qv, xv, qa_t, xa, mk, mode, twin)
        assert (np.abs(got - twin) <= tol).all()
        assert (np.abs(got - pallas) <= tol).all()

    @pytest.mark.parametrize("kind", TARGETS)
    def test_integer_inputs_exact_against_twin(self, kind):
        qv, xv, qa, xa, iv, mask = make_inputs(7, 257, 48, 5, seed=5, integer=True)
        qa_t, mk = targets(kind, qa, iv, mask)
        got = fused_auto(t(qv), t(qa_t), t(xv), t(xa), ALPHA, "auto", t(mk)).numpy()
        twin = np.asarray(jauto.brute_fused_sqdist(
            jnp.asarray(qv), jnp.asarray(qa_t), jnp.asarray(xv), jnp.asarray(xa),
            JMetric(mode="auto", alpha=ALPHA), None if mk is None else jnp.asarray(mk),
        ))
        np.testing.assert_array_equal(got, twin)

    def test_ref_matches_gathered_scorer(self):
        """The brute scorer and the gathered scorer agree row for row."""
        qv, xv, qa, xa, iv, _ = make_inputs(4, 60, 24, 5, seed=11)
        cand = np.broadcast_to(np.arange(60, dtype=np.int32), (4, 60)).copy()
        f = fused_auto_ref(t(qv), t(iv), t(xv), t(xa), ALPHA).numpy()
        g = gather_auto_ref(t(qv), t(iv), t(xv), t(xa), t(cand), ALPHA).numpy()
        np.testing.assert_allclose(f, g, rtol=1e-4, atol=1e-2)


# ---------------------------------------------------------------------------
# dispatch: CPU → plain version; anything else checked; CUDA → kernel
# ---------------------------------------------------------------------------


class TestDispatch:
    def _args(self):
        qv, xv, qa, xa, _, _ = make_inputs(2, 10, 8, 3, seed=1)
        cand = np.zeros((2, 4), np.int32)
        return t(qv), t(qa), t(xv), t(xa), t(cand)

    def test_cpu_tensors_run_the_plain_version_without_launching(self):
        qv, qa, xv, xa, cand = self._args()
        g0, f0 = gather_auto.launches, fused_auto.launches
        assert torch.equal(
            gather_auto(qv, qa, xv, xa, cand, ALPHA),
            gather_auto_ref(qv, qa, xv, xa, cand, ALPHA),
        )
        assert torch.equal(fused_auto(qv, qa, xv, xa, ALPHA), fused_auto_ref(qv, qa, xv, xa, ALPHA))
        assert (gather_auto.launches, fused_auto.launches) == (g0, f0)

    def test_rejects_bad_operands(self):
        qv, qa, xv, xa, cand = self._args()
        with pytest.raises(TypeError):
            gather_auto(qv.double(), qa, xv, xa, cand)
        with pytest.raises(TypeError):
            fused_auto(qv, qa.long(), xv, xa)
        with pytest.raises(ValueError):
            fused_auto(qv, qa, xv.t().contiguous().t(), xa)  # non-contiguous
        with pytest.raises(ValueError):
            gather_auto(qv, qa, xv, xa, cand.to("meta"))  # device mismatch
        with pytest.raises(ValueError):
            gather_auto(qv, qa, xv, xa, cand, mode="attr")

    def test_attribute_cap_is_the_kernels(self):
        """MAX_ATTRS is the kernel's staging bound kMaxAttrs and no longer a
        cap: the launcher refuses no L, the wrapper never compares L with it,
        and a CPU call above it runs the plain version."""
        src = (build.CSRC / "fused_auto.cu").read_text()
        assert f"constexpr int kMaxAttrs = {MAX_ATTRS};" in src
        assert "L > kMaxAttrs) return" not in src
        assert "MAX_ATTRS" not in inspect.getsource(fused_auto)
        for l in (MAX_ATTRS + 1, 2 * MAX_ATTRS + 8):
            qv, xv, qa, xa, iv, mask = make_inputs(3, 20, 8, l, seed=l)
            for qa_t, mk in ((qa, None), (iv, mask)):
                got = fused_auto(t(qv), t(qa_t), t(xv), t(xa), ALPHA, "auto", t(mk))
                assert torch.equal(
                    got, fused_auto_ref(t(qv), t(qa_t), t(xv), t(xa), ALPHA, "auto", t(mk)))

    def test_asking_for_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device(None)
        assert resolve_device("cpu").type == "cpu"
