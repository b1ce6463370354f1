"""The plain ADC scanners of the port (``kernels/adc_scan/ref.py``) against
the reference's plain version (``adc_scan_ref``) and its Pallas kernels
run in interpret mode (``adc_scan_scores`` / ``adc_scan4_scores``), on the
same numpy inputs: point, interval and masked targets, auto and l2 modes,
even and odd S. Integer-valued tables make every sum exact, so there the
results are equal; on float tables the one-hot product of the Pallas body
sums in another order, so those compare within rtol 1e-5 (atol 1e-4, the
reference's own bar). Inside the port, the 4-bit scanner on packed codes
equals the 8-bit one on the unpacked codes bit for bit, and CPU tensors
launch nothing. The port's own sum order (class sums over s mod 32, then a
halving tree; ``kernels/adc_scan/ref.py``) is held bit for bit against a
float32 numpy version of it, and the tree's invariance under a rotation of
the class sums, which the CUDA kernel relies on, is checked directly."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.adc_scan.adc_scan import adc_scan4_scores as jscan4  # noqa: E402
from repro.kernels.adc_scan.adc_scan import adc_scan_scores as jscan  # noqa: E402
from repro.kernels.adc_scan.ref import adc_scan4_ref as jref4  # noqa: E402
from repro.kernels.adc_scan.ref import adc_scan_ref as jref  # noqa: E402
from repro_torch.kernels.adc_scan import ops  # noqa: E402
from repro_torch.quant import pack_nibbles  # noqa: E402

ALPHA = 0.8


def case(b, n, s, k, l, seed, integer, kind):
    rng = np.random.default_rng(seed)
    lut = rng.integers(0, 40, size=(b, s, k)) if integer else rng.uniform(0, 4, size=(b, s, k))
    codes = rng.integers(0, k, size=(n, s)).astype(np.uint8)
    qa = rng.integers(0, 4, size=(b, l)).astype(np.int32)
    xa = rng.integers(0, 4, size=(n, l)).astype(np.int32)
    mask = None
    if kind == "interval":
        other = rng.integers(0, 4, size=(b, l))
        qa = np.stack([np.minimum(qa, other), np.maximum(qa, other)], -1).astype(np.int32)
    elif kind == "masked":
        mask = rng.integers(0, 2, size=(b, l)).astype(np.int32)
    return lut.astype(np.float32), codes, qa, xa, mask


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("kind", ["point", "interval", "masked"])
def test_adc_scan_against_reference(kind, mode, integer):
    lut, codes, qa, xa, mask = case(5, 300, 8, 256, 4, seed=11, integer=integer, kind=kind)
    got = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, mode, t(mask)).numpy()
    ref = np.asarray(jref(j(lut), j(codes), j(qa), j(xa), ALPHA, mode, j(mask)))
    pallas = np.asarray(jscan(j(lut), j(codes), j(qa), j(xa), alpha=ALPHA, mode=mode,
                              mask=j(mask), interpret=True))
    if integer and mode == "l2":  # no α: every value is an exact integer
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("s,kind", [(8, "point"), (7, "interval"), (5, "masked")])
def test_adc_scan4_against_reference(s, kind, mode, integer):
    lut, codes, qa, xa, mask = case(4, 257, s, 16, 3, seed=s, integer=integer, kind=kind)
    packed = pack_nibbles(t(codes))
    got = ops.adc_scan4_scores(t(lut), packed, t(qa), t(xa), ALPHA, mode, t(mask)).numpy()
    jp = jnp.asarray(packed.numpy())
    ref = np.asarray(jref4(j(lut), jp, j(qa), j(xa), ALPHA, mode, j(mask)))
    pallas = np.asarray(jscan4(j(lut), jp, j(qa), j(xa), alpha=ALPHA, mode=mode, mask=j(mask),
                               interpret=True))
    if integer and mode == "l2":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
    # the packed scanner equals the 8-bit one on the same codes unpacked
    unpacked = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, mode, t(mask))
    assert torch.equal(torch.from_numpy(got), unpacked)


def test_integer_auto_scores_equal_the_reference_plain_version_times_inv_alpha():
    """On integer tables the port's penalty (× f32(1/α), the jitted
    reference's form) is the same value as the reference plain version's
    division up to one rounding of 1/α."""
    lut, codes, qa, xa, mask = case(3, 200, 6, 256, 5, seed=2, integer=True, kind="masked")
    got = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, "auto", t(mask)).numpy()
    ref = np.asarray(jref(j(lut), j(codes), j(qa), j(xa), ALPHA, "auto", j(mask)))
    np.testing.assert_allclose(got, ref, rtol=4e-7)


def test_batch_rows_are_independent_and_cpu_launches_nothing():
    lut, codes, qa, xa, mask = case(6, 150, 8, 16, 3, seed=4, integer=False, kind="masked")
    n0 = (ops.adc_scan_scores.launches, ops.adc_scan4_scores.launches)
    packed = pack_nibbles(t(codes))
    full = ops.adc_scan(t(lut), packed, t(qa), t(xa), ALPHA, "auto", t(mask), packed=True)
    for r in (0, 5):
        sl = slice(r, r + 1)
        one = ops.adc_scan(t(lut[sl]), packed, t(qa[sl]), t(xa), ALPHA, "auto", t(mask[sl]),
                           packed=True)
        assert torch.equal(one[0], full[r])
    ids = ops.adc_scan_topk(t(lut), packed, t(qa), t(xa), 7, ALPHA, "auto", t(mask), packed=True)[1]
    np.testing.assert_array_equal(ids.numpy(), np.argsort(full.numpy(), 1, kind="stable")[:, :7])
    assert (ops.adc_scan_scores.launches, ops.adc_scan4_scores.launches) == n0


def test_operands_are_checked():
    lut, codes, qa, xa, _ = case(2, 20, 4, 16, 3, seed=1, integer=True, kind="point")
    with pytest.raises(ValueError):  # packed codes need K = 16 tables
        ops.adc_scan4_scores(t(np.zeros((2, 4, 8), np.float32)), pack_nibbles(t(codes)), t(qa), t(xa))
    with pytest.raises(ValueError):  # unpacked codes against the 4-bit scanner
        ops.adc_scan4_scores(t(lut), t(codes), t(qa), t(xa))
    with pytest.raises(TypeError):  # codes stay uint8, never widened
        ops.adc_scan_scores(t(lut), t(codes.astype(np.int32)), t(qa), t(xa))
    with pytest.raises(ValueError):
        ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), mode="nhq")


#: subspace counts around the 32 residue classes: fewer than 32 (empty
#: classes), one class each, a partial second chunk, several chunks
ORDER_S = [1, 5, 7, 8, 31, 32, 33, 64, 65, 200]


def halving_tree(c):
    """c[..., i] + c[..., i + h] for i < h, h = 16 .. 1, in float32."""
    h = c.shape[-1] // 2
    while h >= 1:
        c = c[..., :h] + c[..., h:2 * h]
        h //= 2
    return c[..., 0]


def numpy_order_sum(lut, codes):
    """The scanners' stated order in float32 numpy: for each class r = s mod
    32 the entries in ascending s from +0.0, then the halving tree."""
    b, s, _ = lut.shape
    c = np.zeros((b, codes.shape[0], 32), np.float32)
    for si in range(s):
        c[:, :, si % 32] = c[:, :, si % 32] + lut[:, si, :][:, codes[:, si]]
    return halving_tree(c)


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("s", ORDER_S)
def test_plain_version_uses_the_stated_order_bitwise(s, k):
    lut, codes, qa, xa, _ = case(3, 70, s, k, 2, seed=s + k, integer=False, kind="point")
    got = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, "l2").numpy()
    want = np.maximum(numpy_order_sum(lut, codes), np.float32(0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("rotation", range(32))
def test_halving_tree_is_invariant_under_rotation_bitwise(rotation):
    """The kernel's lane l holds class (t + l) mod 32 in accumulator t: the
    tree over a rotated vector of class sums gives the same bits."""
    rng = np.random.default_rng(rotation)
    # magnitudes over several decades, so a reordered sum would round otherwise
    c = (rng.uniform(0, 1, (200, 32)) * 10.0 ** rng.integers(-3, 4, (200, 32))).astype(np.float32)
    want = halving_tree(c)
    got = halving_tree(np.roll(c, -rotation, axis=1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("s", ORDER_S)
def test_packed_plain_version_equals_unpacked_at_every_s(s):
    lut, codes, qa, xa, mask = case(3, 90, s, 16, 3, seed=s, integer=False, kind="masked")
    for mode in ("auto", "l2"):
        got = ops.adc_scan4_scores(t(lut), pack_nibbles(t(codes)), t(qa), t(xa), ALPHA, mode,
                                   t(mask))
        want = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, mode, t(mask))
        assert torch.equal(got, want)


@pytest.mark.parametrize("s", [7, 65])
def test_plain_version_row_chunks_change_no_bit(s, monkeypatch):
    """The plain version gathers rows in chunks (``CHUNK_ELEMENTS``); chunks
    of 5 rows, a ragged last one included, give the same bits."""
    from repro_torch.kernels.adc_scan import ref

    lut, codes, qa, xa, mask = case(3, 83, s, 256, 3, seed=s, integer=False, kind="masked")
    whole = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, "auto", t(mask))
    monkeypatch.setattr(ref, "CHUNK_ELEMENTS", 3 * ref.CLASSES * 5)
    chunked = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, "auto", t(mask))
    assert torch.equal(chunked, whole)
    want = np.maximum(numpy_order_sum(lut, codes), np.float32(0))
    l2 = ops.adc_scan_scores(t(lut), t(codes), t(qa), t(xa), ALPHA, "l2").numpy()
    np.testing.assert_array_equal(l2.view(np.uint32), want.view(np.uint32))
