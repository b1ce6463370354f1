"""The port's graph primitives against the reference, bit for bit, on
integer-valued distances full of ties: the pool contents (and so the
traversal) depend on the tie order, which the port reproduces with stable
sorts."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import graph_ops as jg  # noqa: E402
from repro_torch.core import graph_ops as tg  # noqa: E402


def pools(seed, b=16, pool=12, c=30, n=25):
    """Pools and candidates with duplicate ids, INVALIDs and tied dists."""
    rng = np.random.default_rng(seed)
    pool_ids = rng.integers(-1, n, (b, pool)).astype(np.int32)
    pool_d = rng.integers(0, 6, (b, pool)).astype(np.float32)
    pool_d[pool_ids < 0] = np.float32(3.0e38)
    cand_ids = rng.integers(-1, n, (b, c)).astype(np.int32)
    cand_d = rng.integers(0, 6, (b, c)).astype(np.float32)
    flags = rng.integers(0, 2, (b, pool)).astype(np.int8)
    cand_flags = rng.integers(0, 2, (b, c)).astype(np.int8)
    return pool_ids, pool_d, cand_ids, cand_d, flags, cand_flags


def both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    t = fn_t(*[torch.from_numpy(a) for a in arrays], **kw)
    return j, t


def test_constants():
    assert np.float32(tg.INF) == np.asarray(jg.INF)
    assert tg.INVALID == int(jg.INVALID)


@pytest.mark.parametrize("capacity", [1, 12, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_pools_with_flags(seed, capacity):
    pid, pd, cid, cd, fl, cfl = pools(seed)
    j = jg.merge_pools(jnp.asarray(pid), jnp.asarray(pd), jnp.asarray(cid), jnp.asarray(cd),
                       capacity, pool_flags=jnp.asarray(fl), cand_flags=jnp.asarray(cfl))
    t = tg.merge_pools(torch.from_numpy(pid), torch.from_numpy(pd), torch.from_numpy(cid),
                       torch.from_numpy(cd), capacity, pool_flags=torch.from_numpy(fl),
                       cand_flags=torch.from_numpy(cfl))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_pools_without_flags(seed):
    pid, pd, cid, cd, fl, _ = pools(seed)
    j = jg.merge_pools(jnp.asarray(pid), jnp.asarray(pd), jnp.asarray(cid), jnp.asarray(cd), 12)
    t = tg.merge_pools(torch.from_numpy(pid), torch.from_numpy(pd), torch.from_numpy(cid),
                       torch.from_numpy(cd), 12)
    assert t[2] is None
    np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    # flags default to zero for candidates when only the pool carries them
    j = jg.merge_pools(jnp.asarray(pid), jnp.asarray(pd), jnp.asarray(cid), jnp.asarray(cd),
                       12, pool_flags=jnp.asarray(fl))
    t = tg.merge_pools(torch.from_numpy(pid), torch.from_numpy(pd), torch.from_numpy(cid),
                       torch.from_numpy(cd), 12, pool_flags=torch.from_numpy(fl))
    np.testing.assert_array_equal(np.asarray(j[2]), t[2].numpy())


def test_mask_duplicate_ids():
    pid, pd, *_ = pools(5, pool=40)
    j, t = both(jg.mask_duplicate_ids, tg.mask_duplicate_ids, pid, pd)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("capacity", [3, 8, 40])
def test_reverse_neighbors_and_in_degrees(capacity):
    rng = np.random.default_rng(capacity)
    n, gamma = 60, 10
    nbrs = rng.integers(-1, n, (n, gamma)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jg.reverse_neighbors(jnp.asarray(nbrs), n, capacity)),
        tg.reverse_neighbors(torch.from_numpy(nbrs), n, capacity).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jg.in_degrees(jnp.asarray(nbrs), n)),
        tg.in_degrees(torch.from_numpy(nbrs), n).numpy(),
    )


def test_gather_rows_routes_invalid_to_row_zero():
    table = np.arange(20, dtype=np.float32).reshape(10, 2)
    ids = np.array([[3, -1], [9, 0]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jg.gather_rows(jnp.asarray(table), jnp.asarray(ids))),
        tg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
    )


def test_smallest_k_keeps_lower_index_first_on_ties():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, 0.0, 0.0]])
    vals, idx = tg.smallest_k(x, 5)
    assert idx.tolist() == [[5, 6, 1, 2, 4]]
    import jax

    neg, jidx = jax.lax.top_k(-jnp.asarray(x.numpy()), 5)
    assert np.asarray(jidx).tolist() == idx.tolist()
