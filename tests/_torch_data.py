"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Integer-valued features make every partial sum of a squared distance an
exactly representable integer, so both packages compute bit-equal scores
in any summation order and every id, distance, eval count and hop count
must match exactly. Float (sift-profile) data is compared by tolerance and
by recall.
"""
import numpy as np
import torch

from repro.data.synthetic import make_hybrid_dataset

# the tensors here are small and the suite runs one worker per core
torch.set_num_threads(1)

#: small HELP build, the size the reference's own API tests use
HELP_KW = dict(gamma=12, gamma_new=4, max_rounds=3, quality_sample=64, node_block=512)


def integerize(x: np.ndarray, scale: float = 33.5) -> np.ndarray:
    """Round sift-profile features onto integers in [-20, 20]."""
    return np.clip(np.round(x / scale * 4), -20, 20).astype(np.float32)


def dataset(n: int = 2048, n_queries: int = 32, seed: int = 1, integer: bool = True):
    """(features, attrs, query_features, query_attrs) as numpy."""
    ds = make_hybrid_dataset(
        n=n, n_queries=n_queries, profile="sift", attr_dim=5, labels_per_dim=3,
        n_clusters=8, attr_cluster_corr=0.6, seed=seed,
    )
    f, qf = ds.features, ds.query_features
    if integer:
        f, qf = integerize(f), integerize(qf)
    return f, ds.attrs, qf, ds.query_attrs


def predicate_batches(qf: np.ndarray, qa: np.ndarray, query_mod):
    """MATCH, subset, ONE_OF and BETWEEN batches built with ``query_mod``
    (the reference's or the port's ``api.query``; both compile the same
    arrays)."""
    Q, MATCH, ONE_OF, BETWEEN, ANY = (
        query_mod.Query, query_mod.MATCH, query_mod.ONE_OF, query_mod.BETWEEN,
        query_mod.ANY,
    )
    b = len(qf)
    return {
        "match": query_mod.QueryBatch.match(qf, qa),
        "subset": query_mod.QueryBatch.match(qf, qa, active=[0, 1]),
        "one_of": query_mod.QueryBatch.from_queries([
            Q(qf[i], [ONE_OF(0, 2), MATCH(int(qa[i, 1])), ANY, MATCH(1), ONE_OF(1, 2)])
            for i in range(b)
        ]),
        "between": query_mod.QueryBatch.from_queries([
            Q(qf[i], [BETWEEN(0, 1), MATCH(int(qa[i, 1])), BETWEEN(1, 2), ANY, MATCH(0)])
            for i in range(b)
        ]),
    }
