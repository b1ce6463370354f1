"""The port's FM second-order term against the reference: the plain
PyTorch version (what a CPU tensor runs) against the Pallas kernel in
interpret mode, the reference's jnp twin and the O(F²) pairwise
definition, on the same numpy inputs. The CUDA kernel itself is held
against the plain version, bit for bit, by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance: |Δ| ≤ 1e-5·Σ_d(s_d² + sq_d) + 1e-7 with s = Σ_f e, sq = Σ_f e².
The packages sum over f in different orders and the sum-square trick
cancels (s_d² − sq_d), so the error scales with the two terms, not with
the result.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fm_interaction.fm_interaction import fm_interaction_pallas  # noqa: E402
from repro.kernels.fm_interaction.ref import (  # noqa: E402
    fm_interaction_pairwise_ref as jax_pairwise,
    fm_interaction_ref as jax_ref,
)
from repro_torch.kernels.fm_interaction.ops import (  # noqa: E402
    fm_interaction, fm_interaction_pairwise_ref, fm_interaction_ref,
)

#: (B, F, D): the fm config's widths (F = 39, D = 10), the reduced config's
#: (8, 8), a D that is not a power of two and a one-dim edge (each shape
#: compiles the Pallas kernel once, about a second here)
SHAPES = [(64, 39, 10), (33, 8, 8), (7, 5, 3), (3, 6, 1)]


def emb(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.3).astype(np.float32)


def tol(e):
    e = e.astype(np.float64)
    return 1e-5 * (e.sum(1) ** 2 + (e * e).sum(1)).sum(-1) + 1e-7


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference(shape):
    e = emb(shape, seed=sum(shape))
    got = fm_interaction_ref(torch.from_numpy(e)).numpy()
    assert got.shape == (shape[0],) and got.dtype == np.float32
    bound = tol(e)
    want = {
        "pallas": np.asarray(fm_interaction_pallas(jnp.asarray(e), interpret=True)),
        "jnp": np.asarray(jax_ref(jnp.asarray(e))),
        "pairwise": np.asarray(jax_pairwise(jnp.asarray(e))),
        "port pairwise": fm_interaction_pairwise_ref(torch.from_numpy(e)).numpy(),
    }
    for name, w in want.items():
        assert np.all(np.abs(got - w) <= bound), name


def test_cpu_dispatch_runs_the_plain_version():
    e = torch.from_numpy(emb((40, 39, 10), seed=3))
    before = fm_interaction.launches
    got = fm_interaction(e)
    assert fm_interaction.launches == before  # no kernel on the CPU
    assert torch.equal(got, fm_interaction_ref(e))
    # each example's value depends on nothing but its own rows
    assert torch.equal(fm_interaction(e[5:6].contiguous())[0], got[5])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    e = torch.from_numpy(emb((4, 5, 3), seed=4))
    with pytest.raises(TypeError):
        fm_interaction(e.double())
    with pytest.raises(ValueError):
        fm_interaction(e.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        fm_interaction(e.reshape(4, 15))


def test_empty_sums_are_zero():
    assert fm_interaction(torch.zeros((0, 39, 10))).shape == (0,)
    assert torch.equal(fm_interaction(torch.ones((3, 0, 4))), torch.zeros(3))
    assert torch.equal(fm_interaction(torch.ones((3, 4, 0))), torch.zeros(3))
