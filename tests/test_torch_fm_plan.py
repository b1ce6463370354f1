"""fm_interaction's launch plan and its backward's dispatch, on the CPU.

The CUDA kernels run whatever plan ``ops.launch_plan`` makes, so the plan
is checked here: walking it as the kernels walk it covers every example
exactly once, a block stays inside the card's shared memory, a staged run
is a whole number of 16-byte units, serve_p99 puts a block on each of the
132 SMs, and an example larger than a stage is read directly. The
backward's dispatch gives the plain gradient on the CPU and the shape on
meta; the CPU gradient is held to JAX's gradient of the reference's
``fm_interaction_ref`` within 1e-6 of its scale (the same formula rounded
in another order, the tolerance of ``tests/test_torch_train.py``).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fm_interaction.ref import fm_interaction_ref as j_fm_ref  # noqa: E402
from repro_torch.kernels.fm_interaction import ops, plan_sweep  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import (  # noqa: E402
    fm_interaction, fm_interaction_bwd, fm_interaction_bwd_ref, launch_plan, stage_examples,
    staged_plan,
)

SMS = 132  # an H100 SXM
GRAD_TOL = 1e-6

#: (B, F, D): the fm cells (serve_p99, train_batch, serve_bulk), batches
#: around a warp's and a block's edges, chip_smoke's odd shapes, D past a
#: warp, examples larger than a stage, tiny and wide examples, and batches
#: on both sides of the staged threshold
PLAN_SHAPES = [
    (512, 39, 10), (65536, 39, 10), (262144, 39, 10), (1, 39, 10), (3, 39, 10),
    (511, 39, 10), (513, 39, 10), (7, 5, 3), (77, 100, 7), (50, 233, 3), (3, 2000, 9),
    (1000, 3, 5), (40000, 7, 33), (30000, 5, 64), (100003, 7, 5), (600, 1000, 16),
    (12671, 39, 10), (12672, 39, 10), (65541, 39, 10), (1 << 20, 1, 1), (5000, 1, 1),
    (70000, 13, 2), (1, 1, 1), (300000, 26, 16), (2, 1, 97), (20000, 3, 31), (9000, 2, 1000),
    (131, 39, 10), (1 << 16, 1, 3),
]


def walk(plan, b):
    """How often the kernels touch each example under ``plan``: blocks take
    runs blockIdx, blockIdx + grid, ...; inside a run warp w's group g takes
    example p·(warps·G) + w·G + g of pass p (``fm_run``)."""
    runs = -(-b // plan.examples)
    seen = np.zeros(runs, np.int64)
    for block in range(min(plan.grid, runs)):
        seen[block::plan.grid] += 1
    assert (seen == 1).all(), "a run is taken by no block or by two"
    groups = 32 // plan.lanes
    warps = plan.threads // 32
    step = warps * groups
    passes = -(-plan.examples // step)
    x = (np.arange(passes)[:, None, None] * step + np.arange(warps)[None, :, None] * groups
         + np.arange(groups)[None, None, :]).ravel()

    def run_hits(nb):
        return np.bincount(x[x < nb], minlength=nb)

    last = b - (runs - 1) * plan.examples  # every run but the last holds E
    return np.concatenate([np.tile(run_hits(plan.examples), runs - 1), run_hits(last)])


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_covers_every_example_once_within_the_card(shape, aligned, backward):
    b, f, d = shape
    blocks_per_sm, stages = ops.RING[backward]
    plan = launch_plan(b, f, d, SMS, aligned, backward=backward)
    assert (walk(plan, b) == 1).all()
    assert plan.lanes == min(d, 32)
    assert 32 <= plan.threads <= ops.THREADS and plan.threads % 32 == 0
    assert plan.args == (int(plan.path == "staged"), plan.examples, plan.grid, plan.stages,
                         plan.threads, plan.lanes, plan.smem)
    ex_bytes = 4 * f * d
    if plan.path == "staged":
        assert aligned
        assert plan.examples * ex_bytes % 16 == 0
        assert plan.smem == ops.BAR_BYTES + plan.stages * plan.examples * ex_bytes
        assert plan.smem <= ops.SMEM_PER_BLOCK
        assert blocks_per_sm * (plan.smem + ops.SMEM_RESERVED) <= ops.SMEM_PER_SM
        assert plan.stages == stages >= 1 + backward  # the backward refills a run late
        # persistent: never more blocks than resident ones, each with runs
        assert plan.grid <= blocks_per_sm * SMS
        assert b // plan.examples >= ops.MIN_RUNS_PER_BLOCK * plan.grid
    else:
        assert plan.stages == 0 and plan.smem == 0
        # enough blocks to cover the SMs wherever there are warps for them
        assert plan.grid >= min(SMS, -(-b // (32 // plan.lanes)))
    one_stage = (min(ops.SMEM_PER_BLOCK, ops.SMEM_PER_SM // blocks_per_sm - ops.SMEM_RESERVED)
                 - ops.BAR_BYTES) // stages
    if ex_bytes > one_stage:
        assert plan.path == "direct"


def test_plan_at_the_fm_cells():
    """serve_p99 reads directly on a block an SM or more; train_batch and
    serve_bulk go through the ring, persistent, each direction with its
    own blocks an SM and stages."""
    for backward in (False, True):
        bps, stages = ops.RING[backward]
        p99 = launch_plan(512, 39, 10, SMS, backward=backward)
        assert p99.path == "direct" and p99.grid >= SMS and p99.lanes == 10
        for b in (65536, 262144):
            plan = launch_plan(b, 39, 10, SMS, backward=backward)
            assert plan.path == "staged" and plan.grid == bps * SMS and plan.stages == stages
            assert plan.examples % 2 == 0 and plan.examples * 1560 * stages <= (
                ops.SMEM_PER_SM // bps - ops.SMEM_RESERVED - ops.BAR_BYTES)
        # an offset base takes the direct path at any size
        assert launch_plan(65536, 39, 10, SMS, aligned=False, backward=backward).path == "direct"


#: every plan ``plan_sweep`` forces, at each fm cell
SWEPT = [(b, name) for b in plan_sweep.BATCHES.values()
         for name in plan_sweep.variants(b, SMS) if name != "shipped"]


@pytest.mark.parametrize("b,name", SWEPT, ids=[f"{b}-{n}" for b, n in SWEPT])
def test_forced_staged_variants_stay_within_shared_memory(b, name):
    """The sweep's forced plans run both kernels: each covers every example
    once, and a staged one has the 2 stages the backward needs and stays
    within the SM's shared memory at its blocks an SM."""
    plan = plan_sweep.variants(b, SMS)[name]
    assert (walk(plan, b) == 1).all() and plan.lanes == 10
    if plan.path == "staged":
        bps = int(name.split()[1].split("x")[0]) if "x" in name else 4
        assert plan.stages >= 2 and plan.grid <= bps * SMS
        assert bps * (plan.smem + ops.SMEM_RESERVED) <= ops.SMEM_PER_SM
        assert plan.smem <= ops.SMEM_PER_BLOCK and plan.examples * 1560 % 16 == 0
    else:
        assert plan.grid >= SMS and plan.smem == 0


def test_plans_that_cannot_run_raise():
    assert stage_examples(2000, 9, 2, 2) == 0  # one example outgrows a stage
    with pytest.raises(ValueError):
        staged_plan(3, 2000, 9, SMS, 2, 2, stage_examples(2000, 9, 2, 2))
    with pytest.raises(ValueError):  # 5 examples of 1,560 bytes: not whole 16-byte units
        staged_plan(65536, 39, 10, SMS, 2, 2, 5)
    with pytest.raises(ValueError):  # one block's stages past the SM's half
        staged_plan(65536, 39, 10, SMS, 2, 2, stage_examples(39, 10, 1, 2))
    with pytest.raises(ValueError):
        launch_plan(0, 39, 10, SMS)
    with pytest.raises(ValueError):
        launch_plan(512, 39, 10, 0)


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    e = (rng.normal(size=shape) * 0.3).astype(np.float32)
    g = rng.normal(size=shape[:1]).astype(np.float32)
    return e, g


#: the CPU gradient against JAX: D past a warp, a D of 64, an example
#: larger than a stage, one field, and B = 1
GRAD_SHAPES = [(3, 7, 33), (5, 2, 64), (2, 1000, 16), (4, 1, 5), (1, 39, 10)]


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=["x".join(map(str, s)) for s in GRAD_SHAPES])
def test_cpu_gradient_matches_jax(shape):
    e_np, g_np = _case(shape, sum(shape))
    e = torch.tensor(e_np, requires_grad=True)
    before = (fm_interaction.launches, fm_interaction_bwd.launches)
    (got,) = torch.autograd.grad(fm_interaction(e), e, torch.tensor(g_np))
    assert (fm_interaction.launches, fm_interaction_bwd.launches) == before  # no kernel here
    want = np.asarray(jax.grad(lambda x: (j_fm_ref(x) * g_np).sum())(jnp.asarray(e_np)))
    err = float(np.abs(got.numpy() - want).max())
    assert got.dtype == torch.float32 and err <= GRAD_TOL * float(np.abs(want).max())


def test_backward_dispatch_on_cpu_gives_the_plain_gradient():
    e_np, g_np = _case((9, 39, 10), 5)
    e, g = torch.from_numpy(e_np), torch.from_numpy(g_np)
    got = fm_interaction_bwd(e, g)
    assert got.shape == e.shape and got.dtype == torch.float32
    assert torch.equal(got, fm_interaction_bwd_ref(e, g))
    # the plain formula step by step: s over f from +0, then (s − e), then g·
    s = torch.zeros(9, 10)
    for f in range(39):
        s = s + e[:, f]
    assert torch.equal(got, g[:, None, None] * (s[:, None, :] - e))
    # an expanded upstream (sum's backward) and a bf16 one are taken as f32
    ones = torch.ones(()).expand(9)
    assert torch.equal(fm_interaction_bwd(e, ones), fm_interaction_bwd_ref(e, torch.ones(9)))
    gb = g.to(torch.bfloat16)
    assert torch.equal(fm_interaction_bwd(e, gb), fm_interaction_bwd_ref(e, gb.float()))
    assert fm_interaction_bwd(torch.zeros(0, 39, 10), torch.zeros(0)).shape == (0, 39, 10)


def test_backward_dispatch_on_meta_gives_the_shape_and_counts_nothing():
    before = fm_interaction_bwd.launches
    got = fm_interaction_bwd(torch.empty(7, 5, 3, device="meta"), torch.empty(7, device="meta"))
    assert got.is_meta and tuple(got.shape) == (7, 5, 3) and got.dtype == torch.float32
    assert fm_interaction_bwd.launches == before


def test_backward_rejects_what_the_kernel_does_not_take():
    e = torch.zeros(4, 5, 3)
    with pytest.raises(ValueError):
        fm_interaction_bwd(e, torch.zeros(5))  # g of another batch
    with pytest.raises(ValueError):
        fm_interaction_bwd(e, torch.zeros(4, device="meta"))  # another device
    with pytest.raises(TypeError):
        fm_interaction_bwd(e.double(), torch.zeros(4))
    with pytest.raises(ValueError):
        fm_interaction_bwd(e.transpose(1, 2), torch.zeros(4))


def test_plan_rule_for_the_stage_budget():
    """At the fm widths an example is 1,560 bytes and a pass of 8 warps x 3
    examples 37,440: the forward's stage holds one pass (2 blocks an SM, 2
    stages: 75,008 bytes a block); the backward's 4 stages of a block's
    half of the SM hold 18 examples each (6 warps, 112,448 bytes)."""
    fwd, bwd = launch_plan(65536, 39, 10, SMS), launch_plan(65536, 39, 10, SMS, backward=True)
    assert (fwd.examples, fwd.threads, fwd.smem) == (24, 256, 128 + 2 * 24 * 1560)
    assert (bwd.examples, bwd.threads, bwd.smem) == (18, 192, 128 + 4 * 18 * 1560)
    assert fwd.smem == 75_008 and bwd.smem == 112_448
    assert math.gcd(fwd.examples * 1560, 16) == math.gcd(bwd.examples * 1560, 16) == 16
