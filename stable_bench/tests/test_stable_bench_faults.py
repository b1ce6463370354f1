"""The check against broken answers: a sound run is correct, and the control
and every fault a search cell can have make ``correct`` false.

Each test drives the rest of a run (set-up, window, check) on the CPU at a
small size, with the timed path broken underneath ``Engine.search``, on the
flat index and on a partitioned one."""
import numpy as np
import pytest
import torch

from repro_torch import api
from stable_bench import bench, control, reference
from stable_bench.tests.helpers import CPU, small_cell

#: the manifest's two backends, and the partitioned backend's scan of some
#: partitions, its scan of every partition (exact) and its traversal, under
#: a residency cap
CELLS = ["sift1m-theta243.bulk_graph", "sift1m-theta243.bulk_exact", "partitioned.brute",
         "partitioned.brute_full", "partitioned.graph"]


@pytest.fixture(scope="module", params=CELLS)
def program(request):
    cell = small_cell(request.param)
    prog = bench.Program(cell, 2**31 + 3, CPU, api)
    return cell, prog


#: calls of each test's window, whatever the machine's speed
CALLS = 4


def judge(cell, prog, w):
    return bench.finish(cell, w, prog, 1.0, 0, CPU)


def window(cell, prog):
    return bench.measure(prog, cell.driver, 0.0, False, min_calls=CALLS)


def run_with(cell, prog, search):
    """One short window with ``search`` in place of the engine's."""
    true = prog.engine.search
    prog.engine.search = search(true)
    try:
        w = window(cell, prog)
    finally:
        prog.engine.search = true
    return judge(cell, prog, w)


def test_sound_run_is_correct(program):
    cell, prog = program
    out = run_with(cell, prog, lambda f: f)
    assert out["correct"], out["checks"]
    assert out["checks"]["score_gap"]["value"] < 1e-6


def _half_batch(f):
    def search(qb, params):
        res = f(qb, params)
        half = res.ids.shape[0] // 2
        return res._replace(ids=torch.cat([res.ids[:half], torch.full_like(res.ids[half:], -1)]))
    return search


def _half_batch_answered_by_the_rest(f):
    def search(qb, params):
        res = f(qb.take(np.arange(qb.batch_size) % (qb.batch_size // 2)), params)
        return res
    return search


def _answer_altered(f):
    def search(qb, params):
        res = f(qb, params)
        ids = res.ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 3000
        return res._replace(ids=ids)
    return search


def _stale_state(f):
    first = {}

    def search(qb, params):
        res = f(qb, params)
        return first.setdefault(qb.batch_size, res)
    return search


def _scores_rounded(f):
    def search(qb, params):
        res = f(qb, params)
        return res._replace(sqdists=res.sqdists.to(torch.bfloat16).to(torch.float32))
    return search


@pytest.mark.parametrize("fault", [_half_batch, _half_batch_answered_by_the_rest, _answer_altered,
                                   _stale_state, _scores_rounded])
def test_fault_is_not_correct(program, fault):
    cell, prog = program
    out = run_with(cell, prog, fault)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct(program):
    cell, prog = program
    w = window(cell, prog)
    preds = reference.compile_predicates(cell.mix["classes"], prog.data.query_attrs,
                                         cell.config["labels_per_dim"])
    ctl = dict(w, answers=control.answers(prog.data, preds, w["answers"], cell.mix["params"]["k"]))
    out = judge(cell, prog, ctl)
    assert not out["correct"], out["checks"]
    assert out["checks"]["score_gap"]["value"] > cell.limits["score_gap"]


def test_wrong_compilation_is_not_correct(program):
    cell, prog = program
    w = window(cell, prog)
    # a ONE_OF that lost one of its labels in compilation
    sound = prog.batches
    prog.batches = [api.QueryBatch(qb.vectors, qb.attrs, mask=qb.mask, allowed=qb.allowed[..., :1],
                                   hard=qb.hard, intervals=qb.intervals)
                    if qb.allowed is not None else qb for qb in sound]
    try:
        out = judge(cell, prog, w)
    finally:
        prog.batches = sound
    assert not out["correct"] and out["checks"]["predicates"]["value"] > 0
