"""A candidate that is the true tail itself is a tie by id, on every eval path.

The port's three zero-shot eval paths on tests/test_sharding.py's synthetic
stream, at 1 rank in process and (``rel_shared``) on a spawned 4-rank gloo
world, held against the float64 pessimistic rank: 1 + every negative
occurrence scoring at least the true tail, a duplicate of the true tail
included. Query 6's list holds its own true tail once (exact rank 10); the
second stream appends the true tail twice more to every list, and both
occurrences count. Ranks are integers: equal, no tolerance.
"""

import numpy as np
import pytest
import torch

import test_torch_port_mesh_tasks as tasks
from mre_tpu_torch.eval import zero_shot as tzs
from mre_tpu_torch.tools import dryrun_multichip as dry

KW = dict(query_chunk=4, verbose=False, return_ranks=True, device="cpu")
PATHS = ("factored", "head_shared", "rel_shared")


def ranks(spec, path, true_bias=0.0):
    """The port's ranks of ``spec`` on ``path``; ``true_bias`` lifts the
    true tail's own embedding in ``rel_shared`` (a last-bits difference
    between the two sums, made large)."""
    T = torch.as_tensor(spec["T"])
    tc, e2id, rel_vecs = spec["test_candidates"], spec["e2id"], spec["rel_vecs"]
    gen = rel_vecs.__getitem__
    if path == "rel_shared":
        return tzs.evaluate_zero_shot_rel_shared(
            tc, e2id, lambda h, s: T[h][:, None, :] + 2.0 * T[s][None, :, :],
            lambda h, t: (T[h] + 2.0 * T[t]) * (1.0 + true_bias), gen, **KW)["ranks"]
    if path == "head_shared":
        return tzs.evaluate_zero_shot(
            tc, e2id, e2id, {}, None, gen,
            embed_query_block=lambda h, c: T[h][:, None, :] + 2.0 * T[c], **KW)["ranks"]
    return tzs.evaluate_zero_shot(tc, e2id, e2id, {}, lambda p, l, r: T[l] + 2.0 * T[r],
                                  gen, **KW)["ranks"]


@pytest.mark.parametrize("extra_true", [0, 2])
@pytest.mark.parametrize("path", PATHS)
def test_ranks_equal_the_float64_pessimistic_rank(path, extra_true):
    spec = tasks.synthetic_stream(extra_true)
    exact = tasks.exact_ranks(spec)
    np.testing.assert_array_equal(ranks(spec, path), exact)
    base = tasks.exact_ranks(tasks.synthetic_stream())
    assert base[6] == 10
    np.testing.assert_array_equal(exact, base + extra_true)     # every occurrence counts


@pytest.mark.parametrize("extra_true", [0, 2])
def test_rel_shared_counts_the_true_tail_by_id_not_by_score(extra_true):
    """The true tail's own embedding scaled up by 1e-3 changes no cosine but
    rounds its score apart from its duplicates' in the shared row: each
    duplicate still counts."""
    spec = tasks.synthetic_stream(extra_true)
    np.testing.assert_array_equal(ranks(spec, "rel_shared", true_bias=1e-3),
                                  tasks.exact_ranks(spec))


def test_ranks_vs_first_counts_the_true_id_below_its_score():
    scores = torch.tensor([[0.5, 0.4999, 0.6, 0.1], [0.5, 0.5, 0.2, 0.1]])
    mask = torch.tensor([[True, True, True, True], [True, True, False, True]])
    ids = torch.tensor([[7, 7, 3, 7], [2, 5, 2, 4]])
    # row 0: id 7 twice below the true score, one greater → 1 + 3; row 1:
    # a value tie of another id counts, the masked duplicate does not
    np.testing.assert_array_equal(tzs._ranks_vs_first(scores, mask, ids).numpy(), [4, 2])
    np.testing.assert_array_equal(tzs._ranks_vs_first(scores, mask).numpy(), [2, 2])


def test_rel_shared_on_a_four_rank_mesh_equals_the_exact_rank():
    specs = [tasks.synthetic_stream(e) for e in (0, 2)]
    outs = dry.spawn(tasks.synthetic_rel_shared_specs, 4, specs, device="cpu")
    for rank_out in outs:
        for spec, out in zip(specs, rank_out):
            np.testing.assert_array_equal(out["ranks"], tasks.exact_ranks(spec))
            assert out["n"] == 18
