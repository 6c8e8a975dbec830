"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each a share of the
reference's own scale."""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(a, b) -> float:
    """max |a − b| over max |b| of two tensors of one shape (inf when the
    shapes differ or a value is not finite)."""
    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    if a.shape != b.shape or not torch.isfinite(a).all():
        return float("inf")
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def loss_gap(program: list, reference: list) -> float:
    """The largest |program − reference| / |reference| over the steps."""
    if len(program) != len(reference):
        return float("inf")
    return max(abs(float(p) - float(r)) / max(abs(float(r)), 1e-30)
               for p, r in zip(program, reference))


def norm_gap(program: dict, reference: dict, leaves=None, stat: str = "max") -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's
    (not the norm of their difference), over the reference's norm of that
    leaf or of the median leaf, whichever is larger. A leaf the program
    lacks reads as 0. Returns (gap, leaf)."""
    leaves = sorted(reference) if leaves is None else leaves
    ref = {k: float(torch.linalg.norm(reference[k].double())) for k in leaves}
    if not ref:
        return float("inf"), ""
    med = float(np.median(list(ref.values())))
    gaps = {}
    for k in leaves:
        p = program.get(k)
        pn = float(torch.linalg.norm(p.double())) if p is not None else 0.0
        if not np.isfinite(pn):
            return float("inf"), k
        gaps[k] = abs(pn - ref[k]) / max(ref[k], med, 1e-30)
    if stat == "median":
        return float(np.median(list(gaps.values()))), ""
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moved(ref_grads: dict, floor: float = 1e-3) -> dict:
    """Per leaf, the elements whose first reference gradient is at least
    ``floor`` of the median leaf's root-mean-square gradient; the others
    (a key's bias under softmax, rows no token reached) move under Adam by
    round-off alone. Leaves with no such element are left out."""
    rms = {k: float(g.double().pow(2).mean().sqrt()) for k, g in ref_grads.items()}
    cut = floor * float(np.median(list(rms.values())))
    masks = {k: g.abs() >= cut for k, g in ref_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def training(losses: list, grads: dict, params: dict, ref: dict, p0: dict) -> dict:
    """Every training number of the program's checked steps (``losses``,
    first ``grads``, ``params`` after the last) against the reference's
    (``ref``: losses, grads, params), both from ``p0``: the loss gaps over
    all steps and the first, and the first gradient's and the change's
    gaps at the worst and the median leaf, the change over the moved
    elements only."""
    counted = moved(ref["grads"])
    change_p = {k: (params[k] - p0[k])[m] for k, m in counted.items()}
    change_r = {k: (ref["params"][k] - p0[k])[m] for k, m in counted.items()}
    grad_gap, grad_leaf = norm_gap(grads, ref["grads"])
    change_gap, change_leaf = norm_gap(change_p, change_r)
    return dict(loss_gap=loss_gap(losses, ref["losses"]),
                loss1_gap=loss_gap(losses[:1], ref["losses"][:1]),
                grad_gap=grad_gap, grad_median=norm_gap(grads, ref["grads"], stat="median")[0],
                change_gap=change_gap,
                change_median=norm_gap(change_p, change_r, stat="median")[0],
                grad_leaf=grad_leaf, change_leaf=change_leaf, leaves=len(ref["grads"]),
                moved_elements=sum(int(m.sum()) for m in counted.values()),
                elements=sum(g.numel() for g in ref["grads"].values()),
                losses=list(losses), reference_losses=list(ref["losses"]))


def split(numbers: dict, compared: tuple) -> tuple[dict, dict]:
    """(the compared numbers, the rest as notes)."""
    return ({k: numbers[k] for k in compared},
            {k: v for k, v in numbers.items() if k not in compared})


def rank_slack(ranks, ref_scores: list, true_ids: list, cand_ids: list) -> float:
    """The least score perturbation that makes each of the program's ranks
    a rank of the reference's scores, worst over the queries.

    A query's rank is 1 + #(candidates scoring at least the true tail, or
    carrying the true tail's id). With the reference's differences
    d_c = s_c − s_true (+inf for the true tail's id) sorted in descending
    order, rank r is reached by a perturbation ε when #(d > ε) ≤ r − 1 ≤
    #(d ≥ −ε): ε ≥ d_(r) and ε ≥ −d_(r−1)."""
    worst = 0.0
    if len(ranks) != len(ref_scores):
        return float("inf")
    for r, (s_true, s), t, ids in zip(ranks, ref_scores, true_ids, cand_ids):
        d = np.where(np.asarray(ids) == t, np.inf, np.asarray(s, np.float64) - s_true)
        d = np.sort(d)[::-1]
        r = int(r)
        if r < 1 or r > len(d) + 1:
            return float("inf")
        need = 0.0
        if r <= len(d):
            need = max(need, d[r - 1])
        if r >= 2:
            need = max(need, -d[r - 2])
        worst = max(worst, need)
    return float(worst)
