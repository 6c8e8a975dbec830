"""Knowledge-graph-embedding score functions (port of mre_tpu/models/kge.py).

The OpenKE model zoo (OpenKE/openke/module/model/*.py: TransE, TransH,
TransR, TransD, DistMult, ComplEx, RESCAL, Analogy, SimplE, RotatE, HolE) as
functions over a parameter dict whose keys are the JAX package's (``ent``,
``rel``, ``norm``, ``mat``, ``ent_p``, ``rel_p``, ``ent_re`` / ``ent_im`` /
``rel_re`` / ``rel_im``, ``rel_inv``, and RotatE's constants ``margin`` and
``rel_range``):

* ``init(generator, n_ent, n_rel, dim, ...)`` → the dict (CPU tensors);
* ``score(params, h, r, t)`` → training-orientation score, broadcasting over
  any index shapes;
* ``predict(params, h, r, t)`` → lower-is-better ranking score;
* ``regularization(params, h, r, t)``;
* optional ``score_all_tails`` / ``score_all_heads(params, anchor, r)`` →
  [B, E] predict-orientation scores of every entity by one matrix product;
* optional ``score_pos_neg(params, batch)`` → (p [B], n [B, N]) for a
  ``NegativeBatch`` (TransR and RotatE).

``Params`` holds such a dict as an ``nn.Module``: the tables are dense
``nn.Parameter``s indexed by integer tensors (Adam decays the moments of
every row, as optax does), RotatE's constants are buffers (no gradient, no
weight decay). HolE's circular correlation uses ``torch.fft`` in complex64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

# RotatE's frozen constants (RotatE.py: requires_grad=False)
FROZEN = ("margin", "rel_range")


def xavier_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """xavier_uniform over the full table, torch's init of an [rows, dim]
    embedding weight: limit = sqrt(6 / (rows + dim))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return _uniform(generator, shape, limit)


def _uniform(generator: torch.Generator, shape, limit: float) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def _norm(x, p, exact: bool = False):
    """L1 or L2 norm over the last axis; ``exact`` sums in float64 and
    rounds to float32, so the result does not depend on the order a
    device sums in."""
    dtype = torch.float64 if exact else None
    if p == 1:
        return x.abs().sum(dim=-1, dtype=dtype).to(x.dtype)
    return torch.sqrt(torch.clamp((x * x).sum(dim=-1, dtype=dtype), min=1e-30)).to(x.dtype)


def _l2n(x, eps: float = 1e-12, exact: bool = False):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True,
                                    dtype=torch.float64 if exact else None)
    return x / torch.clamp(norm, min=eps).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class KGEModel:
    name: str
    init: Callable
    score: Callable                 # training orientation (reference forward())
    predict: Callable               # lower-is-better ranking orientation
    regularization: Callable
    higher_is_better: bool          # orientation of `score` for loss wiring
    score_all_tails: Callable | None = None
    score_all_heads: Callable | None = None
    score_pos_neg: Callable | None = None


MODELS: dict[str, KGEModel] = {}


def register(model: KGEModel) -> KGEModel:
    MODELS[model.name] = model
    return model


def get(name: str) -> KGEModel:
    if name not in MODELS:
        raise KeyError(f"unknown KGE model {name!r}; have {sorted(MODELS)}")
    return MODELS[name]


class Params(nn.Module):
    """A KGE parameter dict as a module: every tensor under its JAX key, the
    FROZEN ones as buffers."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            v = torch.as_tensor(v)
            if k in FROZEN:
                self.register_buffer(k, v.clone())
            else:
                self.register_parameter(k, nn.Parameter(v.clone()))

    def tree(self) -> dict:
        """name → tensor (the parameters themselves, not copies)."""
        return {**dict(self.named_parameters(recurse=False)),
                **dict(self.named_buffers(recurse=False))}


def is_entity_table(key: str) -> bool:
    """Whether the parameter ``key`` is indexed by entity id (``ent``,
    ``ent_p``, ``ent_re``, ``ent_im``): the tables a model axis splits."""
    return key.startswith("ent")


def _mean_sq(*xs):
    return sum((x * x).mean() for x in xs) / len(xs)


def _table_init(generator, shape, dim, margin=None, epsilon=None):
    """Reference embedding-init branch (TransE.py:20-36; the same in
    TransH / TransD / DistMult / HolE): xavier_uniform unless BOTH margin and
    epsilon are given, then uniform(±(margin + epsilon) / dim)."""
    if margin is None or epsilon is None:
        return xavier_uniform(generator, shape)
    return _uniform(generator, shape, (margin + epsilon) / dim)


# --------------------------------------------------------------------------
# Translation family
# --------------------------------------------------------------------------

def _transe_init(generator, n_ent, n_rel, dim=200, margin=None, epsilon=None, **kw):
    return {"ent": _table_init(generator, (n_ent, dim), dim, margin, epsilon),
            "rel": _table_init(generator, (n_rel, dim), dim, margin, epsilon)}


def _transe_score(params, h, r, t, p_norm=1, norm_flag=True, exact=False):
    he, re, te = params["ent"][h], params["rel"][r], params["ent"][t]
    if norm_flag:
        he, re, te = _l2n(he, exact=exact), _l2n(re, exact=exact), _l2n(te, exact=exact)
    return _norm(he + re - te, p_norm, exact)


def _transe_predict(params, h, r, t, p_norm=1, norm_flag=True):
    """The score, with its norms summed in float64: ranks then do not depend
    on a device's summation order (at random weights over ~15k entities,
    float32 order alone moves ~1.5% of the ranks by one)."""
    return _transe_score(params, h, r, t, p_norm, norm_flag, exact=True)


def _transe_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r])


register(KGEModel(
    name="transe", init=_transe_init, score=_transe_score, predict=_transe_predict,
    regularization=_transe_reg, higher_is_better=False,
))


def _transh_init(generator, n_ent, n_rel, dim=200, margin=None, epsilon=None, **kw):
    return {"ent": _table_init(generator, (n_ent, dim), dim, margin, epsilon),
            "rel": _table_init(generator, (n_rel, dim), dim, margin, epsilon),
            "norm": _table_init(generator, (n_rel, dim), dim, margin, epsilon)}


def _transh_score(params, h, r, t, p_norm=1, norm_flag=True):
    he, re, te = params["ent"][h], params["rel"][r], params["ent"][t]
    w = _l2n(params["norm"][r])
    he = he - (he * w).sum(dim=-1, keepdim=True) * w
    te = te - (te * w).sum(dim=-1, keepdim=True) * w
    if norm_flag:
        he, re, te = _l2n(he), _l2n(re), _l2n(te)
    return _norm(he + re - te, p_norm)


def _transh_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r], params["norm"][r])


register(KGEModel(
    name="transh", init=_transh_init, score=_transh_score, predict=_transh_score,
    regularization=_transh_reg, higher_is_better=False,
))


def _transr_init(generator, n_ent, n_rel, dim_e=None, dim_r=None, dim=200,
                 rand_init=False, **kw):
    # dim is the KGETrainer-facing knob; dim_e/dim_r override it (TransR.py)
    dim_e = dim if dim_e is None else dim_e
    dim_r = dim if dim_r is None else dim_r
    ent = xavier_uniform(generator, (n_ent, dim_e))
    rel = xavier_uniform(generator, (n_rel, dim_r))
    if rand_init:
        mat = xavier_uniform(generator, (n_rel, dim_e * dim_r)).reshape(n_rel, dim_e, dim_r)
    else:
        mat = torch.eye(dim_e, dim_r).expand(n_rel, dim_e, dim_r).clone()
    return {"ent": ent, "rel": rel, "mat": mat}


def _project(e, m):
    """e [..., de] through m [..., de, dr] (broadcast) → [..., dr]."""
    return torch.matmul(e.unsqueeze(-2), m).squeeze(-2)


def _transr_score(params, h, r, t, p_norm=1, norm_flag=True):
    he, re, te = params["ent"][h], params["rel"][r], params["ent"][t]
    m = params["mat"][r]                                   # [..., de, dr]
    he, te = _project(he, m), _project(te, m)
    if norm_flag:
        he, re, te = _l2n(he), _l2n(re), _l2n(te)
    return _norm(he + re - te, p_norm)


def _transr_score_pos_neg(params, batch, p_norm=1, norm_flag=True):
    """Structured TransR scorer: M_r gathered once per POSITIVE and shared by
    its negatives as batched products (the generic path gathers
    [B, N, de, dr] relation matrices)."""
    r = batch.r
    m = params["mat"][r]                                   # [B, de, dr]
    re = params["rel"][r]
    hp = torch.bmm(params["ent"][batch.h][:, None, :], m)[:, 0]
    tp = torch.bmm(params["ent"][batch.t][:, None, :], m)[:, 0]
    nhp = torch.bmm(params["ent"][batch.neg_h], m)          # [B, N, dr]
    ntp = torch.bmm(params["ent"][batch.neg_t], m)
    if norm_flag:
        hp, tp, re = _l2n(hp), _l2n(tp), _l2n(re)
        nhp, ntp = _l2n(nhp), _l2n(ntp)
    return _norm(hp + re - tp, p_norm), _norm(nhp + re[:, None, :] - ntp, p_norm)


def transr_all_tails(params, h, r, p_norm=1, norm_flag=True):
    """Rank-all-tails for TransR: the WHOLE entity table projected with each
    query's M_r in one product (no per-candidate matrix gather); distances,
    lower = better. Memory is [B, E, dr]: bound it with the eval chunk."""
    m = params["mat"][r]                                   # [B, de, dr]
    hp = torch.bmm(params["ent"][h][:, None, :], m)[:, 0]
    re = params["rel"][r]
    ep = torch.einsum("ed,bdk->bek", params["ent"], m)      # [B, E, dr]
    if norm_flag:
        hp, re, ep = _l2n(hp), _l2n(re), _l2n(ep)
    return _norm((hp + re)[:, None, :] - ep, p_norm)


def transr_all_heads(params, t, r, p_norm=1, norm_flag=True):
    m = params["mat"][r]
    tp = torch.bmm(params["ent"][t][:, None, :], m)[:, 0]
    re = params["rel"][r]
    ep = torch.einsum("ed,bdk->bek", params["ent"], m)
    if norm_flag:
        tp, re, ep = _l2n(tp), _l2n(re), _l2n(ep)
    return _norm(ep + (re - tp)[:, None, :], p_norm)


def _transr_reg(params, h, r, t):
    reg = _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r], params["mat"][r])
    return reg * reg  # the reference squares TransR's regularizer (TransR.py:102)


register(KGEModel(
    name="transr", init=_transr_init, score=_transr_score, predict=_transr_score,
    regularization=_transr_reg, higher_is_better=False,
    score_pos_neg=_transr_score_pos_neg,
))


def _transd_init(generator, n_ent, n_rel, dim_e=None, dim_r=None, dim=200,
                 margin=None, epsilon=None, **kw):
    # dim is the KGETrainer-facing knob; dim_e/dim_r override it (TransD.py)
    dim_e = dim if dim_e is None else dim_e
    dim_r = dim if dim_r is None else dim_r
    # TransD.py:29-54: separate ent/rel ranges, transfers share them
    return {"ent": _table_init(generator, (n_ent, dim_e), dim_e, margin, epsilon),
            "rel": _table_init(generator, (n_rel, dim_r), dim_r, margin, epsilon),
            "ent_p": _table_init(generator, (n_ent, dim_e), dim_e, margin, epsilon),
            "rel_p": _table_init(generator, (n_rel, dim_r), dim_r, margin, epsilon)}


def _resize_last(x, size):
    cur = x.shape[-1]
    if cur >= size:
        return x[..., :size]
    return torch.nn.functional.pad(x, (0, size - cur))


def _transd_score(params, h, r, t, p_norm=1, norm_flag=True):
    he, re, te = params["ent"][h], params["rel"][r], params["ent"][t]
    hp, tp, rp = params["ent_p"][h], params["ent_p"][t], params["rel_p"][r]
    he = _l2n(_resize_last(he, rp.shape[-1]) + (he * hp).sum(dim=-1, keepdim=True) * rp)
    te = _l2n(_resize_last(te, rp.shape[-1]) + (te * tp).sum(dim=-1, keepdim=True) * rp)
    if norm_flag:
        he, re, te = _l2n(he), _l2n(re), _l2n(te)
    return _norm(he + re - te, p_norm)


def _transd_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r],
                    params["ent_p"][h], params["ent_p"][t], params["rel_p"][r])


register(KGEModel(
    name="transd", init=_transd_init, score=_transd_score, predict=_transd_score,
    regularization=_transd_reg, higher_is_better=False,
))


# --------------------------------------------------------------------------
# Bilinear family (matrix-product fast paths for rank-all eval)
# --------------------------------------------------------------------------

def _distmult_init(generator, n_ent, n_rel, dim=200, margin=None, epsilon=None, **kw):
    return {"ent": _table_init(generator, (n_ent, dim), dim, margin, epsilon),
            "rel": _table_init(generator, (n_rel, dim), dim, margin, epsilon)}


def _distmult_score(params, h, r, t):
    return (params["ent"][h] * params["rel"][r] * params["ent"][t]).sum(dim=-1)


def _distmult_all_tails(params, h, r):
    return -((params["ent"][h] * params["rel"][r]) @ params["ent"].T)


def _distmult_all_heads(params, t, r):
    return -((params["ent"][t] * params["rel"][r]) @ params["ent"].T)


def _distmult_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r])


def distmult_l3_regularization(params):
    """Reference DistMult.l3_regularization (DistMult.py:69-70)."""
    return (params["ent"].abs() ** 3).sum() + (params["rel"].abs() ** 3).sum()


register(KGEModel(
    name="distmult", init=_distmult_init, score=_distmult_score,
    predict=lambda p, h, r, t: -_distmult_score(p, h, r, t),
    regularization=_distmult_reg, higher_is_better=True,
    score_all_tails=_distmult_all_tails, score_all_heads=_distmult_all_heads,
))


def _complex_init(generator, n_ent, n_rel, dim=200, **kw):
    return {"ent_re": xavier_uniform(generator, (n_ent, dim)),
            "ent_im": xavier_uniform(generator, (n_ent, dim)),
            "rel_re": xavier_uniform(generator, (n_rel, dim)),
            "rel_im": xavier_uniform(generator, (n_rel, dim))}


def _complex_score(params, h, r, t):
    hr, hi = params["ent_re"][h], params["ent_im"][h]
    tr, ti = params["ent_re"][t], params["ent_im"][t]
    rr, ri = params["rel_re"][r], params["rel_im"][r]
    return (hr * tr * rr + hi * ti * rr + hr * ti * ri - hi * tr * ri).sum(dim=-1)


def _complex_sim_all_tails(params, h, r):
    hr, hi = params["ent_re"][h], params["ent_im"][h]
    rr, ri = params["rel_re"][r], params["rel_im"][r]
    a = hr * rr - hi * ri     # coefficient of t_re
    b = hi * rr + hr * ri     # coefficient of t_im
    return a @ params["ent_re"].T + b @ params["ent_im"].T


def _complex_sim_all_heads(params, t, r):
    tr, ti = params["ent_re"][t], params["ent_im"][t]
    rr, ri = params["rel_re"][r], params["rel_im"][r]
    a = tr * rr + ti * ri     # coefficient of h_re
    b = ti * rr - tr * ri     # coefficient of h_im
    return a @ params["ent_re"].T + b @ params["ent_im"].T


def _complex_reg(params, h, r, t):
    return _mean_sq(params["ent_re"][h], params["ent_im"][h], params["ent_re"][t],
                    params["ent_im"][t], params["rel_re"][r], params["rel_im"][r])


register(KGEModel(
    name="complex", init=_complex_init, score=_complex_score,
    predict=lambda p, h, r, t: -_complex_score(p, h, r, t),
    regularization=_complex_reg, higher_is_better=True,
    score_all_tails=lambda p, h, r: -_complex_sim_all_tails(p, h, r),
    score_all_heads=lambda p, t, r: -_complex_sim_all_heads(p, t, r),
))


def _rescal_init(generator, n_ent, n_rel, dim=200, **kw):
    return {"ent": xavier_uniform(generator, (n_ent, dim)),
            "mat": xavier_uniform(generator, (n_rel, dim * dim)).reshape(n_rel, dim, dim)}


def _rescal_score(params, h, r, t):
    # the reference RESCAL forward returns NEGATIVE similarity (RESCAL.py:22)
    he, te = params["ent"][h], params["ent"][t]
    tr = torch.matmul(params["mat"][r], te.unsqueeze(-1)).squeeze(-1)
    return -(he * tr).sum(dim=-1)


def _rescal_all_tails(params, h, r):
    hm = torch.bmm(params["ent"][h][:, None, :], params["mat"][r])[:, 0]
    return -(hm @ params["ent"].T)


def _rescal_all_heads(params, t, r):
    mt = torch.bmm(params["mat"][r], params["ent"][t][:, :, None])[:, :, 0]
    return -(mt @ params["ent"].T)


def _rescal_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["mat"][r])


register(KGEModel(
    # RESCAL's forward is already lower-is-better; the reference's predict()
    # negates it again (RESCAL.py:44), a defect the JAX package repairs:
    # predict keeps the lower-is-better orientation (= forward)
    name="rescal", init=_rescal_init, score=_rescal_score, predict=_rescal_score,
    regularization=_rescal_reg, higher_is_better=False,
    score_all_tails=_rescal_all_tails, score_all_heads=_rescal_all_heads,
))


def _analogy_init(generator, n_ent, n_rel, dim=200, **kw):
    return {"ent_re": xavier_uniform(generator, (n_ent, dim)),
            "ent_im": xavier_uniform(generator, (n_ent, dim)),
            "rel_re": xavier_uniform(generator, (n_rel, dim)),
            "rel_im": xavier_uniform(generator, (n_rel, dim)),
            "ent": xavier_uniform(generator, (n_ent, dim * 2)),
            "rel": xavier_uniform(generator, (n_rel, dim * 2))}


def _analogy_score(params, h, r, t):
    # the reference Analogy forward = -(complex part + distmult part)
    # (Analogy.py:26-31)
    dm = (params["ent"][h] * params["rel"][r] * params["ent"][t]).sum(dim=-1)
    return -(_complex_score(params, h, r, t) + dm)


def _analogy_all_tails(params, h, r):
    # predict orientation: Analogy.predict = −forward = cpx + dm
    dm = (params["ent"][h] * params["rel"][r]) @ params["ent"].T
    return _complex_sim_all_tails(params, h, r) + dm


def _analogy_all_heads(params, t, r):
    dm = (params["ent"][t] * params["rel"][r]) @ params["ent"].T
    return _complex_sim_all_heads(params, t, r) + dm


def _analogy_reg(params, h, r, t):
    return _mean_sq(params["ent_re"][h], params["ent_im"][h], params["ent"][h],
                    params["ent_re"][t], params["ent_im"][t], params["ent"][t],
                    params["rel_re"][r], params["rel_im"][r], params["rel"][r])


register(KGEModel(
    name="analogy", init=_analogy_init, score=_analogy_score,
    predict=lambda p, h, r, t: -_analogy_score(p, h, r, t),
    regularization=_analogy_reg, higher_is_better=True,
    score_all_tails=_analogy_all_tails, score_all_heads=_analogy_all_heads,
))


def _simple_init(generator, n_ent, n_rel, dim=200, **kw):
    return {"ent": xavier_uniform(generator, (n_ent, dim)),
            "rel": xavier_uniform(generator, (n_rel, dim)),
            "rel_inv": xavier_uniform(generator, (n_rel, dim))}


def _simple_score(params, h, r, t):
    he, te = params["ent"][h], params["ent"][t]
    re, ri = params["rel"][r], params["rel_inv"][r]
    return ((he * re * te).sum(dim=-1) + (he * ri * te).sum(dim=-1)) / 2


def _simple_predict(params, h, r, t):
    # the reference SimplE.predict uses the forward direction only (SimplE.py:48-54)
    return -(params["ent"][h] * params["rel"][r] * params["ent"][t]).sum(dim=-1)


def _simple_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r], params["rel_inv"][r])


register(KGEModel(
    name="simple", init=_simple_init, score=_simple_score, predict=_simple_predict,
    regularization=_simple_reg, higher_is_better=True,
    score_all_tails=_distmult_all_tails, score_all_heads=_distmult_all_heads,
))


# --------------------------------------------------------------------------
# Rotation / correlation family
# --------------------------------------------------------------------------

def _rotate_init(generator, n_ent, n_rel, dim=200, margin=6.0, epsilon=2.0, **kw):
    dim_e, dim_r = dim * 2, dim
    ent_range = (margin + epsilon) / dim_e
    rel_range = (margin + epsilon) / dim_r
    return {"ent": _uniform(generator, (n_ent, dim_e), ent_range),
            "rel": _uniform(generator, (n_rel, dim_r), rel_range),
            "margin": torch.tensor(margin, dtype=torch.float32),
            "rel_range": torch.tensor(rel_range, dtype=torch.float32)}


def _rotation(params, r, exact: bool = False):
    """cos and sin of the relation phases; margin and rel_range are frozen
    (buffers here, ``stop_gradient`` in JAX). ``exact`` takes them in
    float64, rounded to float32: the same bits on every device."""
    phase = params["rel"][r] / (params["rel_range"].detach() / math.pi)
    if exact:
        phase = phase.double()
        return torch.cos(phase).float(), torch.sin(phase).float()
    return torch.cos(phase), torch.sin(phase)


def _dsum(s_re, s_im, exact: bool = False):
    d = torch.sqrt(torch.clamp(s_re * s_re + s_im * s_im, min=1e-30))
    if exact:
        return d.sum(dim=-1, dtype=torch.float64).float()
    return d.sum(dim=-1)


def _rotate_distance(params, h, r, t, exact: bool = False):
    he, te = params["ent"][h], params["ent"][t]
    dim = params["rel"].shape[-1]
    h_re, h_im = he[..., :dim], he[..., dim:]
    t_re, t_im = te[..., :dim], te[..., dim:]
    r_re, r_im = _rotation(params, r, exact)
    return _dsum(h_re * r_re - h_im * r_im - t_re, h_re * r_im + h_im * r_re - t_im, exact)


def _rotate_score(params, h, r, t):
    # the reference RotatE forward = margin − distance (RotatE.py:83-92)
    return params["margin"].detach() - _rotate_distance(params, h, r, t)


def _rotate_predict(params, h, r, t):
    """The reference predict = −forward = distance − margin (RotatE.py:94-96).

    The distance is accumulated in float64 (with float64 rotations), so
    ranks do not depend on a device's summation order: at near-init weights
    every entity scores within ~1% of every other, and float32 summation
    order alone moves ~20% of the ranks."""
    return _rotate_distance(params, h, r, t, exact=True) - params["margin"].detach()


def _rotate_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r])


def _rotate_score_pos_neg(params, batch):
    """Structured RotatE scorer: the rotation is computed once per POSITIVE
    ([B, dim], not per negative), and with the batch's sided view
    (``neg_ent`` / ``neg_side``) only the CORRUPTED entity is gathered per
    negative, so the uncorrupted side's gradient reaches the table through a
    reduction over N, not an N-way colliding scatter-add per positive row."""
    dim = params["rel"].shape[-1]
    r_re, r_im = _rotation(params, batch.r)                 # [B, dim]

    def split(e):
        return e[..., :dim], e[..., dim:]

    h_re, h_im = split(params["ent"][batch.h])
    t_re, t_im = split(params["ent"][batch.t])
    hr_re = h_re * r_re - h_im * r_im                       # h ∘ r
    hr_im = h_re * r_im + h_im * r_re
    margin = params["margin"].detach()
    p = margin - _dsum(hr_re - t_re, hr_im - t_im)

    if batch.neg_ent is None:
        nh_re, nh_im = split(params["ent"][batch.neg_h])
        nt_re, nt_im = split(params["ent"][batch.neg_t])
        s_re = nh_re * r_re[:, None] - nh_im * r_im[:, None] - nt_re
        s_im = nh_re * r_im[:, None] + nh_im * r_re[:, None] - nt_im
        return p, margin - _dsum(s_re, s_im)

    e_re, e_im = split(params["ent"][batch.neg_ent])        # [B, N, dim]
    # tail replaced: |h∘r − e|; head replaced: |e∘r − t| = |e − t∘conj(r)|
    # (unit-modulus rotation): both sides are |e − c| with a per-positive c
    tc_re = t_re * r_re + t_im * r_im                       # t ∘ conj(r)
    tc_im = t_im * r_re - t_re * r_im
    side = batch.neg_side[..., None]
    c_re = torch.where(side, hr_re[:, None], tc_re[:, None])
    c_im = torch.where(side, hr_im[:, None], tc_im[:, None])
    return p, margin - _dsum(e_re - c_re, e_im - c_im)


register(KGEModel(
    name="rotate", init=_rotate_init, score=_rotate_score, predict=_rotate_predict,
    regularization=_rotate_reg, higher_is_better=True,
    score_pos_neg=_rotate_score_pos_neg,
))


def _hole_init(generator, n_ent, n_rel, dim=200, margin=None, epsilon=None, **kw):
    return {"ent": _table_init(generator, (n_ent, dim), dim, margin, epsilon),
            "rel": _table_init(generator, (n_rel, dim), dim, margin, epsilon)}


def _fft(x):
    return torch.fft.fft(x.to(torch.complex64), dim=-1)


def _ccorr(a, b):
    """Circular correlation via FFT: ifft(conj(fft(a)) · fft(b)).real."""
    return torch.fft.ifft(torch.conj(_fft(a)) * _fft(b), dim=-1).real.to(torch.float32)


def _hole_score(params, h, r, t):
    return (_ccorr(params["ent"][h], params["ent"][t]) * params["rel"][r]).sum(dim=-1)


def _hole_all_tails(params, h, r):
    # Σ_k r_k ccorr(h, t)_k = Σ_m t_m (h ⊛ r)_m, ⊛ the circular convolution:
    # one product against the entity table
    c = torch.fft.ifft(_fft(params["ent"][h]) * _fft(params["rel"][r]), dim=-1).real
    return c.to(torch.float32) @ params["ent"].T


def _hole_all_heads(params, t, r):
    # Σ_k r_k Σ_m h_m t_{(m+k) mod n} = Σ_m h_m ccorr(r, t)_m
    return _ccorr(params["rel"][r], params["ent"][t]) @ params["ent"].T


def _hole_reg(params, h, r, t):
    return _mean_sq(params["ent"][h], params["ent"][t], params["rel"][r])


def hole_l3_regularization(params):
    return (params["ent"].abs() ** 3).sum() + (params["rel"].abs() ** 3).sum()


register(KGEModel(
    name="hole", init=_hole_init, score=_hole_score,
    predict=lambda p, h, r, t: -_hole_score(p, h, r, t),
    regularization=_hole_reg, higher_is_better=True,
    score_all_tails=lambda p, h, r: -_hole_all_tails(p, h, r),
    score_all_heads=lambda p, t, r: -_hole_all_heads(p, t, r),
))

# the distance models: their score and predict take p_norm / norm_flag
DISTANCE_MODELS = ("transe", "transh", "transr", "transd")
