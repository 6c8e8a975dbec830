"""Filtered negative sampling on the device (port of mre_tpu/ops/sampling.py).

Replaces the reference's pthread C++ sampler (OpenKE base/Base.cpp:78-197)
and its Python cousin (module/NegativeSampling.py:114-140, 321-375):

* ``_complement_draw`` / ``corrupt_tails`` / ``corrupt_heads`` — exact
  complement sampling, the index shift of OpenKE base/Corrupt.h:7-83 ("draw
  u uniform over entityTotal − |true set|, then shift u past the sorted true
  set"), vectorized and rejection-free in two tiers: one padded gather of
  the CSR true-set slice for normal rows, and a top-k compaction of the
  draws on oversized rows resolved against the dense (value − rank) matrix
  (``_resolve_overflow``, which counts the draws its width truncates);
* ``corrupt_batch`` / ``sample_training_batch`` — the KGE trainers' batch:
  uniform positives, ``n_neg`` filtered corruptions each, head or tail by a
  uniform or Bernoulli (base/Reader.h:141-158) choice;
* ``corrupt_relations`` / ``corrupt_relations_prob`` — filtered relation
  corruption over the by-(h, t) relation index, uniform or weighted by the
  kl_prob softmax table (``relation_prob_table``; base/Corrupt.h:86-134);
* ``_contains`` — the membership test (the base/Corrupt.h:166-177 ``_find``,
  batched) and ``corrupt_within_nodes``, the fusion trainer's
  subgraph-local corruption with rejection rounds.

Every random draw is an argument, and a draw not given comes from the
caller's ``torch.Generator`` on the generator's device, never from a global
stream, so a test can feed the JAX package's draws in. A bounded integer
draw whose bound differs per row is ``floor(uniform_float64 × bound)``,
uniform over ``[0, bound)`` as ``jax.random.randint`` is.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from mre_tpu_torch.data.kg import EXACT_PAD as KG_EXACT_PAD
from mre_tpu_torch.data.kg import DeviceKG
from mre_tpu_torch.ops.losses import _argmax_first

EXACT_PAD = KG_EXACT_PAD
REJECTION_ROUNDS = 12


def _overflow_slots(n: int, frac: float) -> int:
    """Tier-2 compaction width for ``n`` draws when a ``frac`` fraction is
    expected to hit an oversized CSR row: full coverage up to 8192 draws,
    else 4× the expected overflow count plus a margin."""
    if n <= 8192:
        return n
    return max(1024, n // 16, min(n, int(n * frac * 4) + 128))


def _top_k_indices(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``flags``, ties by lower index first:
    the order ``lax.top_k`` gives (a stable descending sort)."""
    return torch.sort(flags.to(torch.float32), descending=True, stable=True).indices[:k]


def _draw_dev(generator: torch.Generator | None):
    return generator.device if generator is not None else "cpu"


def _randint_below(bound: torch.Tensor, shape, generator: torch.Generator | None):
    """Integers uniform over ``[0, bound)`` per element (``bound`` ≥ 1,
    broadcast to ``shape``): ``floor(u · bound)`` with ``u`` a float64
    uniform, so no modulo bias."""
    u = torch.rand(shape, dtype=torch.float64, generator=generator,
                   device=_draw_dev(generator))
    bound = bound.to(u.device, torch.float64)
    return torch.minimum(torch.floor(u * bound), bound - 1).to(torch.int64)


def _contains(kg: DeviceKG, h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
              pad: int | None = None) -> torch.Tensor:
    """Whether each (h, r, t) is a true triple; bool, the shape of ``h``."""
    pad = pad or KG_EXACT_PAD
    shape = h.shape
    h, r, t = (x.reshape(-1).to(torch.int64) for x in (h, r, t))
    start, cnt, ridx = kg.hr_range(h * kg.n_relations + r)
    lane = torch.arange(pad, device=h.device)
    gidx = torch.clamp(start[:, None] + lane[None, :], max=kg.hrt_tails.shape[0] - 1)
    vals = kg.hrt_tails[gidx].to(torch.int64)
    valid = lane[None, :] < torch.clamp(cnt, max=pad)[:, None]
    found = (valid & (vals == t[:, None])).any(dim=-1)

    if kg.hr_big_d.shape[0] > 0:
        overflow = cnt > pad
        n = found.shape[0]
        idx = _top_k_indices(overflow, min(n, _overflow_slots(n, kg.hr_overflow_frac)))
        slot = torch.clamp(kg.hr_big_index[ridx[idx]], min=0).to(torch.int64)
        lane_b = torch.arange(kg.hr_big_d.shape[1], device=h.device)
        big_vals = kg.hr_big_d[slot].to(torch.int64) + lane_b[None, :]   # d + rank
        found_big = (big_vals == t[idx][:, None]).any(dim=-1)
        found = found.clone()
        found[idx] = torch.where(overflow[idx], found_big, found[idx])
    return found.reshape(shape)


def corrupt_within_nodes(kg: DeviceKG, n_id: torch.Tensor, h_local: torch.Tensor,
                         r: torch.Tensor, t_local: torch.Tensor, n_neg: int,
                         rounds: int = REJECTION_ROUNDS,
                         generator: torch.Generator | None = None,
                         side: torch.Tensor | None = None,
                         cand_local: torch.Tensor | None = None):
    """Subgraph-local corruption for the fusion trainer.

    Negatives are drawn from the LOCAL node list of the sampled subgraph
    (local ids) and filtered against the global true-triple set through the
    local→global map ``n_id``. Each negative corrupts the tail where
    ``side`` [B, n_neg] is True, else the head; round ``i`` proposes
    ``cand_local[i]`` [B, n_neg], and the first proposal that is not a true
    triple is taken. Draws not given come from ``generator``: ``side`` as
    uniform < 0.5, then ``cand_local`` uniform over the local ids.

    Returns (neg_h_local, neg_t_local, failed), each [B, n_neg]; ``failed``
    marks entries whose ``rounds`` proposals were all true triples; they
    keep the POSITIVE entity, as in the JAX package.
    """
    dev = n_id.device
    B = h_local.shape[0]
    if side is None:
        side = torch.rand((B, n_neg), generator=generator, device=_draw_dev(generator)) < 0.5
    if cand_local is None:
        cand_local = torch.randint(0, n_id.shape[0], (rounds, B, n_neg),
                                   generator=generator, device=_draw_dev(generator))
    side = side.to(dev, torch.bool)
    cand_local = cand_local.to(dev, torch.int64)

    n_id = n_id.to(torch.int64)
    h_local, r, t_local = (x.to(torch.int64) for x in (h_local, r, t_local))
    h_g = n_id[h_local][:, None].expand(B, n_neg)
    t_g = n_id[t_local][:, None].expand(B, n_neg)
    r_b = r[:, None].expand(B, n_neg)

    cur_h = h_local[:, None].expand(B, n_neg).clone()
    cur_t = t_local[:, None].expand(B, n_neg).clone()
    done = torch.zeros(B, n_neg, dtype=torch.bool, device=dev)
    for cand in cand_local:
        cand_g = n_id[cand]
        bad = torch.where(side, _contains(kg, h_g, r_b, cand_g),
                          _contains(kg, cand_g, r_b, t_g))
        take = ~done & ~bad
        cur_t = torch.where(take & side, cand, cur_t)
        cur_h = torch.where(take & ~side, cand, cur_h)
        done = done | take
    return cur_h, cur_t, ~done


def _gather_row_d(values, start, cnt, n_total, pad):
    """Padded (value − rank) slice per row: [B, pad] + cnt [B]. Past the
    row's end, ``n_total + 1``, which no offset reaches."""
    lane = torch.arange(pad, device=start.device)
    gidx = torch.clamp(start[:, None] + lane[None, :], max=values.shape[0] - 1)
    vals = values[gidx].to(torch.int64)
    valid = lane[None, :] < torch.clamp(cnt, max=pad)[:, None]
    d = torch.where(valid, vals - lane[None, :], n_total + 1)
    return d, cnt


def _resolve_overflow(sample, u, ridx, overflow, big_index, big_d,
                      overflow_slots: int | None = None, overflow_frac: float = 0.0):
    """Tier 2: fix the draws whose row exceeds the pad, after a top-k
    compaction of the overflowing draws, against the dense big-row matrix.
    ``ridx`` indexes ``big_index`` (dense row ids, or compact positions).

    ``overflow_slots`` bounds the compaction width: full coverage up to 8192
    draws (exact), else sized from the KG's overflow mass
    (``_overflow_slots``). A draw past the cap keeps its tier-1 value,
    filtered against the first ``pad`` true candidates only.

    Returns ``(sample, truncated)``: ``truncated`` (a 0-dim int64 tensor on
    the sample's device) counts the overflow draws that got no tier-2 slot;
    0 means the filtering was exact."""
    if big_d.shape[0] == 0:
        return sample, torch.zeros((), dtype=torch.int64, device=sample.device)
    flat = sample.reshape(-1)
    n = flat.shape[0]
    if overflow_slots is None:
        overflow_slots = _overflow_slots(n, overflow_frac)
    u_f, rows_f, over_f = u.reshape(-1), ridx.reshape(-1), overflow.reshape(-1)
    idx = _top_k_indices(over_f, min(overflow_slots, n))
    slot = torch.clamp(big_index[rows_f[idx]], min=0).to(torch.int64)
    d_o = big_d[slot].to(torch.int64)
    resolved = u_f[idx] + (d_o <= u_f[idx][:, None]).sum(dim=-1)
    flat = flat.clone()
    flat[idx] = torch.where(over_f[idx], resolved, flat[idx])
    truncated = over_f.sum() - over_f[idx].sum()
    return flat.reshape(sample.shape), truncated


def _complement_draw(values, start, cnt, ridx, big_index, big_d, n_total: int, pad: int,
                     overflow_slots: int | None = None, overflow_frac: float = 0.0,
                     generator: torch.Generator | None = None, u=None):
    """One uniform sample per row from {0..n_total-1} minus the row's true
    set. ``start``/``cnt``/``ridx`` come from ``DeviceKG.hr_range`` /
    ``tr_range``. ``u`` [B] are the complement offsets, each below
    ``max(n_total − cnt, 1)``; drawn from ``generator`` when not given."""
    pad = max(pad, KG_EXACT_PAD)       # the big-row tables cover cnt > KG_EXACT_PAD
    if u is None:
        u = _randint_below(torch.clamp(n_total - cnt, min=1), start.shape, generator)
    u = u.to(start.device, torch.int64)
    d, _ = _gather_row_d(values, start, cnt, n_total, pad)
    # d_i = s_i − i; the u-th allowed value is u + #{i : d_i <= u}
    sample = u + (d <= u[:, None]).sum(dim=-1)
    sample, _ = _resolve_overflow(sample, u, ridx, cnt > pad, big_index, big_d,
                                  overflow_slots, overflow_frac)
    return sample


def corrupt_tails(kg: DeviceKG, h, r, pad: int = EXACT_PAD,
                  generator: torch.Generator | None = None, u=None):
    """One filtered corrupted tail per (h, r): never a true tail."""
    start, cnt, ridx = kg.hr_range(h.to(torch.int64) * kg.n_relations + r.to(torch.int64))
    return _complement_draw(kg.hrt_tails, start, cnt, ridx, kg.hr_big_index, kg.hr_big_d,
                            kg.n_entities, pad, generator=generator, u=u)


def corrupt_heads(kg: DeviceKG, t, r, pad: int = EXACT_PAD,
                  generator: torch.Generator | None = None, u=None):
    """One filtered corrupted head per (t, r): never a true head."""
    start, cnt, ridx = kg.tr_range(t.to(torch.int64) * kg.n_relations + r.to(torch.int64))
    return _complement_draw(kg.trh_heads, start, cnt, ridx, kg.tr_big_index, kg.tr_big_d,
                            kg.n_entities, pad, generator=generator, u=u)


class NegativeBatch(NamedTuple):
    """A positive block plus ``n_neg`` corruption blocks: [B] positives,
    [B, n_neg] negatives (int64).

    ``neg_ent`` / ``neg_side`` are the same corruptions in sided form: the
    sampled entity and whether it replaced the tail (True) or the head. A
    model that scores from them gathers only the corrupted entity per
    negative (RotatE's structured path). ``overflow_truncated`` (0-dim)
    counts the draws whose tier-2 resolution the compaction cap truncated:
    0 means exact filtering."""

    h: torch.Tensor
    r: torch.Tensor
    t: torch.Tensor
    neg_h: torch.Tensor
    neg_t: torch.Tensor
    neg_ent: torch.Tensor | None = None
    neg_side: torch.Tensor | None = None
    overflow_truncated: torch.Tensor | None = None


def corrupt_batch(kg: DeviceKG, h, r, t, n_neg: int, bern: bool = False,
                  pad: int = EXACT_PAD, generator: torch.Generator | None = None,
                  side_u=None, u=None) -> NegativeBatch:
    """``n_neg`` filtered corruptions for each (h, r, t).

    The tail is replaced where ``side_u`` [B, n_neg] (uniforms) is below
    0.5, or below right/(left + right) of the relation when ``bern``
    (Base.cpp:112-115); ``u`` [B, n_neg] are the complement offsets, each
    below ``max(n_entities − cnt, 1)`` for the true set of the side it
    corrupts. Both are drawn from ``generator`` when not given (``side_u``
    first, as the JAX package splits ``k_side`` before ``k_u``).

    Each positive's CSR slice is gathered once and the shift broadcast over
    its negatives: the gather is O(B·pad), not O(B·n_neg·pad)."""
    pad = max(pad, KG_EXACT_PAD)
    dev = kg.hrt_tails.device
    h, r, t = (x.to(dev, torch.int64) for x in (h, r, t))
    B = h.shape[0]
    if side_u is None:
        side_u = torch.rand((B, n_neg), generator=generator, device=_draw_dev(generator))
    if bern:
        lm, rm = kg.left_mean[r], kg.right_mean[r]
        p_replace_tail = rm / torch.clamp(lm + rm, min=1e-9)
    else:
        p_replace_tail = torch.full((B,), 0.5, device=dev)
    side = side_u.to(dev, torch.float32) < p_replace_tail[:, None]     # True → tail

    start_t, cnt_t, ridx_t = kg.hr_range(h * kg.n_relations + r)
    start_h, cnt_h, ridx_h = kg.tr_range(t * kg.n_relations + r)
    d_t, _ = _gather_row_d(kg.hrt_tails, start_t, cnt_t, kg.n_entities, pad)
    d_h, _ = _gather_row_d(kg.trh_heads, start_h, cnt_h, kg.n_entities, pad)

    cnt = torch.where(side, cnt_t[:, None], cnt_h[:, None])            # [B, n_neg]
    if u is None:
        u = _randint_below(torch.clamp(kg.n_entities - cnt, min=1), (B, n_neg), generator)
    u = u.to(dev, torch.int64)
    j_t = (d_t[:, None, :] <= u[:, :, None]).sum(dim=-1)
    j_h = (d_h[:, None, :] <= u[:, :, None]).sum(dim=-1)
    sample = u + torch.where(side, j_t, j_h)

    # tier-2 overflow resolution, per side
    over_t = side & (cnt_t > pad)[:, None]
    over_h = ~side & (cnt_h > pad)[:, None]
    sample, trunc_t = _resolve_overflow(sample, u, ridx_t[:, None].expand(B, n_neg), over_t,
                                        kg.hr_big_index, kg.hr_big_d,
                                        overflow_frac=kg.hr_overflow_frac)
    sample, trunc_h = _resolve_overflow(sample, u, ridx_h[:, None].expand(B, n_neg), over_h,
                                        kg.tr_big_index, kg.tr_big_d,
                                        overflow_frac=kg.tr_overflow_frac)
    neg_t = torch.where(side, sample, t[:, None])
    neg_h = torch.where(side, h[:, None], sample)
    return NegativeBatch(h=h, r=r, t=t, neg_h=neg_h, neg_t=neg_t, neg_ent=sample,
                         neg_side=side, overflow_truncated=trunc_t + trunc_h)


def sample_training_batch(kg: DeviceKG, batch_size: int, n_neg: int, bern: bool = False,
                          pad: int = EXACT_PAD, generator: torch.Generator | None = None,
                          idx=None, side_u=None, u=None) -> NegativeBatch:
    """Uniform positives from the train set, corrupted by ``corrupt_batch``:
    the device's replacement for the C++ ``sampling()`` entry point
    (Base.cpp:162-197). ``idx`` [batch_size] are the positions of the
    positives in ``kg.triples``, drawn first from ``generator`` when not
    given."""
    if idx is None:
        idx = torch.randint(0, kg.triples.shape[0], (batch_size,), generator=generator,
                            device=_draw_dev(generator))
    tri = kg.triples[idx.to(kg.triples.device, torch.int64)].to(torch.int64)
    return corrupt_batch(kg, tri[:, 0], tri[:, 1], tri[:, 2], n_neg, bern, pad,
                         generator=generator, side_u=side_u, u=u)


def _pair_slice(kg: DeviceKG, h, t):
    """The sorted true relations of each (h, t) pair, padded: [B, pad]
    relations, [B, pad] validity and the count k [B]."""
    keys = (h * kg.n_entities + t).to(kg.pair_keys.dtype)     # < 2^31: pair_keys exist
    lo = torch.searchsorted(kg.pair_keys, keys, right=False)
    k = torch.searchsorted(kg.pair_keys, keys, right=True) - lo
    pad = max(int(kg.pair_pad), 1)
    lane = torch.arange(pad, device=keys.device)
    gidx = torch.clamp(lo[:, None] + lane[None, :], max=kg.pair_rels.shape[0] - 1)
    rels = kg.pair_rels[gidx].to(torch.int64)
    return rels, lane[None, :] < k[:, None], k


def corrupt_relations(kg: DeviceKG, r, n_neg: int = 1, h=None, t=None,
                      filter_flag: bool = True, generator: torch.Generator | None = None,
                      u=None):
    """Corrupted relations per positive, [B, n_neg].

    With ``h``/``t`` given and ``filter_flag`` (base/Corrupt.h:95-134): an
    exact complement draw that excludes every relation rr with (h, rr, t) a
    true triple; ``u`` [B, n_neg] are the offsets, each below
    ``max(n_relations − k, 1)``. Otherwise uniform over the relations but
    the positive (Corrupt.h:86-94); ``u`` below ``n_relations − 1``. Rows
    whose pair holds every relation return the positive ``r``."""
    dev = kg.triples.device
    r = r.to(dev, torch.int64)
    B, R = r.shape[0], kg.n_relations
    if h is None or t is None or not filter_flag or kg.pair_keys is None:
        if filter_flag and h is not None and t is not None and kg.pair_keys is None:
            warnings.warn(
                "corrupt_relations: filter_flag requested but the KG is too "
                "large for the (h, t) pair index (E^2 >= 2^31); falling back "
                "to UNFILTERED relation negatives.", stacklevel=2)
        if u is None:
            u = torch.randint(0, R - 1, (B, n_neg), generator=generator,
                              device=_draw_dev(generator))
        v = u.to(dev, torch.int64)
        return torch.where(v < r[:, None], v, v + 1)

    rels, valid, k = _pair_slice(kg, h.to(dev, torch.int64), t.to(dev, torch.int64))
    d = torch.where(valid, rels - torch.arange(rels.shape[1], device=dev)[None, :], R + 1)
    if u is None:
        u = _randint_below(torch.clamp(R - k, min=1)[:, None], (B, n_neg), generator)
    u = u.to(dev, torch.int64)
    sample = u + (d[:, None, :] <= u[:, :, None]).sum(dim=-1)
    # a pair with every relation true has an empty complement: the positive
    # r itself (the native guard ``if (k >= relationTotal) return r``)
    return torch.where((k >= R)[:, None], r[:, None], sample)


def relation_prob_table(kl, temp: float) -> torch.Tensor:
    """importProb semantics (base/Reader.h:25-50): rows of softmax(−kl/temp).
    ``kl`` [R, R−1] in the kl_prob.txt layout (row r lists every relation
    but r: ids below r, then ids above r shifted down by one)."""
    w = torch.exp(-torch.as_tensor(kl, dtype=torch.float32) / temp)
    return w / w.sum(dim=-1, keepdim=True)


def corrupt_relations_prob(kg: DeviceKG, h, t, r, prob, n_neg: int = 1,
                           generator: torch.Generator | None = None, u=None):
    """Probability-weighted filtered relation corruption (the
    base/Corrupt.h:86-134 ``corrupt_rel(p=true)`` path): a relation drawn
    with the kl_prob softmax weights ``prob`` (``relation_prob_table``),
    excluding every rr with (h, rr, t) a true train triple, renormalized over
    the rest by an inverse-CDF draw. ``u`` [B, n_neg] are float32 uniforms
    in [0, 1). Rows with an empty complement return the positive ``r``."""
    if kg.pair_keys is None:
        raise ValueError("corrupt_relations_prob needs the (h, t) pair index "
                         "(KG too large: E^2 >= 2^31)")
    dev = kg.triples.device
    h, t, r = (x.to(dev, torch.int64) for x in (h, t, r))
    prob = torch.as_tensor(prob, dtype=torch.float32, device=dev)
    B, R = r.shape[0], kg.n_relations
    # expand each prob row [R-1] to R columns (0 at the positive r): column
    # c != r maps to prob[r, c - (c > r)] (the kl_prob.txt layout)
    cols = torch.arange(R, device=dev)[None, :]
    j = cols - (cols > r[:, None]).to(torch.int64)
    w = torch.gather(prob[r], 1, torch.clamp(j, max=R - 2))
    w = torch.where(cols == r[:, None], 0.0, w)

    rels, valid, k = _pair_slice(kg, h, t)
    true_mask = (valid[:, None, :] & (rels[:, None, :] == cols[..., None])).any(dim=-1)
    w = torch.where(true_mask, 0.0, w)

    cdf = torch.cumsum(w, dim=-1)
    total = cdf[:, -1:]
    if u is None:
        u = torch.rand((B, n_neg), generator=generator, device=_draw_dev(generator))
    u = u.to(dev, torch.float32) * total
    sample = torch.clamp((cdf[:, None, :] <= u[:, :, None]).sum(dim=-1), max=R - 1)
    # float rounding can push u to exactly `total`: the clamp then lands on
    # column R-1, which may carry no weight; remap any zero-weight draw to
    # the last relation with weight, which stays in the exact complement
    last_valid = R - 1 - _argmax_first((w > 0.0).flip(-1).to(torch.int8), dim=-1)
    w_at = torch.gather(w, 1, sample)
    sample = torch.where(w_at > 0.0, sample, last_valid[:, None])
    return torch.where((total <= 0.0) | (k >= R)[:, None], r[:, None], sample)
