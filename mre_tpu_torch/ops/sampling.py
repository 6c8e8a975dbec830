"""Filtered negative sampling on the device, fusion-trainer part
(port of mre_tpu/ops/sampling.py:43-89, 335-380).

* ``_contains`` — vectorized membership test over the full deduplicated
  triple set (the base/Corrupt.h:166-177 ``_find``, batched): one padded
  gather of each (h, r) true-tail slice and an equality compare; rows
  longer than the pad resolve against the dense big-row matrix after a
  top-k compaction of the overflowing draws.
* ``corrupt_within_nodes`` — subgraph-local corruption with rejection
  rounds (module/NegativeSampling.py:321-375).

The random parts are inputs or come from a caller's ``torch.Generator``,
never from a global stream, so a test can feed the JAX draws in. The
corruption tiers of the KGE toolkit (``corrupt_batch`` and the rest) come
with that toolkit.
"""

from __future__ import annotations

import torch

from mre_tpu_torch.data.kg import EXACT_PAD as KG_EXACT_PAD
from mre_tpu_torch.data.kg import DeviceKG

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
    draw_dev = generator.device if generator is not None else "cpu"
    if side is None:
        side = torch.rand((B, n_neg), generator=generator, device=draw_dev) < 0.5
    if cand_local is None:
        cand_local = torch.randint(0, n_id.shape[0], (rounds, B, n_neg),
                                   generator=generator, device=draw_dev)
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
