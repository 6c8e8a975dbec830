"""Knowledge-graph triple tables (port of mre_tpu/data/kg.py).

* ``TripleTable`` — host-side deduplicated triple store with dense sorted
  key arrays (OpenKE base/Reader.h:52-160), a numpy copy. The serving path
  reads its deduplicated triple order: the full-graph RGCN sweep takes its
  edges from ``TripleTable.triples``, so the order here must be the JAX
  package's.
* ``DeviceKG`` — the device mirror of the filter indexes that negative
  sampling reads (kg.py:194-337): int32 tensors on the trainer's device,
  widened to int64 only where torch indexes with them. Dense [E·R+1] row
  offsets, or the row-compacted layout past ``COMPACT_ROW_THRESHOLD`` rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _pack(a: np.ndarray, b: np.ndarray, c: np.ndarray, nb: int, nc: int) -> np.ndarray:
    """Pack three small non-negative int arrays into one sortable int64 key."""
    return (a.astype(np.int64) * nb + b.astype(np.int64)) * nc + c.astype(np.int64)


# Static pad width for tier-1 exact complement sampling; rows with more true
# candidates resolve against the dense "big row" matrices below.
EXACT_PAD = 128


def _build_big_rows(offsets: np.ndarray, values: np.ndarray, pad: int):
    """Dense [n_big, pad_big] matrix of (s_i − i) for CSR rows longer than
    ``pad``, plus a row→slot index (−1 elsewhere). Tiny for real KGs
    (hundreds of rows), and it makes overflow corruption one masked compare."""
    sizes = np.diff(offsets)
    big_rows = np.nonzero(sizes > pad)[0]
    n_big = len(big_rows)
    pad_big = int(((sizes.max() + 127) // 128) * 128) if n_big else pad
    big_index = np.full(len(offsets) - 1, -1, np.int32)
    big_d = np.full((max(n_big, 1), pad_big), np.iinfo(np.int32).max // 2, np.int32)
    for slot, row in enumerate(big_rows):
        big_index[row] = slot
        vals = values[offsets[row]:offsets[row + 1]].astype(np.int64)
        big_d[slot, :len(vals)] = (vals - np.arange(len(vals))).astype(np.int32)
    return big_index, big_d


@dataclasses.dataclass(frozen=True)
class TripleTable:
    """Deduplicated triple store with sorted indexes (host, numpy)."""

    n_entities: int
    n_relations: int
    triples: np.ndarray          # [T, 3] int32 rows (h, r, t), deduped
    hrt_keys: np.ndarray         # [T] int64, sorted pack(h, r, t)
    trh_keys: np.ndarray         # [T] int64, sorted pack(t, r, h)
    hr_offsets: np.ndarray       # [E*R + 1] int32 CSR row offsets into hrt order
    tr_offsets: np.ndarray       # [E*R + 1] int32 CSR row offsets into trh order
    hrt_tails: np.ndarray        # [T] int32 tails in hrt-sorted order
    trh_heads: np.ndarray        # [T] int32 heads in trh-sorted order
    left_mean: np.ndarray        # [R] float32 avg #triples per distinct head (bern)
    right_mean: np.ndarray       # [R] float32 avg #triples per distinct tail (bern)
    hr_big_index: np.ndarray     # [E*R] int32 → slot in hr_big_d, −1 if small
    hr_big_d: np.ndarray         # [n_big, pad_big] int32 (tails − rank)
    tr_big_index: np.ndarray
    tr_big_d: np.ndarray
    pair_keys: np.ndarray        # [T] int64, sorted pack(h, t) (rels grouped)
    pair_rels: np.ndarray        # [T] int32 relations in (h, t, r)-sorted order
    pair_pad: int                # max #relations per (h, t) pair
    # Fraction of triples living in CSR rows longer than EXACT_PAD — used to
    # size the tier-2 overflow compaction so exactness loss is never silent.
    hr_overflow_frac: float
    tr_overflow_frac: float

    @classmethod
    def build(cls, triples: np.ndarray, n_entities: int, n_relations: int) -> "TripleTable":
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
        E, R = int(n_entities), int(n_relations)
        # Device-side row ids are int32: (entity, relation) row space must fit.
        if E * R >= 2**31:
            raise ValueError(f"entity×relation id space {E}×{R} exceeds int32")

        hrt = _pack(h, r, t, R, E)
        order = np.argsort(hrt, kind="stable")
        hrt = hrt[order]
        keep = np.ones(len(hrt), dtype=bool)
        keep[1:] = hrt[1:] != hrt[:-1]
        triples = triples[order][keep]
        hrt = hrt[keep]
        h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]

        trh = _pack(t, r, h, R, E)
        trh_order = np.argsort(trh, kind="stable")
        trh_sorted = trh[trh_order]

        # CSR row offsets over the combined (entity, relation) id space.
        # Dense [E·R+1] offsets are the right trade at benchmark scale
        # (FB15K237: 2×3.4M int32 ≈ 28 MB device-side) but grow as E·R —
        # ~100× the triple count for the KGs in scope. Host-side they stay
        # dense (cheap, and the prep-time reductions want them); the device
        # mirror switches to the row-compacted layout past
        # COMPACT_ROW_THRESHOLD (DeviceKG.from_table / _compact_rows),
        # trading one batched binary search per row lookup.
        hr_ids = h.astype(np.int64) * R + r
        tr_ids = t[trh_order].astype(np.int64) * R + r[trh_order]
        hr_offsets = np.zeros(E * R + 1, dtype=np.int64)
        np.add.at(hr_offsets, hr_ids + 1, 1)
        hr_offsets = np.cumsum(hr_offsets)
        tr_offsets = np.zeros(E * R + 1, dtype=np.int64)
        np.add.at(tr_offsets, tr_ids + 1, 1)
        tr_offsets = np.cumsum(tr_offsets)

        # Bernoulli corruption statistics (OpenKE base/Reader.h:141-158):
        # left_mean[r]  = (#triples of r) / (#distinct heads of r)
        # right_mean[r] = (#triples of r) / (#distinct tails of r)
        freq = np.bincount(r, minlength=R).astype(np.float64)
        hr_unique = np.unique(np.stack([r, h], 1), axis=0)
        tr_unique = np.unique(np.stack([r, t], 1), axis=0)
        n_heads = np.bincount(hr_unique[:, 0], minlength=R).astype(np.float64)
        n_tails = np.bincount(tr_unique[:, 0], minlength=R).astype(np.float64)
        left_mean = np.where(n_heads > 0, freq / np.maximum(n_heads, 1), 0.0)
        right_mean = np.where(n_tails > 0, freq / np.maximum(n_tails, 1), 0.0)

        hrt_tails = t.astype(np.int32)
        trh_heads = h[trh_order].astype(np.int32)
        hr_big_index, hr_big_d = _build_big_rows(hr_offsets, hrt_tails, EXACT_PAD)
        tr_big_index, tr_big_d = _build_big_rows(tr_offsets, trh_heads, EXACT_PAD)

        def overflow_frac(offsets):
            sizes = np.diff(offsets)
            big = sizes[sizes > EXACT_PAD]
            return float(big.sum() / max(len(triples), 1))

        # by-(h, t) relation index for filtered relation corruption
        # (base/Corrupt.h:86-163: true relations of a pair are a sorted
        # sub-range of the htr-sorted list).
        htr = _pack(h, t, r, E, R)
        htr_order = np.argsort(htr, kind="stable")
        pair_keys = (h.astype(np.int64) * E + t.astype(np.int64))[htr_order]
        pair_rels = r[htr_order].astype(np.int32)
        _, pair_counts = np.unique(pair_keys, return_counts=True)
        pair_pad = int(pair_counts.max()) if len(pair_counts) else 1
        return cls(
            n_entities=E,
            n_relations=R,
            triples=triples,
            hrt_keys=hrt,
            trh_keys=trh_sorted,
            hr_offsets=hr_offsets.astype(np.int64),
            tr_offsets=tr_offsets.astype(np.int64),
            hrt_tails=hrt_tails,
            trh_heads=trh_heads,
            left_mean=left_mean.astype(np.float32),
            right_mean=right_mean.astype(np.float32),
            hr_big_index=hr_big_index,
            hr_big_d=hr_big_d,
            tr_big_index=tr_big_index,
            tr_big_d=tr_big_d,
            pair_keys=pair_keys,
            pair_rels=pair_rels,
            pair_pad=pair_pad,
            hr_overflow_frac=overflow_frac(hr_offsets),
            tr_overflow_frac=overflow_frac(tr_offsets),
        )

    # --- host-side queries (used by tests and CPU fallbacks) -------------

    def contains(self, h, r, t) -> np.ndarray:
        keys = _pack(np.asarray(h), np.asarray(r), np.asarray(t), self.n_relations, self.n_entities)
        if len(self.hrt_keys) == 0:   # zero-triple table: nothing is true
            return np.zeros(keys.shape, bool)
        idx = np.searchsorted(self.hrt_keys, keys)
        idx = np.minimum(idx, len(self.hrt_keys) - 1)
        return self.hrt_keys[idx] == keys

    def true_tails(self, h: int, r: int) -> np.ndarray:
        row = int(h) * self.n_relations + int(r)
        return self.hrt_tails[self.hr_offsets[row]:self.hr_offsets[row + 1]]

    def true_heads(self, t: int, r: int) -> np.ndarray:
        row = int(t) * self.n_relations + int(r)
        return self.trh_heads[self.tr_offsets[row]:self.tr_offsets[row + 1]]

    @property
    def n_triples(self) -> int:
        return len(self.triples)


# HBM budget above which the dense [E·R+1] device offset arrays give way to
# the row-compacted layout (≈ 2 arrays × 4 B × rows = 256 MB at this count).
COMPACT_ROW_THRESHOLD = 32 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DeviceKG:
    """Device mirror of the filter indexes (int32 / float32 tensors).

    Membership tests use per-(entity, relation)-row lookups, so no packed
    64-bit keys live on the device. In compact mode ``hr_offsets`` and
    ``hr_big_index`` are indexed by the position of a row among the present
    rows (``hr_row_keys``), not by the dense row id e·R + r.
    """

    n_entities: int
    n_relations: int
    triples: torch.Tensor
    hr_offsets: torch.Tensor
    tr_offsets: torch.Tensor
    hrt_tails: torch.Tensor
    trh_heads: torch.Tensor
    left_mean: torch.Tensor
    right_mean: torch.Tensor
    hr_big_index: torch.Tensor
    hr_big_d: torch.Tensor
    tr_big_index: torch.Tensor
    tr_big_d: torch.Tensor
    pair_keys: torch.Tensor | None    # int32 pack(h, t); None when E² ≥ 2³¹
    pair_rels: torch.Tensor | None
    hr_row_keys: torch.Tensor | None = None
    tr_row_keys: torch.Tensor | None = None
    pair_pad: int = 1
    hr_overflow_frac: float = 0.0
    tr_overflow_frac: float = 0.0

    @classmethod
    def from_table(cls, t: TripleTable, device: str | torch.device = "cpu",
                   compact: bool | None = None) -> "DeviceKG":
        def put(a, dtype=torch.int32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        pair_ok = t.n_entities * t.n_entities < 2**31
        if compact is None:
            compact = t.n_entities * t.n_relations > COMPACT_ROW_THRESHOLD
        if compact:
            hr_keys, hr_off, hr_big_idx = _compact_rows(t.hr_offsets, t.hr_big_index)
            tr_keys, tr_off, tr_big_idx = _compact_rows(t.tr_offsets, t.tr_big_index)
            hr_row_keys, tr_row_keys = put(hr_keys), put(tr_keys)
        else:
            hr_off, hr_big_idx = t.hr_offsets, t.hr_big_index
            tr_off, tr_big_idx = t.tr_offsets, t.tr_big_index
            hr_row_keys = tr_row_keys = None
        return cls(
            n_entities=t.n_entities,
            n_relations=t.n_relations,
            triples=put(t.triples),
            hr_offsets=put(hr_off),
            tr_offsets=put(tr_off),
            hrt_tails=put(t.hrt_tails),
            trh_heads=put(t.trh_heads),
            left_mean=put(t.left_mean, torch.float32),
            right_mean=put(t.right_mean, torch.float32),
            hr_big_index=put(hr_big_idx),
            hr_big_d=put(t.hr_big_d),
            tr_big_index=put(tr_big_idx),
            tr_big_d=put(t.tr_big_d),
            pair_keys=put(t.pair_keys) if pair_ok else None,
            pair_rels=put(t.pair_rels) if pair_ok else None,
            hr_row_keys=hr_row_keys,
            tr_row_keys=tr_row_keys,
            pair_pad=t.pair_pad,
            hr_overflow_frac=t.hr_overflow_frac,
            tr_overflow_frac=t.tr_overflow_frac,
        )

    def hr_range(self, rows: torch.Tensor):
        """(start, cnt, row_idx) of the (h·R + r) CSR rows, [B] each, int64.

        ``row_idx`` indexes ``hr_big_index`` (dense row id, or compact
        position). Rows absent from a compact index resolve to cnt = 0."""
        return _row_range(self.hr_offsets, self.hr_row_keys, rows)

    def tr_range(self, rows: torch.Tensor):
        return _row_range(self.tr_offsets, self.tr_row_keys, rows)

    def max_row_len(self) -> int:
        """Longest true-candidate row across both orientations (host int)."""

        def longest(offsets):
            d = torch.diff(offsets)
            return int(d.max()) if d.shape[0] else 0

        return max(longest(self.hr_offsets), longest(self.tr_offsets), 1)


def _compact_rows(offsets: np.ndarray, big_index: np.ndarray):
    """Compact a dense CSR over the (e, r) row space to present rows only:
    sorted int32 row keys, [U+1] offsets, and the big-row index re-based to
    compact positions."""
    sizes = np.diff(offsets)
    keys = np.nonzero(sizes > 0)[0]
    comp = np.concatenate([offsets[keys], offsets[-1:]])
    return (keys.astype(np.int32), comp.astype(np.int64),
            big_index[keys].astype(np.int32))


def _row_range(offsets: torch.Tensor, row_keys: torch.Tensor | None,
               rows: torch.Tensor):
    """Vectorized CSR row lookup: a dense gather, or one batched binary
    search over the present-row keys in compact mode (absent rows → cnt 0)."""
    rows = rows.to(torch.int64)
    if row_keys is None:
        start = offsets[rows].to(torch.int64)
        return start, offsets[rows + 1].to(torch.int64) - start, rows
    if row_keys.shape[0] == 0:        # degenerate zero-triple KG
        zero = torch.zeros_like(rows)
        return zero, zero, zero
    idx = torch.clamp(torch.searchsorted(row_keys, rows.to(row_keys.dtype)),
                      0, row_keys.shape[0] - 1)
    found = row_keys[idx] == rows
    start = offsets[idx].to(torch.int64)
    cnt = torch.where(found, offsets[idx + 1].to(torch.int64) - start, 0)
    return torch.where(found, start, 0), cnt, idx
