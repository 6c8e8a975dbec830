"""Candidate-list ranking (port of mre_tpu/ops/ranking.py:246-259).

The reference's structural evaluator (main.py:217-272) ranks candidate 0 of
each padded list. The link-prediction rankers of ``ops/ranking.py`` belong
to the KGE toolkit and come with it (ROADMAP.md §1 item 5).
"""

from __future__ import annotations

import torch


def candidate_ranks(scores: torch.Tensor, cand_mask: torch.Tensor,
                    lower_is_better: bool = True) -> torch.Tensor:
    """Tie-aware ranks of candidate 0 within each padded candidate list.

    ``scores`` [Q, C] with the true candidate at column 0; ``cand_mask``
    [Q, C] marks real candidates. rank = #better + #ties//2 + 1 over
    candidates 1.. (reference: main.py:247-250)."""
    s = scores if lower_is_better else -scores
    true_s = s[:, :1]
    rest = cand_mask.to(torch.bool).clone()
    rest[:, 0] = False
    better = ((s < true_s) & rest).sum(dim=1)
    ties = ((s == true_s) & rest).sum(dim=1)
    return better + ties // 2 + 1
