"""Ranking, reconstruction and contrastive losses (port of
mre_tpu/ops/losses.py).

* margin / sigmoid / softplus ranking losses of the KGE toolkit, each with
  optional self-adversarial negative weights (reference: module/loss.py:5-53
  and OpenKE/openke/module/loss/*.py); ``p_score`` is [B, 1] (or [B]) and
  ``n_score`` [B, n_neg];
* masked patch MSE and masked token cross-entropy + accuracy for the M3AE
  reconstruction objective (reference: module/model.py:164-195);
* bidirectional InfoNCE between mean image / text tokens, temperature 0.05
  (reference: module/model.py:578-597).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def margin_loss(p_score, n_score, margin: float = 6.0, adv_temperature=None):
    p = p_score.reshape(p_score.shape[0], -1)
    n = n_score.reshape(n_score.shape[0], -1)
    diff = torch.clamp(p - n, min=-margin)
    if adv_temperature is not None:
        w = torch.softmax(-n * adv_temperature, dim=-1).detach()
        return (w * diff).sum(dim=-1).mean() + margin
    return diff.mean() + margin


def sigmoid_loss(p_score, n_score, adv_temperature=None):
    p = p_score.reshape(p_score.shape[0], -1)
    n = n_score.reshape(n_score.shape[0], -1)
    pos = F.logsigmoid(p).mean()
    if adv_temperature is not None:
        w = torch.softmax(n * adv_temperature, dim=-1).detach()
        neg = (w * F.logsigmoid(-n)).sum(dim=-1).mean()
    else:
        neg = F.logsigmoid(-n).mean()
    return -(pos + neg) / 2


def softplus_loss(p_score, n_score, adv_temperature=None):
    p = p_score.reshape(p_score.shape[0], -1)
    n = n_score.reshape(n_score.shape[0], -1)
    pos = F.softplus(-p).mean()
    if adv_temperature is not None:
        w = torch.softmax(n * adv_temperature, dim=-1).detach()
        neg = (w * F.softplus(n)).sum(dim=-1).mean()
    else:
        neg = F.softplus(n).mean()
    return (pos + neg) / 2


LOSSES = {"margin": margin_loss, "sigmoid": sigmoid_loss, "softplus": softplus_loss}


def patch_mse_loss(patch_output, patch_target, valid=None):
    """Mean per-patch MSE over valid (masked) patches; ``valid`` [B, L] is
    1.0 where a patch counts (the reference passes the masking mask)."""
    if valid is None:
        valid = torch.ones(patch_target.shape[:2], dtype=patch_output.dtype,
                           device=patch_output.device)
    valid_ratio = valid.sum(dim=-1) / valid.shape[-1]
    per_patch = ((patch_target - patch_output) ** 2).mean(dim=-1)
    per_ex = (torch.where(valid > 0.0, per_patch, torch.zeros_like(per_patch)).mean(dim=-1)
              / torch.clamp(valid_ratio, min=1e-5))
    return per_ex.mean()


def cross_entropy_loss_and_accuracy(logits, tokens, valid=None):
    """Per-example length-normalized token CE + accuracy
    (reference: module/model.py:164-179). ``argmax`` takes the first of
    tied logits, as ``jnp.argmax`` does."""
    if valid is None:
        valid = torch.ones(tokens.shape[:2], dtype=torch.float32, device=logits.device)
    valid_len = torch.clamp(valid.sum(dim=-1), min=1e-5)
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
    token_logp = torch.where(valid > 0.0, token_logp, torch.zeros_like(token_logp))
    loss = -(token_logp.sum(dim=-1) / valid_len).mean()
    correct = (valid > 0.0) & (_argmax_first(logits) == tokens.long())
    accuracy = (correct.sum(dim=-1) / valid_len).mean()
    return loss, accuracy


def _argmax_first(x, dim: int = -1):
    """Index of the first maximum along ``dim`` (``torch.argmax`` does not
    promise which tied index it returns)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    at_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(at_max, idx, n).amin(dim=dim)


def mask_intersection(mask1, mask2):
    return ((mask1 > 0) & (mask2 > 0)).to(torch.float32)


def mask_not(mask):
    return 1.0 - mask


def contrastive_loss(image_rep, text_rep, bidirect: bool = True,
                     temperature: float = 0.05, row_mask=None):
    """Bidirectional InfoNCE over normalized mean-token reps (diagonal of
    log_softmax over axis 0). ``row_mask`` [N] drops padded batch rows from
    both softmax directions (their logits become −1e9, not −inf) and from
    the mean."""
    a = image_rep / torch.clamp(torch.linalg.norm(image_rep, dim=-1, keepdim=True), min=1e-12)
    b = text_rep / torch.clamp(torch.linalg.norm(text_rep, dim=-1, keepdim=True), min=1e-12)
    total = (a @ b.T) / temperature
    labels = torch.arange(total.shape[0], device=total.device)

    if row_mask is None:
        def _nce(m):
            return -torch.diagonal(torch.log_softmax(m, dim=0)).mean()

        def _acc(m):
            return (_argmax_first(m, 0) == labels).to(torch.float32).mean()
    else:
        valid = row_mask.to(torch.bool)
        w = valid.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        total = torch.where(valid[:, None] & valid[None, :], total,
                            torch.full_like(total, -1e9))

        def _nce(m):
            return -(torch.diagonal(torch.log_softmax(m, dim=0)) * w).sum() / denom

        def _acc(m):
            return ((_argmax_first(m, 0) == labels).to(torch.float32) * w).sum() / denom

    if not bidirect:
        return _nce(total), _acc(total)
    return (_nce(total) + _nce(total.T)) / 2, (_acc(total) + _acc(total.T)) / 2
