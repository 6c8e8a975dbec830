"""DistillModel — relation description → relation embedding (port of
mre_tpu/models/distill.py).

The reference's small distillation MLP (module/DistillModel.py:7-62):
frozen learned text embeddings + sin-cos positions (+ the text type
embedding) → fc1 (emb → 2·dim) → LeakyReLU(0.01) → fc2 (2·dim → dim) →
std-LayerNorm → mean over tokens → fc3 (dim → dim); trained with MSE
against the teacher relation embeddings. Submodule names are the flax ones
(fc1, fc2, layer_norm, fc3), so ``interop`` carries the weights both ways.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import Dense, init_weights
from mre_tpu_torch.models.transformer import LayerNormalization
from mre_tpu_torch.ops.pos_embed import get_1d_sincos_pos_embed


class DistillModel(nn.Module):
    def __init__(self, emb_dim: int, transformer_emb_dim: int):
        super().__init__()
        self.transformer_emb_dim = transformer_emb_dim
        self.fc1 = Dense(transformer_emb_dim, 2 * emb_dim)
        self.fc2 = Dense(2 * emb_dim, emb_dim)
        self.layer_norm = LayerNormalization(emb_dim)
        self.fc3 = Dense(emb_dim, emb_dim)

    def forward(self, rel_token_embeddings):
        """rel_token_embeddings [B, L, transformer_emb_dim]: the frozen text
        embedding lookup with the type embedding added; positions are added
        here."""
        pos = torch.from_numpy(get_1d_sincos_pos_embed(
            self.transformer_emb_dim, rel_token_embeddings.shape[1]))
        x = rel_token_embeddings + pos.to(rel_token_embeddings.device)
        x = F.leaky_relu(self.fc1(x), negative_slope=0.01)
        x = self.layer_norm(self.fc2(x))
        return self.fc3(x.mean(dim=-2))


def embed_tokens(m3ae: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Frozen text embedding + text type embedding of an M3AE
    (module/DistillModel.py:27-32); the type embedding counts as 0 when the
    M3AE has none."""
    with torch.no_grad():
        type_emb = getattr(m3ae, "encoder_text_type_embedding", None)
        out = m3ae.text_embedding(tokens.long())
        return out if type_emb is None else out + type_emb


def make_distill_trainer(emb_dim: int, transformer_emb_dim: int, lr: float = 1e-4,
                         seed: int = 0, device: str | torch.device = "cpu"):
    """(model, step, predict): the model drawn from ``seed`` on ``device``;
    ``step(token_embs, teacher)`` takes one adam step on the MSE and returns
    the loss as a 0-d device tensor; ``predict(token_embs)`` runs the model
    without a graph."""
    model = init_weights(DistillModel(emb_dim, transformer_emb_dim), seed).to(device)
    # optax.adam's defaults
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(token_embs, teacher):
        loss = ((model(token_embs) - teacher) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def predict(token_embs):
        return model(token_embs)

    return model, step, predict
