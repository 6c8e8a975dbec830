"""OpenKE-style class surface over the KGE functions (port of
mre_tpu/openke/module.py).

Mirrors the reference toolkit's user-facing classes
(OpenKE/openke/module/model/*.py, strategy/NegativeSampling.py, loss/*.py),
so that an OpenKE training script ports line for line, while the compute
runs through ``models/kge.py`` and ``ops/losses.py``. A model is an
``nn.Module`` whose parameters (and, for RotatE, buffers) carry the JAX
package's key names; ``forward(data)`` takes the flat OpenKE batch
({batch_h, batch_t, batch_r, batch_y, mode}).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mre_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from mre_tpu_torch.models import kge as K
from mre_tpu_torch.ops import losses as L


class Model(K.Params):
    """Base: the parameter dict of one KGE model plus its functions. The
    tables are initialized on the CPU from ``seed``; ``.to(device)`` moves
    them (the Trainer and Tester do)."""

    model_name: str = ""
    _l3_fn = None

    def __init__(self, ent_tot, rel_tot, seed=0, **init_kwargs):
        fn = K.get(self.model_name)
        super().__init__(fn.init(torch.Generator().manual_seed(seed), ent_tot, rel_tot,
                                 **init_kwargs))
        self.ent_tot = ent_tot
        self.rel_tot = rel_tot
        self._fn = fn
        self._score_kwargs = {}
        self._margin = None   # margin_flag semantics: forward = margin − score

    @property
    def params(self) -> dict:
        """name → tensor, the module's own parameters and buffers."""
        return self.tree()

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _indices(self, data):
        """(h, r, t) of a batch dict (arrays or tensors) as int64 tensors on
        the model's device."""
        return tuple((v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
                     .to(self.device, torch.int64)
                     for v in (data["batch_h"], data["batch_r"], data["batch_t"]))

    def train_score(self, params, h, r, t):
        """Training-orientation score with the reference's margin_flag
        behaviour (e.g. TransE.py:40-44, 71-74: forward = margin − distance
        when the model was given a margin)."""
        s = self._fn.score(params, h, r, t, **self._score_kwargs)
        if self._margin is not None:
            s = self._margin - s
        return s

    # -- OpenKE batch-dict interface --------------------------------------

    def forward(self, data):
        return self.train_score(self.params, *self._indices(data))

    def predict(self, data) -> np.ndarray:
        with torch.no_grad():
            out = self._fn.predict(self.params, *self._indices(data), **self._score_kwargs)
        return out.cpu().numpy().astype(np.float32)

    def regularization(self, data):
        return self._fn.regularization(self.params, *self._indices(data))

    def loss_terms(self, params, h, r, t):
        return self._fn.score(params, h, r, t, **self._score_kwargs)

    # -- parameters ---------------------------------------------------------

    def save_checkpoint(self, path):
        save_checkpoint(path, self.params)

    def load_checkpoint(self, path):
        self.set_parameters(load_checkpoint(path, self.get_parameters()))

    def get_parameters(self, mode: str = "numpy"):
        """Parameter dict for cross-model transfer (BaseModule.get_parameters;
        the TransE → TransR pretraining flow of
        OpenKE/examples/train_transr_FB15K237.py)."""
        out = {k: v.detach().cpu().numpy().copy() for k, v in self.params.items()}
        if mode == "list":
            return {k: v.tolist() for k, v in out.items()}
        return out

    def set_parameters(self, parameters):
        """Copy the matching keys (e.g. the 'ent' / 'rel' tables) in."""
        own = self.params
        with torch.no_grad():
            for k, v in parameters.items():
                if k in own:
                    src = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
                    own[k].copy_(src.to(own[k].dtype).reshape(own[k].shape))

    def save_parameters(self, path):
        """The parameters as JSON (keys sorted, values as lists), the JAX
        package's file for the same values."""
        params = self.params
        with open(path, "w") as f:
            json.dump({k: params[k].detach().cpu().numpy().tolist() for k in sorted(params)}, f)

    def load_parameters(self, path):
        with open(path) as f:
            self.set_parameters({k: np.asarray(v, np.float32) for k, v in json.load(f).items()})


class TransE(Model):
    model_name = "transe"

    def __init__(self, ent_tot, rel_tot, dim=100, p_norm=1, norm_flag=True,
                 margin=None, epsilon=None, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim, margin=margin, epsilon=epsilon)
        self._score_kwargs = dict(p_norm=p_norm, norm_flag=norm_flag)
        self._margin = margin


class TransH(Model):
    model_name = "transh"

    def __init__(self, ent_tot, rel_tot, dim=100, p_norm=1, norm_flag=True,
                 margin=None, epsilon=None, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim, margin=margin, epsilon=epsilon)
        self._score_kwargs = dict(p_norm=p_norm, norm_flag=norm_flag)
        self._margin = margin   # margin_flag (TransH.py:44-50)


class TransR(Model):
    model_name = "transr"

    def __init__(self, ent_tot, rel_tot, dim_e=100, dim_r=100, p_norm=1,
                 norm_flag=True, rand_init=False, margin=None, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim_e=dim_e, dim_r=dim_r,
                         rand_init=rand_init)
        self._score_kwargs = dict(p_norm=p_norm, norm_flag=norm_flag)
        self._margin = margin   # margin_flag (TransR.py:33-38); no epsilon branch upstream


class TransD(Model):
    model_name = "transd"

    def __init__(self, ent_tot, rel_tot, dim_e=100, dim_r=100, p_norm=1,
                 norm_flag=True, margin=None, epsilon=None, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim_e=dim_e, dim_r=dim_r,
                         margin=margin, epsilon=epsilon)
        self._score_kwargs = dict(p_norm=p_norm, norm_flag=norm_flag)
        self._margin = margin   # margin_flag (TransD.py:55-60)


class DistMult(Model):
    model_name = "distmult"
    _l3_fn = staticmethod(K.distmult_l3_regularization)

    def __init__(self, ent_tot, rel_tot, dim=100, margin=None, epsilon=None, seed=0):
        # margin / epsilon set ONLY the init range in the reference DistMult
        # (no margin_flag forward branch, DistMult.py:16-32)
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim, margin=margin, epsilon=epsilon)

    def l3_regularization(self):
        return K.distmult_l3_regularization(self.params)


class ComplEx(Model):
    model_name = "complex"

    def __init__(self, ent_tot, rel_tot, dim=100, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim)


class RESCAL(Model):
    model_name = "rescal"

    def __init__(self, ent_tot, rel_tot, dim=100, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim)


class Analogy(Model):
    model_name = "analogy"

    def __init__(self, ent_tot, rel_tot, dim=100, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim)


class SimplE(Model):
    model_name = "simple"

    def __init__(self, ent_tot, rel_tot, dim=100, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim)


class RotatE(Model):
    model_name = "rotate"

    def __init__(self, ent_tot, rel_tot, dim=100, margin=6.0, epsilon=2.0, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim, margin=margin, epsilon=epsilon)


class HolE(Model):
    model_name = "hole"
    _l3_fn = staticmethod(K.hole_l3_regularization)

    def __init__(self, ent_tot, rel_tot, dim=100, margin=None, epsilon=None, seed=0):
        super().__init__(ent_tot, rel_tot, seed=seed, dim=dim, margin=margin, epsilon=epsilon)

    def l3_regularization(self):
        return K.hole_l3_regularization(self.params)


# --------------------------------------------------------------------------
# Losses (class-style wrappers over ops/losses.py)
# --------------------------------------------------------------------------

class MarginLoss:
    def __init__(self, adv_temperature=None, margin=6.0):
        self.margin = margin
        self.adv_temperature = adv_temperature

    def __call__(self, p_score, n_score):
        return L.margin_loss(p_score, n_score, margin=self.margin,
                             adv_temperature=self.adv_temperature)


class SigmoidLoss:
    def __init__(self, adv_temperature=None):
        self.adv_temperature = adv_temperature

    def __call__(self, p_score, n_score):
        return L.sigmoid_loss(p_score, n_score, adv_temperature=self.adv_temperature)


class SoftplusLoss:
    def __init__(self, adv_temperature=None):
        self.adv_temperature = adv_temperature

    def __call__(self, p_score, n_score):
        return L.softplus_loss(p_score, n_score, adv_temperature=self.adv_temperature)


class NegativeSampling:
    """Strategy wrapper: the first ``batch_size`` scores are positives, the
    rest negatives (OpenKE strategy/NegativeSampling.py:3-32 layout)."""

    def __init__(self, model=None, loss=None, batch_size=256,
                 regul_rate=0.0, l3_regul_rate=0.0):
        self.model = model
        self.loss = loss
        self.batch_size = batch_size
        self.regul_rate = regul_rate
        self.l3_regul_rate = l3_regul_rate

    def _split(self, score):
        B = self.batch_size
        return score[:B].reshape(-1, B).T, score[B:].reshape(-1, B).T

    def loss_value(self, params, data):
        """The loss of one flat batch; ``data`` holds int64 tensors (or
        arrays) on the model's device."""
        h, r, t = self.model._indices(data)
        p, n = self._split(self.model.train_score(params, h, r, t))
        value = self.loss(p, n)
        if self.regul_rate:
            value = value + self.regul_rate * self.model._fn.regularization(params, h, r, t)
        if self.l3_regul_rate and self.model._l3_fn is not None:
            # the model declares its own L3 regularizer
            value = value + self.l3_regul_rate * self.model._l3_fn(params)
        return value

    def __call__(self, data):
        return self.loss_value(self.model.params, data)
