"""Carry the JAX package's parameters into the port's modules and back.

Inputs are nested dicts of numpy arrays (flax trees), e.g. from
``jax.tree_util.tree_map(np.asarray, params)``. The port's submodules carry
the flax names, so each flax leaf maps to one ``state_dict`` key:

* ``Dense.kernel [in, out]`` → ``Linear.weight [out, in]`` (also SNDense);
* ``nn.Embed.embedding`` → ``Embedding.weight``;
* ``nn.LayerNorm`` ``scale``/``bias`` → ``weight``/``bias``;
* ``LayerNormalization`` ``a_2``/``b_2``, RGCN ``basis``/``comp``/``root``/
  ``bias`` and the M3AE tokens keep their names and layouts;
* the ``"spectral"`` collection (``u``, ``v`` of each SNDense) → buffers.

Both directions copy values exactly, so flax → torch → flax is bitwise.

The KGE toolkit's parameters are a flat dict under the JAX package's keys
(``ent``, ``rel``, ``norm``, ``mat``, ``ent_p``, ``rel_p``, ``ent_re`` /
``ent_im`` / ``rel_re`` / ``rel_im``, ``rel_inv``, ``margin``,
``rel_range``), the same in both packages: ``kge_from_jax`` and
``kge_to_jax`` carry them across, value for value.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mre_tpu_torch.models.spectral_norm import SNDense

_RENAME = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(params: dict, spectral: dict | None = None) -> dict:
    """flax ``params`` (+ ``spectral``) trees → a torch ``state_dict``."""
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            arr = arr.T
        out[".".join(path[:-1] + (_RENAME.get(name, name),))] = torch.from_numpy(
            np.array(arr, order="C"))                  # a copy the tensor may own
    for path, leaf in _flatten(spectral or {}):
        out[".".join(path)] = torch.from_numpy(np.array(leaf, order="C"))
    return out


def load_flax(model: nn.Module, params: dict, spectral: dict | None = None) -> nn.Module:
    """Load flax trees into ``model`` (strict: every key must match)."""
    sd = flax_to_state_dict(params, spectral)
    model.load_state_dict(sd, strict=True)
    return model


def _insert(tree: dict, path: list, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def module_to_flax(model: nn.Module) -> tuple[dict, dict]:
    """A port module → (flax ``params``, flax ``spectral``) numpy trees."""
    modules = dict(model.named_modules())
    params: dict = {}
    spectral: dict = {}
    for key, t in model.state_dict().items():
        mod_path, _, name = key.rpartition(".")
        mod = modules[mod_path]
        arr = t.detach().to("cpu", copy=True).numpy()     # never a view of the module
        path = mod_path.split(".") if mod_path else []
        if isinstance(mod, SNDense) and name in ("u", "v"):
            _insert(spectral, path + [name], arr)
            continue
        if name == "weight":
            if isinstance(mod, nn.Embedding):
                name = "embedding"
            elif isinstance(mod, nn.LayerNorm):
                name = "scale"
            else:
                name, arr = "kernel", np.ascontiguousarray(arr.T)
        _insert(params, path + [name], arr)
    return params, spectral


def kge_from_jax(params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's KGE parameter dict (arrays) → the port's (float32
    tensors on ``device``, copies, under the same keys)."""
    out = {}
    for k, v in params.items():
        arr = np.asarray(v)
        if arr.dtype != np.float32:
            raise TypeError(f"KGE parameter {k!r} is {arr.dtype}, not float32")
        out[k] = torch.tensor(arr, device=device)
    return out


def kge_to_jax(params) -> dict:
    """The port's KGE parameters (a dict of tensors, or a ``models.kge.Params``
    module such as a façade model) → numpy arrays under the same keys."""
    if isinstance(params, nn.Module):
        params = params.tree()
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in params.items()}
