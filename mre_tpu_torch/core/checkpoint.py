"""Checkpointing: flax-named parameter trees on disk (port of
mre_tpu/core/checkpoint.py).

A checkpoint holds the plain parameter tree: nested dicts whose leaves are
arrays, named and laid out as flax names them (``interop.module_to_flax``:
a Dense ``kernel`` is [in, out]). Spectral-norm power-iteration vectors are
not interleaved with the parameters: a caller that keeps them saves them as
a separate subtree (the Discriminator's ``{"params", "spectral"}``).

Format: ``torch.save`` of the tree with CPU tensor leaves, plus a JSON
sidecar ``path + ".meta.json"`` that gives ``[shape, dtype]`` per leaf in the
same nesting, with numpy dtype names: the sidecar of a port checkpoint is
the JAX package's sidecar of the same tree, byte for byte. Under a process
mesh rank 0 writes and the other ranks wait at a barrier.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mre_tpu_torch.parallel import mesh as pmesh


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_checkpoint(path: str, tree: dict, mesh=None) -> None:
    """Write ``tree`` (leaves: tensors or arrays) and its sidecar, each under
    a temporary name and then renamed into place. Under a mesh
    (``parallel.mesh.Mesh``; every rank holds the same tree) rank 0 writes
    and every rank waits for it at a barrier, so each may load it next."""
    if mesh is None or mesh.rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tree = _to_numpy(tree)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_map(lambda a: torch.from_numpy(np.array(a, order="C")), tree), tmp)
        os.replace(tmp, path)
        meta = _map(lambda a: [list(a.shape), str(a.dtype)], tree)
        with open(tmp, "w") as f:
            # key order of a flattened flax tree: sorted at every level
            json.dump(meta, f, sort_keys=True)
        os.replace(tmp, path + ".meta.json")
    if mesh is not None:
        pmesh.barrier()


def _check_structure(loaded, target, where: str = "") -> None:
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"checkpoint structure differs at '{where}': "
                             f"{got} vs the target's {sorted(target)}")
        for k in target:
            _check_structure(loaded[k], target[k], f"{where}/{k}")
        return
    if isinstance(loaded, dict):
        raise ValueError(f"checkpoint has a subtree where the target has a leaf: '{where}'")
    if tuple(loaded.shape) != tuple(np.shape(target)):
        raise ValueError(f"checkpoint leaf '{where}' has shape {tuple(loaded.shape)}, "
                         f"the target {tuple(np.shape(target))}")


def load_checkpoint(path: str, target: dict) -> dict:
    """The tree at ``path`` (CPU tensor leaves), checked strictly against the
    structure and leaf shapes of ``target`` (a template tree)."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    _check_structure(tree, target)
    return tree


def latest_checkpoint(directory: str, prefix: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and not name.endswith(".meta.json"):
            # only the LEADING digit run after the prefix: digits in a
            # model-name suffix (epoch2_v2.ckpt) must not join the step
            rest = name[len(prefix):]
            i = 0
            while i < len(rest) and rest[i].isdigit():
                i += 1
            step = int(rest[:i]) if i else 0
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best
