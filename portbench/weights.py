"""Weights and other seeded draws the benchmark makes itself and hands to
both the program and the reference.

All of a module's tensors come from one ``torch.Generator`` on the run's
device, seeded from ``--seed``, in one ``randn`` call over their total
size, then scaled per tensor: matrices N(0, 1/fan_in), the text embedding
N(0, 1), learned tokens N(0, 0.02²), biases N(0, 0.02²), LayerNorm scales
1 + N(0, 0.05²). Of a spectral norm's vectors, ``u`` is a unit random
vector and ``v`` = l2(Wᵀu), the pair that the program's initialisation
and every power step leave: with ``v`` drawn apart from ``u``, σ = uᵀWv
would be a sum that cancels to near 0 on some seeds and scales the layer's
output and its round-off by a thousand or more. The program
receives them through ``load_state_dict``; the reference reads the same
dict, which the program's training does not touch.
"""

from __future__ import annotations

import torch


def _scale(name: str, shape: tuple) -> tuple[float, float]:
    """(offset, scale) of the unit normal draw for one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("u", "v"):
        return 0.0, 1.0
    if "LayerNorm" in name and leaf == "weight" or leaf == "a_2":
        return 1.0, 0.05
    if leaf in ("bias", "b_2") or name.endswith("_token") or name.endswith("_embedding"):
        return 0.0, 0.02
    if name.endswith("text_embedding.weight"):
        return 0.0, 1.0
    if leaf == "comp":
        return 0.0, shape[1] ** -0.5
    if leaf in ("basis", "root"):
        return 0.0, shape[-2] ** -0.5
    return 0.0, shape[-1] ** -0.5


def draw(shapes: dict, gen: torch.Generator, device) -> dict:
    """{name: shape} → {name: float32 tensor on ``device``}."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        x = flat[off:off + n].view(shape)
        off += n
        if name.rsplit(".", 1)[-1] in ("u", "v"):
            x = x / torch.linalg.norm(x)
        else:
            base, scale = _scale(name, tuple(shape))
            x = x * scale + base
        out[name] = x
    for name in [n for n in out if n.endswith(".v")]:
        base = name[:-len(".v")]
        if f"{base}.u" in out and f"{base}.weight" in out:
            v = out[f"{base}.weight"].T @ out[f"{base}.u"]
            out[name] = v / torch.linalg.norm(v)
    return out


def for_module(module: torch.nn.Module, gen: torch.Generator, device) -> dict:
    """Draws for every entry of ``module.state_dict()``, loaded into it."""
    params = draw({k: tuple(v.shape) for k, v in module.state_dict().items()}, gen, device)
    module.load_state_dict(params)
    return params


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The run's generator of one draw stream (weights 0, inputs 1, ...)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % (2 ** 63))
