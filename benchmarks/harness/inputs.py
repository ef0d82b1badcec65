"""Weights and token batches, made on the device from `--seed`.

Weights are in the port's layout (`embed`, `unembed`, `layers.{wq,wk,wv,
wo}` and `layers.{w1,w2}` or, for MoE, `layers.{wr,w1e,w2e}`, stacked on
the layer dim), f32, N(0, 1) * d_model ** -0.5. Each leaf comes from its
own generator, seeded from the run's seed and the leaf's name, in one
call: any leaf can be made again alone, which is how the reference and
the check of the parameters' change get the initial weights.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch


def subseed(seed: int, label: str) -> int:
    """A 63-bit seed for one named stream of the run `seed` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        subseed(seed, label))


def leaf_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Dotted leaf name -> shape, in the port's layout."""
    v, d, ff = model["vocab"], model["d_model"], model["d_ff"]
    n, e = model["n_layers"], model.get("n_experts", 0)
    shapes = {"embed": (v, d), "unembed": (d, v),
              "layers.wq": (n, d, d), "layers.wk": (n, d, d),
              "layers.wv": (n, d, d), "layers.wo": (n, d, d)}
    if e:
        shapes.update({"layers.wr": (n, d, e), "layers.w1e": (n, e, d, ff),
                       "layers.w2e": (n, e, ff, d)})
    else:
        shapes.update({"layers.w1": (n, d, ff), "layers.w2": (n, ff, d)})
    return shapes


def make_leaf(model: dict, name: str, seed: int, device) -> torch.Tensor:
    shape = leaf_shapes(model)[name]
    leaf = torch.randn(shape, generator=generator(seed, "weights:" + name,
                                                  device),
                       dtype=torch.float32, device=device)
    return leaf.mul_(model["d_model"] ** -0.5)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"layers.wq": t, "embed": e} -> {"layers": {"wq": t}, "embed": e}."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(flatten(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def make_params(model: dict, seed: int, device) -> dict:
    """The whole parameter tree, nested as the port takes it."""
    return nest({name: make_leaf(model, name, seed, device)
                 for name in leaf_shapes(model)})
