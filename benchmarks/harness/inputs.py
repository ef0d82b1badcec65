"""Weights and token batches, made on the device from `--seed`.

Weights are the leaves that the configuration's definition names
(`leaf_shapes`; block.py for the port's block), f32, N(0, 1) times the
definition's `leaf_scale`. Each leaf comes from its own generator, seeded
from the run's seed and the leaf's name, in one call: any leaf can be
made again alone, which is how the reference and the check of the
parameters' change get the initial weights.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch


def subseed(seed: int, label: str) -> int:
    """A 63-bit seed for one named stream of the run `seed` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        subseed(seed, label))


def make_leaf(definition, model: dict, name: str, seed: int,
              device) -> torch.Tensor:
    shape = definition.leaf_shapes(model)[name]
    leaf = torch.randn(shape, generator=generator(seed, "weights:" + name,
                                                  device),
                       dtype=torch.float32, device=device)
    return leaf.mul_(definition.leaf_scale(model, name))


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


def make_params(definition, model: dict, seed: int, device) -> dict:
    """The whole parameter tree, nested as the port takes it."""
    return nest({name: make_leaf(definition, model, name, seed, device)
                 for name in definition.leaf_shapes(model)})
