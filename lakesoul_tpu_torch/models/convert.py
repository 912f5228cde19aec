"""Weights carried between the JAX package's param trees and the port's
models, both ways and bit for bit.

The JAX package keeps each model's params as a pytree: MLP a list of
``{"w", "b"}``; ResNet ``{"stem", "stages", "head"}`` with HWIO conv
weights; BERT ``{"tok_emb", ..., "layers"}`` with every layer leaf stacked
on a leading [L] axis.  The port's modules mirror those trees, so a
state_dict key is the tree path joined by dots (``stages.1.0.conv2``); what
differs is the layout: conv weights are OIHW here, and BERT's layers are
``layers.{i}`` modules.  Leaves travel as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models.bert import Bert
from lakesoul_tpu_torch.models.mlp import MLP
from lakesoul_tpu_torch.models.resnet import ResNet

HWIO_TO_OIHW, OIHW_TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)


def _flatten(tree, prefix: str = "") -> dict:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict):
    """Dotted keys → nested dicts, a dict whose keys are 0..n-1 a list."""
    root: dict = {}
    for key, v in flat.items():
        *path, last = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def from_reference_params(tree) -> dict[str, torch.Tensor]:
    """The JAX package's param tree (numpy or jax leaves) → the state_dict
    of the port's model of the same kind, on the CPU (``load_state_dict``
    copies it to the model's device)."""
    if isinstance(tree, (list, tuple)):  # MLP
        flat = _flatten(tree, "layers.")
    elif "stem" in tree:  # ResNet
        flat = {k: v.transpose(HWIO_TO_OIHW) if v.ndim == 4 else v
                for k, v in _flatten(tree).items()}
    elif "tok_emb" in tree:  # BERT
        flat = {}
        for k, v in _flatten(tree).items():
            if k.startswith("layers."):
                flat.update((f"layers.{i}.{k[len('layers.'):]}", v[i]) for i in range(len(v)))
            else:
                flat[k] = v
    else:
        raise ConfigError(f"not a param tree of MLP, ResNet or BERT: keys {sorted(tree)}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def to_reference_params(model: torch.nn.Module):
    """The port's model → the JAX package's param tree, numpy leaves."""
    flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    if isinstance(model, MLP):
        return _unflatten(flat)["layers"]
    if isinstance(model, ResNet):
        return _unflatten({k: v.transpose(OIHW_TO_HWIO) if v.ndim == 4 else v
                           for k, v in flat.items()})
    if isinstance(model, Bert):
        tree = _unflatten(flat)
        tree["layers"] = _stack(tree["layers"])
        return tree
    raise ConfigError(f"no reference param tree for {type(model).__name__}")


def _stack(trees: list):
    """Per-layer trees → one tree with each leaf stacked on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
