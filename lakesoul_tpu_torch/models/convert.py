"""Weights carried between the JAX package's param trees and the port's
models, both ways and bit for bit.

The JAX package keeps each model's params as a pytree: MLP a list of
``{"w", "b"}``; ResNet ``{"stem", "stages", "head"}`` with HWIO conv
weights; BERT ``{"tok_emb", ..., "layers"}`` with every layer leaf stacked
on a leading [L] axis.  The port's modules mirror those trees, so a
state_dict key is the tree path joined by dots (``stages.1.0.conv2``); what
differs is the layout: conv weights are OIHW here, and BERT's layers are
``layers.{i}`` modules.  Leaves travel as numpy arrays.  MoE layers
(``layers.{i}.moe.*``, the reference's ``layers.moe``) cross the same way.

``shard_params`` / ``gather_params`` move between the full model's
state_dict and one rank's slice of it under a ``MeshPlan``, by the specs of
``models/bert.py`` ``param_sharding_rules`` (``pipeline_rules`` for the
layer stack split over pp); ``load_local`` makes a model hold a slice.  A
plan's model is drawn whole from one seed and sliced, so it equals
``Bert(cfg, seed=seed)``.
"""

from __future__ import annotations

import numpy as np
import torch

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models.bert import Bert, param_sharding_rules
from lakesoul_tpu_torch.models.mlp import MLP
from lakesoul_tpu_torch.models.resnet import ResNet
from lakesoul_tpu_torch.parallel.collectives import all_gather_stack

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
        return bert_reference_tree(flat)
    raise ConfigError(f"no reference param tree for {type(model).__name__}")


def _stack(trees: list):
    """Per-layer trees → one tree with each leaf stacked on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def bert_reference_tree(flat: dict) -> dict:
    """A BERT state_dict (``layers.{i}.*`` keys, tensors or arrays) → the
    reference's param tree, layers stacked, numpy leaves."""
    tree = _unflatten({k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                       for k, v in flat.items()})
    tree["layers"] = _stack(tree["layers"])
    return tree


def pipeline_rules(rules: dict) -> dict:
    """The pipeline layout's specs: every layer leaf's leading (layer) axis
    over 'pp' and nothing else split (the reference's stages see whole
    layers: its shard_map takes them ``P("pp")``)."""
    def over_pp(spec):
        if isinstance(spec, dict):
            return {k: over_pp(v) for k, v in spec.items()}
        return ("pp",)

    return {**rules, "layers": over_pp(rules["layers"])}


def _spec(rules: dict, key: str) -> tuple[tuple, bool]:
    """→ (the spec of state_dict ``key``, whether it is a layer leaf, whose
    spec[0] is the layer axis)."""
    parts = key.split(".")
    layered = parts[0] == "layers"
    node = rules
    for p in (["layers"] + parts[2:]) if layered else parts:
        node = node[p]
    spec = tuple(node)
    return ((spec or (None,)) if layered else spec), layered


def _layer_split(n_layers: int, plan, spec0) -> int:
    pp = plan.size(spec0) if spec0 else 1
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers do not split over pp={pp}")
    return n_layers // pp


def _bert_rules(state: dict) -> dict:
    return param_sharding_rules(n_experts=int(any(".moe." in k for k in state)))


def shard_params(full: dict, plan, rules: dict | None = None) -> dict:
    """The full model's state_dict → this rank's slice: each dim a spec
    names an axis for is cut into that axis's size and the rank's
    coordinate kept; a layer axis over 'pp' keeps this stage's layers,
    renumbered from 0.  ``rules`` defaults to BERT's
    ``param_sharding_rules`` (MoE or dense, as the keys say)."""
    rules = rules or _bert_rules(full)
    n_layers = len({k.split(".")[1] for k in full if k.startswith("layers.")})
    out = {}
    for key, t in full.items():
        spec, layered = _spec(rules, key)
        if layered:
            i = int(key.split(".")[1])
            per = _layer_split(n_layers, plan, spec[0])
            if spec[0] and i // per != plan.coord(spec[0]):
                continue
            key = ".".join(["layers", str(i % per)] + key.split(".")[2:])
            spec = spec[1:]
        for d, axis in enumerate(spec):
            if axis is not None:
                n = plan.size(axis)
                if t.shape[d] % n:
                    raise ValueError(f"{key} dim {d} ({t.shape[d]}) does not split over {axis}={n}")
                t = t.chunk(n, dim=d)[plan.coord(axis)]
        out[key] = t.contiguous()
    return out


@torch.no_grad()
def gather_params(local: dict, plan, rules: dict | None = None) -> dict:
    """This rank's slice (``shard_params``' layout; parameters or their
    gradients) → the full state_dict, on every rank of the mesh (a
    collective: every rank calls it)."""
    rules = rules or _bert_rules(local)
    out = {}
    for key in sorted(local):
        t = local[key].detach()
        spec, layered = _spec(rules, key)
        for d, axis in enumerate(spec[1:] if layered else spec):
            if axis is not None and plan.size(axis) > 1:
                t = torch.cat(list(all_gather_stack(t.contiguous(), plan.group(axis))), dim=d)
        if not layered:
            out[key] = t
            continue
        _, j, *rest = key.split(".")
        if spec[0] is None:
            out[key] = t
            continue
        per = len({k.split(".")[1] for k in local if k.startswith("layers.")})
        for s, part in enumerate(all_gather_stack(t.contiguous(), plan.group(spec[0]))):
            out[".".join(["layers", str(s * per + int(j))] + rest)] = part
    return out


def load_local(model: torch.nn.Module, local: dict) -> torch.nn.Module:
    """Make ``model`` hold ``local`` (``shard_params``' slice): each
    parameter replaced by the slice's tensor, on the model's device, and
    the layer list cut to the slice's layers."""
    dev = next(model.parameters()).device
    if hasattr(model, "layers"):
        n = len({k.split(".")[1] for k in local if k.startswith("layers.")})
        model.layers = torch.nn.ModuleList(list(model.layers)[:n])
    names = dict(model.named_parameters())
    if set(names) != set(local):
        raise ConfigError(f"slice keys differ from the model's: {sorted(set(names) ^ set(local))}")
    for key, t in local.items():
        mod, _, leaf = key.rpartition(".")
        setattr(model.get_submodule(mod) if mod else model, leaf,
                torch.nn.Parameter(t.to(dev).clone()))
    return model
