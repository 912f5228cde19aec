"""Training-state checkpoints, the port of ``lakesoul_tpu/models/checkpoint.py``.

The same API as the reference's ``TrainCheckpointer`` (save, latest_step,
restore_latest, close, max_to_keep).  The format is the port's own: Orbax's
is not carried over.  Each step is a directory ``<root>/<step>/``, and a
step directory is a checkpoint only once it is whole:

- a whole model (``plan=None``) is one ``torch.save`` file, ``state.pt``,
  published by an atomic rename (``runtime/atomicio``);
- a ``plan=`` model (each rank holds its slice, ``make_bert_train_state(
  plan=)``) is saved by every rank together through
  ``torch.distributed.checkpoint`` (DCP) into ``<root>/.<step>.tmp/``.  Each
  parameter goes in under its name in the whole model, as a ``DTensor``
  over the plan's mesh whose placements are its sharding rules, which the
  model's ``state_dict()`` carries (``train.state_dict_rules``: a dim a rule
  splits over an axis is ``Shard`` on that mesh dim, the rest
  ``Replicate``), so DCP sees its global shape and stores each slice once;
  a layer that the pipeline layout gives one stage is a plain tensor under
  its global layer index.  The AdamW moments take their parameter's
  placement.  When DCP has written every rank's files and the metadata,
  rank 0 writes ``sharded.json`` (the step, the mesh, the optimizer's
  hyperparameters) and renames the directory to ``<root>/<step>``.
  Old steps are pruned after that, on rank 0, behind a barrier.

``restore_latest(like=, plan=)`` restores onto the template's plan, which
may differ from the saved one: DCP reads each rank's slice of every tensor
from the slices that were saved.  A sharded step restores onto
``plan=None`` too (``like`` then holds whole tensors).
"""

from __future__ import annotations

import io
import json
import os
import shutil
from pathlib import Path

import torch

from lakesoul_tpu_torch.runtime.atomicio import fsync_dir, publish_bytes

STATE_FILE = "state.pt"
SHARDED_FILE = "sharded.json"
MOMENTS = ("exp_avg", "exp_avg_sq")


class TrainCheckpointer:
    """Save/restore (params, opt_state, step) under a directory.

    ::

        ckpt = TrainCheckpointer(f"{warehouse}/_checkpoints/bert")
        ckpt.save(step, model.state_dict(), opt.state_dict())
        params, opt_state, step = ckpt.restore_latest(
            like=(model.state_dict(), opt.state_dict()))  # `like`: devices, dtypes

    With a ``plan=`` model, every rank calls ``save`` and ``restore_latest``
    with ``plan=``.  ``params`` is the model's own ``state_dict()``, which
    carries the rules the model was cut by (``make_bert_train_state(plan=)``,
    ``make_bert_pipeline_train_state``), and the optimizer holds
    ``model.parameters()`` in that order."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self._root = Path(os.path.abspath(directory))
        self._root.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        return sorted(int(p.name) for p in self._root.iterdir()
                      if p.name.isdigit() and ((p / STATE_FILE).is_file()
                                               or (p / SHARDED_FILE).is_file()))

    def _prune(self) -> None:
        for old in self._steps()[:-self._max_to_keep]:
            shutil.rmtree(self._root / str(old))

    def save(self, step: int, params, opt_state, *, plan=None) -> None:
        if plan is not None:
            self._save_sharded(step, params, opt_state, plan)
            return
        buf = io.BytesIO()
        torch.save({"params": params, "opt_state": opt_state}, buf)
        d = self._root / str(step)
        d.mkdir(exist_ok=True)
        publish_bytes(d / STATE_FILE, buf.getvalue())
        self._prune()

    def _save_sharded(self, step: int, params: dict, opt_state: dict, plan) -> None:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        layout = _Layout(params, plan)
        state = _opt_state_by_name(params, opt_state)
        flat = {}
        for key, t in params.items():
            flat[f"model.{layout.name(key)}"] = layout.wrap(key, t)
        for key, entry in state.items():
            for k, v in entry.items():
                flat[f"optim.{layout.name(key)}.{k}"] = (
                    layout.wrap(key, v) if k in MOMENTS else v)
        rank0 = dist.get_rank() == 0
        tmp = self._root / f".{step}.tmp"
        if rank0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
        dist.barrier()
        dcp.save(flat, storage_writer=dcp.FileSystemWriter(str(tmp)))
        if rank0:  # DCP returns on every rank once the coordinator wrote its metadata
            doc = {"format": "torch.distributed.checkpoint", "step": step,
                   "mesh": {a: plan.size(a) for a in ("dp", "tp", "sp", "pp", "ep")},
                   "param_groups": [{k: v for k, v in g.items() if k != "params"}
                                    for g in opt_state["param_groups"]]}
            publish_bytes(tmp / SHARDED_FILE, json.dumps(doc).encode())
            final = self._root / str(step)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            fsync_dir(self._root)
        dist.barrier()  # the step is whole and visible on every rank
        if rank0:
            self._prune()
        dist.barrier()

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, *, like=None, plan=None):
        """→ (params, opt_state, step).  A whole-model step loads on the
        CPU; ``like=(params, opt_state)`` puts each tensor on its
        counterpart's device and dtype and requires the template's
        structure (see ``_like``).  A sharded step needs ``like`` (its
        tensors give each slice's device and dtype) and, for a ``plan=``
        model, ``plan=``: the tensors come back as this rank's slices under
        the template plan."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = self._root / str(step)
        if (d / SHARDED_FILE).is_file():
            if like is None:
                raise ValueError("a sharded checkpoint restores onto a template: pass like=")
            params, opt_state = _restore_sharded(d, like, plan)
            return params, opt_state, step
        if plan is not None:
            raise ValueError(f"step {step} holds a whole model: restore it with plan=None")
        state = torch.load(d / STATE_FILE, map_location="cpu", weights_only=True)
        params, opt_state = state["params"], state["opt_state"]
        if like is not None:
            params, opt_state = _like(params, like[0]), _like(opt_state, like[1])
        return params, opt_state, step

    def close(self) -> None:
        """Nothing is held open between calls (the reference's closes Orbax's manager)."""


class _Layout:
    """Where each of a rank's parameters sits in the whole model: its name
    there (a pipeline stage's layers renumbered to their global index) and
    its placements on the plan's mesh, from the sharding rules that
    ``params`` carries.  Without them a slice could not be told from a
    replica (a pipeline stage's ``layers.0`` from another's), so a plan
    model's state that lost them is refused."""

    def __init__(self, params: dict, plan):
        from lakesoul_tpu_torch.models.train import state_dict_rules

        self.plan = plan
        self.rules = state_dict_rules(params)
        if plan is not None and self.rules is None:
            raise ValueError("a plan= checkpoint needs the model's own state_dict(), which "
                             "carries its sharding rules: this one carries none")
        self.n_layers = len({k.split(".")[1] for k in params if k.startswith("layers.")})

    def _spec(self, key: str):
        from lakesoul_tpu_torch.models.convert import _spec

        spec, layered = _spec(self.rules, key)
        return (spec[0], spec[1:]) if layered else (None, spec)

    def name(self, key: str) -> str:
        if self.plan is None:
            return key
        layer_axis, _ = self._spec(key)
        if not layer_axis:
            return key
        _, j, *rest = key.split(".")
        i = self.plan.coord(layer_axis) * self.n_layers + int(j)
        return ".".join(["layers", str(i), *rest])

    def wrap(self, key: str, t: torch.Tensor):
        """``t`` as DCP must see it: a DTensor when an axis of more than
        one rank splits it, else the tensor itself (replicated: saved once)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from lakesoul_tpu_torch.parallel.mesh import AXES

        if self.plan is None:
            return t
        layer_axis, spec = self._spec(key)
        split = [(d, a) for d, a in enumerate(spec) if a is not None and self.plan.size(a) > 1]
        if not split:
            return t
        if layer_axis and self.plan.size(layer_axis) > 1:
            raise ValueError(f"{key}: a layer split over {layer_axis} is split over "
                             f"{[a for _, a in split]} too, which no layout of the port does")
        placements = [Replicate()] * len(AXES)
        shape = list(t.shape)
        for d, a in split:
            placements[AXES.index(a)] = Shard(d)
            shape[d] *= self.plan.size(a)
        return DTensor.from_local(t, self.plan.mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())


def _opt_state_by_name(params: dict, opt_state: dict) -> dict:
    """The optimizer's state keyed by parameter name (its index is the
    name's place in ``params``)."""
    names = list(params)
    n = sum(len(g["params"]) for g in opt_state["param_groups"])
    if n != len(names):
        raise ValueError(f"the optimizer holds {n} parameters, the model {len(names)}")
    state = {names[i]: entry for i, entry in opt_state["state"].items()}
    for key, entry in state.items():
        for k in MOMENTS:
            if k in entry and entry[k].shape != params[key].shape:
                raise ValueError(f"{key}'s {k} is not shaped as its parameter")
    return state


def _restore_sharded(d: Path, like, plan):
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    doc = json.loads((d / SHARDED_FILE).read_text())
    reader = dcp.FileSystemReader(str(d))
    saved = reader.read_metadata().state_dict_metadata
    like_params, like_opt = like
    layout = _Layout(like_params, plan)
    templates, flat = {}, {}
    for key, t in like_params.items():
        name = layout.name(key)
        if f"model.{name}" not in saved:
            raise ValueError(f"checkpoint {d} holds no parameter {name}")
        templates[key] = torch.empty_like(t)
        flat[f"model.{name}"] = layout.wrap(key, templates[key])
    moments = {}
    for key, t in like_params.items():
        name = layout.name(key)
        for k in MOMENTS:
            meta = saved.get(f"optim.{name}.{k}")
            if meta is not None:
                moments.setdefault(key, {})[k] = torch.empty_like(t, dtype=meta.properties.dtype)
                flat[f"optim.{name}.{k}"] = layout.wrap(key, moments[key][k])
        meta = saved.get(f"optim.{name}.step")
        if meta is not None:
            moments.setdefault(key, {})["step"] = torch.empty(meta.size,
                                                              dtype=meta.properties.dtype)
            flat[f"optim.{name}.step"] = moments[key]["step"]
    dcp.load(flat, storage_reader=reader,
             no_dist=not (dist.is_available() and dist.is_initialized()))
    names = list(like_params)
    state = {names.index(key): entry for key, entry in moments.items()}
    return templates, {"state": state,
                       "param_groups": _param_groups(like_opt["param_groups"],
                                                     doc["param_groups"])}


def _param_groups(template: list, saved: list) -> list:
    """The template's groups (their parameter indices: this rank's, under
    the template's plan) with the saved hyperparameters; a saved list comes
    back as the template's tuple."""
    if len(template) != len(saved):
        raise ValueError(f"{len(saved)} saved parameter groups, {len(template)} in the template")
    return [{**g, **{k: type(g[k])(v) if isinstance(g.get(k), tuple) else v
                     for k, v in s.items()}}
            for g, s in zip(template, saved)]


def _like(tree, template, path: str = ""):
    """``tree`` with each tensor on its template counterpart's device and
    dtype.  The template's keys, list lengths and tensor shapes must be the
    checkpoint's; keys only the checkpoint has (the moments a fresh
    optimizer has not made yet) stay as loaded."""
    where = path or "<root>"
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            raise ValueError(f"checkpoint leaf {where} does not match its template")
        return tree.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(tree, dict) or not set(template) <= set(tree):
            raise ValueError(f"checkpoint keys at {where} do not match the template")
        return type(tree)((k, _like(v, template[k], f"{path}.{k}") if k in template else v)
                          for k, v in tree.items())
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"checkpoint list at {where} does not match the template")
        return type(tree)(_like(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(tree, template)))
    return tree
