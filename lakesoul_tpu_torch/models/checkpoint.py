"""Training-state checkpoints, the port of ``lakesoul_tpu/models/checkpoint.py``.

The same API as the reference's ``TrainCheckpointer`` (save, latest_step,
restore_latest, close, max_to_keep).  The format is the port's own: Orbax's
is not carried over.  Each step is a directory ``<root>/<step>/`` holding one
``torch.save`` file, ``state.pt``, published by an atomic rename
(``runtime/atomicio``): a step directory without it is not a checkpoint.
"""

from __future__ import annotations

import io
import os
import shutil
from pathlib import Path

import torch

from lakesoul_tpu_torch.runtime.atomicio import publish_bytes

STATE_FILE = "state.pt"


class TrainCheckpointer:
    """Save/restore (params, opt_state, step) under a directory.

    ::

        ckpt = TrainCheckpointer(f"{warehouse}/_checkpoints/bert")
        ckpt.save(step, model.state_dict(), opt.state_dict())
        params, opt_state, step = ckpt.restore_latest(
            like=(model.state_dict(), opt.state_dict()))  # `like`: devices, dtypes
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self._root = Path(os.path.abspath(directory))
        self._root.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        return sorted(int(p.name) for p in self._root.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def save(self, step: int, params, opt_state) -> None:
        buf = io.BytesIO()
        torch.save({"params": params, "opt_state": opt_state}, buf)
        d = self._root / str(step)
        d.mkdir(exist_ok=True)
        publish_bytes(d / STATE_FILE, buf.getvalue())
        for old in self._steps()[:-self._max_to_keep]:
            shutil.rmtree(self._root / str(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, *, like=None):
        """→ (params, opt_state, step), loaded on the CPU; ``like=(params,
        opt_state)`` puts each tensor on its counterpart's device and dtype
        and requires the template's structure (see ``_like``)."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        state = torch.load(self._root / str(step) / STATE_FILE, map_location="cpu",
                           weights_only=True)
        params, opt_state = state["params"], state["opt_state"]
        if like is not None:
            params, opt_state = _like(params, like[0]), _like(opt_state, like[1])
        return params, opt_state, step

    def close(self) -> None:
        """Nothing is held open between calls (the reference's closes Orbax's manager)."""


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
