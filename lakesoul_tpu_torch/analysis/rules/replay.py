"""``replay-host-roundtrip``: device-resident replay must stay device-resident.

The tensor plane's whole value is that epoch ≥ 2 never touches the host:
pinned shards replay from HBM, permutations run on device, the streamed
tail is the ONLY host traffic a spilled cache pays.  One stray
``np.asarray(batch["x"])`` in the serving path silently reintroduces a
device→host→device round trip per batch — no crash, no wrong bytes, just
the subsystem's reason to exist gone.  Nothing type-checks that; this rule
does.

Flagged calls, anywhere under ``lakesoul_tpu_torch/tensorplane/``:

- ``asarray(...)`` (``np.asarray``, ``numpy.asarray``, a bare import) —
  the canonical device→host materialization.  ``torch.asarray(...,
  device=...)`` stays legal: it moves TOWARD the device;
- ``.cpu()``, ``.numpy()`` and ``.item()`` — torch's device→host moves
  (a copy back, a host view, a synchronizing scalar read);
- ``.tolist()`` — a host materialization *and* a Python-object explosion;
- ``.to_pandas()`` — a host copy and a pandas dependency in the device
  plane.

``torch.as_tensor(..., device=...)``, ``.to(device)`` and ``.cuda()`` stay
legal: they move toward the device.

Sanctioned host readbacks exist — the smoke register reads device results
back to *verify* them against host twins — and each carries an inline
``# lakelint: ignore[replay-host-roundtrip] <reason>`` pragma naming that
purpose, so every exception is justified in place.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule, dotted_name

SCOPE = ("lakesoul_tpu_torch/tensorplane/",)

_METHODS = ("cpu", "numpy", "item", "tolist", "to_pandas")


def _toward_device(name: str, call: ast.Call) -> bool:
    """``torch.asarray(x, device=d)``: a move onto the named device."""
    return name.split(".")[0] == "torch" and any(
        kw.arg == "device" for kw in call.keywords
    )


class ReplayHostRoundtripRule(Rule):
    id = "replay-host-roundtrip"
    title = "host materialization of device-resident replay data"

    def __init__(self, scope: tuple[str, ...] = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(s in module.relpath for s in self.scope):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            callee = None
            name = dotted_name(node.func)
            if name is not None and name.split(".")[-1] == "asarray" \
                    and not _toward_device(name, node):
                callee = f"{name}()"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _METHODS
            ):
                callee = f".{node.func.attr}()"
            if callee is None:
                continue
            yield Finding(
                self.id,
                module.relpath,
                node.lineno,
                f"{callee} materializes device-resident data on the host"
                " inside the tensor plane — replay shards must stay on"
                " device (permute with torch.randperm on the device,"
                " account with .nbytes, compare with device-side ops); a"
                " justified verification readback needs an inline pragma"
                " naming its purpose",
            )
