"""``fleet-identity-label``: process-identity labels come from obs.fleet.

The fleet aggregator keys every merged series on the identity labels
(``role=``, ``service_id=``, ``worker=``).  A hand-rolled literal at a
metric call site — ``reg.gauge("...", role="scanworker")`` or an f-string
``service_id=f"w-{pid}"`` — mints a SECOND spelling of an identity the
process already has (:func:`lakesoul_tpu_torch.obs.fleet.process_identity`), and
the aggregate silently splits into per-spelling series nobody sums.  The
sanctioned sources are the obs.fleet helpers (``identity_labels()``,
``identity().service_id``, a worker's own ``worker_id`` attribute):
VARIABLES carrying the one registered identity, which is exactly what this
rule can distinguish from an inline string.

Flagged: a string-literal or f-string value for an identity keyword in a
call to a metric factory (``counter``/``gauge``/``histogram``) or a stage
helper (``stage_merge``/``stage_observe``/``stage_histogram``).  Values
read from a variable, attribute, or call pass — they trace back to a
single assignment a reviewer can audit.  ``obs/fleet.py`` itself is
exempt: it is the implementation these labels must come from.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule

_IDENTITY_KEYS = ("role", "worker", "service_id")

_FACTORIES = (
    "counter", "gauge", "histogram",
    "stage_merge", "stage_observe", "stage_histogram",
)

_EXEMPT = ("lakesoul_tpu_torch/obs/fleet.py",)


def _callee_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class FleetIdentityLabelRule(Rule):
    id = "fleet-identity-label"
    title = "hand-rolled process-identity label at a metric call site"

    def check(self, module: Module) -> Iterable[Finding]:
        if any(module.relpath.endswith(p) for p in _EXEMPT):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node.func)
            if name not in _FACTORIES:
                continue
            for kw in node.keywords:
                if kw.arg not in _IDENTITY_KEYS:
                    continue
                v = kw.value
                literal = (
                    isinstance(v, ast.Constant) and isinstance(v.value, str)
                ) or isinstance(v, ast.JoinedStr)
                if literal:
                    yield Finding(
                        self.id,
                        module.relpath,
                        node.lineno,
                        f"identity label {kw.arg}= is a hand-rolled string at"
                        f" a {name}() call site; use the obs.fleet identity"
                        " helpers (identity_labels() / process_identity())"
                        " so fleet aggregation sees ONE spelling",
                    )
