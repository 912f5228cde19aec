"""Cross-file convention rules (resolved in ``finalize``).

- ``undocumented-env``: every ``LAKESOUL_*`` env var the code reads must
  have a row in the README's environment-variable table.  Ops can only tune
  knobs they can find; every layer adds knobs and the table is the one
  place reviewers look.  Wildcard rows (``LAKESOUL_PROXY_S3_*``) document a
  whole prefix.
- ``metric-name``: obs metric names must follow the registry's documented
  scheme — ``lakesoul_<layer>_<name>``, ``_total`` suffix for counters,
  ``_seconds`` for histograms — and one name must be registered under
  exactly one kind across the whole codebase (the registry raises at
  runtime on a kind clash, but only on the code path that hits it; the lint
  gate catches it before it ships).
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Project, Rule

_ENV_RE = re.compile(r"^LAKESOUL_[A-Z0-9_]+$")
_ENV_DOC_RE = re.compile(r"LAKESOUL_[A-Z0-9_]*\*?")
_METRIC_NAME_RE = re.compile(r"^lakesoul_[a-z][a-z0-9_]*$")

_METRIC_FACTORIES = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}


class UndocumentedEnvRule(Rule):
    id = "undocumented-env"
    title = "LAKESOUL_* env var read in code but missing from the README table"

    def finalize(self, project: Project) -> Iterable[Finding]:
        readme = project.readme_text()
        documented: set[str] = set()
        prefixes: list[str] = []
        for tok in _ENV_DOC_RE.findall(readme):
            if tok.endswith("*"):
                prefixes.append(tok[:-1])
            else:
                documented.add(tok)

        seen: set[str] = set()
        for mod in project.modules:
            for node in mod.walk():
                if not (
                    isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _ENV_RE.match(node.value)
                ):
                    continue
                var = node.value
                if var in seen:
                    continue
                # a var is documented if a wildcard row's prefix covers it;
                # the reverse direction is allowed ONLY for dynamic-prefix
                # constants ("LAKESOUL_PROXY_S3_" + key — they end in "_"),
                # otherwise any var that happens to be a prefix of a
                # documented row would silently pass
                if var in documented or any(
                    var.startswith(p) or (var.endswith("_") and p.startswith(var))
                    for p in prefixes
                ):
                    seen.add(var)
                    continue
                seen.add(var)
                yield Finding(
                    self.id,
                    mod.relpath,
                    node.lineno,
                    f"{var} is read here but has no row in the README "
                    "environment-variable table",
                )


class MetricNameRule(Rule):
    id = "metric-name"
    title = "obs metric naming / single-kind registration"

    def finalize(self, project: Project) -> Iterable[Finding]:
        # name -> {kind -> [(path, line)]}
        registrations: dict[str, dict[str, list[tuple[str, int]]]] = defaultdict(
            lambda: defaultdict(list)
        )
        for mod in project.modules:
            if mod.relpath.endswith("obs/metrics.py"):
                continue  # the registry's own plumbing, not a call site
            for node in mod.walk():
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                    continue
                kind = _METRIC_FACTORIES.get(node.func.attr)
                if kind is None or not node.args:
                    continue
                first = node.args[0]
                if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
                    continue
                name = first.value
                registrations[name][kind].append((mod.relpath, node.lineno))
                if not _METRIC_NAME_RE.match(name):
                    yield Finding(
                        self.id,
                        mod.relpath,
                        node.lineno,
                        f"metric {name!r} breaks the lakesoul_<layer>_<name> "
                        "naming scheme (lowercase, lakesoul_ prefix)",
                    )
                elif kind == "counter" and not name.endswith("_total"):
                    yield Finding(
                        self.id,
                        mod.relpath,
                        node.lineno,
                        f"counter {name!r} must end in _total "
                        "(Prometheus counter convention)",
                    )
                elif kind == "histogram" and not name.endswith("_seconds"):
                    yield Finding(
                        self.id,
                        mod.relpath,
                        node.lineno,
                        f"histogram {name!r} must end in _seconds "
                        "(duration-histogram convention)",
                    )
        for name, kinds in sorted(registrations.items()):
            if len(kinds) > 1:
                sites = sorted(
                    (path, line) for locs in kinds.values() for path, line in locs
                )
                path, line = sites[0]
                yield Finding(
                    self.id,
                    path,
                    line,
                    f"metric {name!r} is registered under multiple kinds "
                    f"({', '.join(sorted(kinds))}) — the registry raises at "
                    "runtime on whichever call site loses the race",
                )
