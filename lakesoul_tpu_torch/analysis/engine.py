"""lakelint engine: AST-based, project-native static analysis.

Generic linters can't know that ``runtime/pool.py`` is the only legal thread
substrate, that parallel pipeline stages must be deterministic, or that the
``:memory:`` sqlite connection is only safe behind ``meta/store.py``'s RLock.
Those are *project* invariants — the ones that caused real outages (the
nested-pool deadlock class, the shared-cursor race) — so they get a
project-native checker that runs as a CI gate
(tests/test_torch_analysis_clean.py).

Moving parts:

- :class:`Rule` — one invariant.  ``check(module)`` yields findings for a
  single file; ``finalize(project)`` yields cross-file findings (env vars vs
  the README table, metric-kind consistency) after every module was visited.
- :class:`Module` / :class:`Project` — parsed source handed to rules; the
  tree is parsed ONCE per file and shared by all rules.
- Suppression, two ways:
  (1) an inline pragma on the offending line::

          t = threading.Thread(...)  # lakelint: ignore[raw-thread] pump thread

      for code that is *allowed* to break the rule by design;
  (2) ``analysis/baseline.json`` for pre-existing findings that should not
      block the gate — every entry carries a human ``reason`` and entries
      that stop matching anything are reported as stale so the baseline
      only ever shrinks.

Baseline keys are ``rule::path::message`` (no line numbers — they drift on
every edit; messages are stable because rules phrase them around symbols).
"""

from __future__ import annotations

import ast
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

__all__ = [
    "EngineError",
    "Finding",
    "Module",
    "Project",
    "Rule",
    "Baseline",
    "run",
    "run_repo",
    "package_root",
    "default_baseline_path",
]


class EngineError(Exception):
    """The analyzer itself failed (bad rule id, unreadable baseline, git
    diff failure) — distinct from "the code has findings": the CLI maps
    findings to exit 1 and EngineError to exit 2 so CI can tell a broken
    gate from a failing one."""

_PRAGMA_RE = re.compile(r"#\s*lakelint:\s*ignore\[([a-z0-9_,\- ]+)\]")

# generated files are not held to hand-written invariants
_EXCLUDED_FILE_RE = re.compile(r"_pb2\.py$")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Module:
    """One parsed source file (parse once, share across rules).  ``walk()``
    and ``parents()`` are computed once and shared — with ~90 files and 7
    rules, per-rule re-walks dominated analyzer wall time before caching."""

    path: Path
    relpath: str
    source: str
    lines: list[str]
    tree: ast.Module
    _nodes: "list[ast.AST] | None" = field(default=None, repr=False)
    _parents: "dict[ast.AST, ast.AST] | None" = field(default=None, repr=False)

    def walk(self) -> "list[ast.AST]":
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def parents(self) -> "dict[ast.AST, ast.AST]":
        if self._parents is None:
            parents: dict[ast.AST, ast.AST] = {}
            for node in self.walk():
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            self._parents = parents
        return self._parents

    @classmethod
    def load(cls, path: Path, root: Path) -> "Module | None":
        try:
            source = path.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(path))
        except (OSError, SyntaxError, ValueError):
            return None  # unreadable/unparsable: not this linter's business
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:  # outside the root: keep a stable absolute key
            rel = path.resolve().as_posix()
        return cls(path, rel, source, source.splitlines(), tree)

    def pragma_rules(self, line: int) -> set[str]:
        """Rule ids suppressed by an inline pragma on ``line`` (1-based)."""
        if not 1 <= line <= len(self.lines):
            return set()
        m = _PRAGMA_RE.search(self.lines[line - 1])
        if not m:
            return set()
        return {r.strip() for r in m.group(1).split(",") if r.strip()}


@dataclass
class Project:
    """Everything a rule may look at: the parsed modules plus repo docs."""

    root: Path
    modules: list[Module] = field(default_factory=list)
    _callgraph: "object | None" = field(default=None, repr=False)
    # the concurrency pack's shared indexes (threadroots.thread_roots(),
    # rules.races class-access index), same build-once contract
    _thread_roots: "object | None" = field(default=None, repr=False)
    _race_index: "object | None" = field(default=None, repr=False)
    # the durability pack's per-function filesystem-op index
    # (rules.durability._op_index), same build-once contract
    _durability_index: "object | None" = field(default=None, repr=False)
    # the isolation pack's per-module SQL/transaction index
    # (rules.isolation._sql_index), same build-once contract
    _isolation_index: "object | None" = field(default=None, repr=False)
    # the boundedness pack's per-class resource-lifecycle index
    # (rules.boundedness._class_index), same build-once contract
    _boundedness_index: "object | None" = field(default=None, repr=False)

    def callgraph(self):
        """The project call graph, built ONCE and shared by every
        interprocedural rule (building it is a full extra pass over the
        shared AST walks — four rules must not pay it four times)."""
        if self._callgraph is None:
            from lakesoul_tpu_torch.analysis.callgraph import CallGraph

            self._callgraph = CallGraph.build(self)
        return self._callgraph

    def readme_text(self) -> str:
        for name in ("README.md", "README.rst", "README"):
            p = self.root / name
            if p.is_file():
                try:
                    return p.read_text(encoding="utf-8")
                except OSError:
                    return ""
        return ""


class Rule:
    """Base class: one project invariant.  Subclasses set ``id``/``title``
    and override ``check`` (per-file) and/or ``finalize`` (cross-file)."""

    id: str = ""
    title: str = ""

    def check(self, module: Module) -> Iterable[Finding]:
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        return ()


class Baseline:
    """Checked-in suppression list (``analysis/baseline.json``).

    Schema: ``{"version": 1, "suppressions": [{"rule", "path", "message",
    "reason"}, ...]}``.  ``reason`` is mandatory — a suppression nobody can
    justify is a bug with a paper trail."""

    def __init__(self, entries: list[dict]):
        self.entries = entries
        self._keys = {
            f"{e['rule']}::{e['path']}::{e['message']}": e for e in entries
        }
        self._used: set[str] = set()

    @classmethod
    def load(cls, path: Path | str | None) -> "Baseline":
        if path is None:
            return cls([])
        p = Path(path)
        if not p.is_file():
            return cls([])
        data = json.loads(p.read_text(encoding="utf-8"))
        entries = data.get("suppressions", [])
        for e in entries:
            missing = {"rule", "path", "message", "reason"} - set(e)
            if missing:
                raise ValueError(
                    f"baseline entry {e!r} is missing {sorted(missing)} — "
                    "every suppression must be justified"
                )
        return cls(entries)

    def suppresses(self, finding: Finding) -> bool:
        hit = finding.key in self._keys
        if hit:
            self._used.add(finding.key)
        return hit

    def stale_entries(self) -> list[dict]:
        """Entries that matched nothing this run — fixed findings whose
        suppression should be deleted."""
        return [e for k, e in self._keys.items() if k not in self._used]


# ------------------------------------------------------------------ discovery


def package_root() -> Path:
    """The installed ``lakesoul_tpu_torch`` package directory."""
    return Path(__file__).resolve().parents[1]


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def _iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(
                f for f in p.rglob("*.py") if not _EXCLUDED_FILE_RE.search(f.name)
            )
        elif p.suffix == ".py":
            yield p


# -------------------------------------------------------------------- running


def run(
    paths: Iterable[Path | str] | None = None,
    *,
    root: Path | str | None = None,
    rules: Iterable[Rule] | None = None,
    baseline: Baseline | None = None,
    timings: "dict[str, float] | None" = None,
) -> tuple[list[Finding], Baseline]:
    """Analyse ``paths`` (default: the whole package) and return
    ``(unsuppressed findings, baseline)`` — the baseline is returned so
    callers can ask it for stale entries.  Pass a dict as ``timings`` to
    receive per-rule wall seconds (check + finalize; a shared index — call
    graph, thread roots — bills to the first rule that builds it)."""
    from lakesoul_tpu_torch.analysis.rules import all_rules

    if paths is None:
        paths = [package_root()]
    root = Path(root) if root is not None else package_root().parent
    rules = list(rules) if rules is not None else all_rules()
    baseline = baseline if baseline is not None else Baseline([])

    project = Project(root=root)
    for f in _iter_py_files(Path(p) for p in paths):
        mod = Module.load(f, root)
        if mod is not None:
            project.modules.append(mod)

    def clocked(rule_id: str, started: float) -> None:
        if timings is not None:
            timings[rule_id] = (
                timings.get(rule_id, 0.0) + time.perf_counter() - started
            )

    findings: list[Finding] = []
    for rule in rules:
        t0 = time.perf_counter()
        for mod in project.modules:
            for finding in rule.check(mod):
                if rule.id not in mod.pragma_rules(finding.line):
                    findings.append(finding)
        clocked(rule.id, t0)
    by_rel = {m.relpath: m for m in project.modules}
    for rule in rules:
        t0 = time.perf_counter()
        for finding in rule.finalize(project):
            mod = by_rel.get(finding.path)
            if mod is not None and rule.id in mod.pragma_rules(finding.line):
                continue
            findings.append(finding)
        clocked(rule.id, t0)

    findings = [f for f in findings if not baseline.suppresses(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, baseline


def run_repo(
    baseline_path: Path | str | None = "default",
    *,
    timings: "dict[str, float] | None" = None,
) -> tuple[list[Finding], Baseline]:
    """The CI-gate entry point: whole package, checked-in baseline."""
    if baseline_path == "default":
        baseline_path = default_baseline_path()
    return run(baseline=Baseline.load(baseline_path), timings=timings)


# ----------------------------------------------------------- shared AST utils
# (used by several rules; kept here so rules stay small)


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enclosing_function_bodies(tree: ast.Module):
    """Yield ``(scope_node, body)`` for the module and every function —
    scopes a rule may search for cleanup calls without crossing into nested
    closures' runtime."""
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def walk_stopping_at_functions(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements WITHOUT descending into nested function/lambda bodies
    (their code runs later — outside the lexical context being checked)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # the def statement is visible; its body is not
        stack.extend(ast.iter_child_nodes(node))
