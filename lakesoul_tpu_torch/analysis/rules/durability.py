"""Durability rules — every cross-process publication is torn-state-free.

The fleet era made atomic publication the backbone of every cross-process
protocol: spool segments and session manifests (scanplane), ANN plane
records (annplane), obs fleet docs (obs/fleet), the CRC-sidecar spill
rung (fleet/transport), freshness oracle docs.  The package consolidated the
four hand-rolled tmp→fsync→rename implementations onto ONE sanctioned
seam — :mod:`lakesoul_tpu_torch.runtime.atomicio` — and these rules keep it
that way.  Three rules, all over the shared per-function filesystem-op
index (one pass, cached on the project):

- ``torn-publish``: a write-mode ``open`` (bare or ``fs.open(_, "wb")``)
  inside a publication module is a hand-rolled or in-place publish — a
  reader (or a crash) can observe the half-written file.  Renames whose
  producing write hides in a callee are flagged interprocedurally at the
  rename (1-hop over the callgraph).  Only ``runtime/atomicio.py`` may
  hold the raw ops.
- ``unfsynced-rename``: ``os.replace``/``rename``/``fs.mv`` of a file
  whose producing flow (same function + 1-hop callees) writes it but
  never fsyncs — the rename is atomic against readers, yet a host crash
  can replace good data with an empty inode (the classic ALICE finding).
- ``barrier-order``: publication barriers — CRC sidecars, ``LATEST``/
  ``PLANE`` pointers, manifest head docs — must be written AFTER the
  data they cover is durable, checked as intra-function op ordering.
  Barrier-ness is read off the call's argument identifiers (``crc_p``,
  ``LATEST``, ``POINTER``); nested call *names* in arguments are ignored
  so ``_crc_wrap(payload)`` wrapping data blobs does not misclassify.

Known limits, on purpose: flows are followed one resolved hop (the
publication helpers are all direct calls — deeper chains are the runtime
fscheck's job), and write-mode detection needs a constant mode string
(a variable mode is a wrapper's business; the wrapper itself is linted).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable

from lakesoul_tpu_torch.analysis.callgraph import iter_calls_in_order
from lakesoul_tpu_torch.analysis.engine import Finding, Project, Rule, dotted_name

# the publication modules the repo gate runs with; fixtures override.
# runtime/atomicio.py is the sanctioned seam: exempt from torn-publish,
# still checked by unfsynced-rename and barrier-order.
SCOPE = (
    "scanplane/",
    "annplane/",
    "fleet/",
    "freshness/",
    "obs/fleet",
    "vector/manifest",
    "runtime/atomicio",
)

SANCTIONED = ("runtime/atomicio.py",)

_RENAME_TERMINALS = {"replace", "rename", "mv", "move"}
_FSYNC_TERMINALS = {"fsync", "_fsync_best_effort", "fsync_best_effort"}
_PUBLISH_TERMINALS = {
    "publish_atomic", "publish_bytes_fs", "publish_stream", "stage_stream",
}

# exact-match barrier identifiers (pointer/head names are SHOUTED in the
# stores) + lowercase substrings for CRC/barrier-shaped variable names
_BARRIER_EXACT = {"LATEST", "PLANE", "POINTER", "HEAD"}
_BARRIER_SUBSTRINGS = ("crc", "barrier")


@dataclass(frozen=True)
class _FsOp:
    kind: str  # "open_w" | "rename" | "fsync" | "publish"
    line: int
    barrier: bool  # argument identifiers name a barrier artifact


@dataclass
class _FuncOps:
    qname: str
    relpath: str
    name: str
    ops: list = field(default_factory=list)  # [_FsOp] in lexical order


def _const_mode_writes(call: ast.Call) -> bool:
    """True when the call's mode argument is a constant string containing a
    write/append/create flag.  ``open(p)`` defaults to read; a variable
    mode is a wrapper's business, not a publication site."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not isinstance(mode, ast.Constant) or not isinstance(mode.value, str):
        return False
    return any(ch in mode.value for ch in "wxa")


def _arg_tokens(call: ast.Call) -> "set[str]":
    """Identifiers + string constants inside the call's ARGUMENTS, skipping
    the func position of nested calls — ``_crc_wrap(payload)`` as a data
    argument must not smuggle 'crc' into the data op's token set."""
    out: set[str] = set()
    stack: list[ast.AST] = list(call.args) + [kw.value for kw in call.keywords]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            stack.extend(node.args)
            stack.extend(kw.value for kw in node.keywords)
            # the func position (Name/Attribute chain) is dropped, but an
            # attribute call's RECEIVER is a value — keep it
            if isinstance(node.func, ast.Attribute):
                stack.append(node.func.value)
            continue
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
            stack.append(node.value)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        else:
            stack.extend(ast.iter_child_nodes(node))
    return out


def _is_barrier(call: ast.Call) -> bool:
    for tok in _arg_tokens(call):
        if any(exact in tok for exact in _BARRIER_EXACT):
            return True
        low = tok.lower()
        if any(sub in low for sub in _BARRIER_SUBSTRINGS):
            return True
    return False


def _classify(call: ast.Call) -> "str | None":
    name = dotted_name(call.func) or ""
    terminal = name.rsplit(".", 1)[-1]
    if terminal == "open":
        return "open_w" if _const_mode_writes(call) else None
    if terminal in _FSYNC_TERMINALS:
        return "fsync"
    if terminal in _PUBLISH_TERMINALS or name.startswith("atomicio."):
        return "publish"
    if terminal in _RENAME_TERMINALS:
        # os.replace / os.rename / fs.mv / shutil.move — plain ``x.rename``
        # on non-fs receivers (pandas) is out of scope by module anyway
        return "rename"
    if terminal != "write" and (
        terminal.startswith("write_") or terminal.startswith("_write")
    ):
        # protocol-level writers (_write_blob, write_spill_probe, …):
        # publications for ordering purposes, not raw writes
        return "publish"
    return None


def _op_index(project: Project) -> "dict[str, _FuncOps]":
    """Per-function filesystem-op index over the WHOLE project (scope is a
    flag-time filter so cross-scope flows still resolve), built once and
    shared by all three rules."""
    cached = project._durability_index
    if cached is not None:
        return cached
    graph = project.callgraph()
    out: dict[str, _FuncOps] = {}
    for qname, fn in graph.functions.items():
        fo = _FuncOps(qname, fn.relpath, fn.name)
        for call in iter_calls_in_order(fn.node.body):
            kind = _classify(call)
            if kind is not None:
                fo.ops.append(_FsOp(kind, call.lineno, _is_barrier(call)))
        if fo.ops:
            out[qname] = fo
    project._durability_index = out
    return out


def _flow_ops(index: "dict[str, _FuncOps]", graph, qname: str) -> "list[_FsOp]":
    """A function's own ops plus its resolved 1-hop callees' ops — the
    producing flow a rename's durability is judged against."""
    own = index.get(qname)
    ops = list(own.ops) if own else []
    for edge in graph.callees(qname):
        if edge.callee is None or edge.callee == qname:
            continue
        callee = index.get(edge.callee)
        if callee is not None:
            ops.extend(callee.ops)
    return ops


def _in_scope(relpath: str, scope: tuple) -> bool:
    return any(s in relpath for s in scope)


class TornPublishRule(Rule):
    id = "torn-publish"
    title = "publication-path write bypasses the sanctioned atomic seam"

    def __init__(self, scope: tuple = SCOPE, sanctioned: tuple = SANCTIONED):
        self.scope = scope
        self.sanctioned = sanctioned

    def finalize(self, project: Project) -> Iterable[Finding]:
        index = _op_index(project)
        graph = project.callgraph()
        for qname, fo in sorted(index.items()):
            if not _in_scope(fo.relpath, self.scope):
                continue
            if any(fo.relpath.endswith(s) for s in self.sanctioned):
                continue
            for op in fo.ops:
                if op.kind == "open_w":
                    yield Finding(
                        self.id,
                        fo.relpath,
                        op.line,
                        f"{fo.name} opens a publication-path file in write "
                        "mode outside runtime/atomicio — a reader or a "
                        "crash can observe the half-written file; publish "
                        "via atomicio.publish_atomic/stage_stream "
                        "(publish_bytes_fs for fsspec stores)",
                    )
            own_has_open = any(o.kind == "open_w" for o in fo.ops)
            if own_has_open:
                continue  # the open above is the anchor; don't double-flag
            flow = _flow_ops(index, graph, qname)
            if any(o.kind == "publish" for o in fo.ops):
                continue
            if any(o.kind == "open_w" for o in flow):
                for op in fo.ops:
                    if op.kind == "rename":
                        yield Finding(
                            self.id,
                            fo.relpath,
                            op.line,
                            f"{fo.name} renames a file whose producing "
                            "write lives in a callee — a hand-rolled "
                            "publication split across functions; route the "
                            "whole flow through runtime/atomicio",
                        )


class UnfsyncedRenameRule(Rule):
    id = "unfsynced-rename"
    title = "rename publishes bytes the producing flow never fsynced"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        index = _op_index(project)
        graph = project.callgraph()
        for qname, fo in sorted(index.items()):
            if not _in_scope(fo.relpath, self.scope):
                continue
            renames = [o for o in fo.ops if o.kind == "rename"]
            if not renames:
                continue
            flow = _flow_ops(index, graph, qname)
            if not any(o.kind == "open_w" for o in flow):
                continue  # nothing written in this flow — a pure move
            if any(o.kind in ("fsync", "publish") for o in flow):
                continue  # the flow makes its bytes durable before renaming
            for op in renames:
                yield Finding(
                    self.id,
                    fo.relpath,
                    op.line,
                    f"{fo.name} renames a file its flow wrote but never "
                    "fsynced — the rename is atomic against readers, yet a "
                    "host crash can land the new name on an empty inode; "
                    "fsync before rename (atomicio does both)",
                )


class BarrierOrderRule(Rule):
    id = "barrier-order"
    title = "publication barrier written before the data it covers"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        index = _op_index(project)
        for qname, fo in sorted(index.items()):
            if not _in_scope(fo.relpath, self.scope):
                continue
            pubs = [
                o for o in fo.ops
                if o.kind in ("open_w", "rename", "publish")
            ]
            for i, op in enumerate(pubs):
                if not op.barrier:
                    continue
                if any(not later.barrier for later in pubs[i + 1:]):
                    yield Finding(
                        self.id,
                        fo.relpath,
                        op.line,
                        f"{fo.name} writes a publication barrier (CRC "
                        "sidecar / pointer / head doc) before the data it "
                        "covers — a crash between the two leaves a barrier "
                        "naming bytes that never landed; publish the data "
                        "first, the barrier last",
                    )
