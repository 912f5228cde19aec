"""``raw-process``: ad-hoc process management and raw socket servers are
banned outside the process-topology layers.

Multi-process is a first-class deployment shape: the scan plane
(``scanplane/``) spawns and supervises worker processes, leases serialize
their work, and spool publication makes their crashes recoverable.  That
machinery only holds if process creation stays INSIDE the layers built for
it — a stray ``subprocess.Popen`` in a data-path module is a child nobody
reaps, SIGKILLs, or fences; a hand-rolled ``multiprocessing.Pool`` brings
back the fork-safety and nested-pool hazards ``runtime/pool.py`` exists to
contain; an ad-hoc ``ThreadingHTTPServer`` is a serving surface with no
admission control, no RBAC, and no metrics.

Allowed homes:

- ``scanplane/`` — the process-topology layer itself (worker children,
  supervised spawning);
- ``fleet/`` — the fleet plane (the autoscaler spawns and supervises
  scanplane worker children under its lease);
- ``runtime/`` — the execution runtime (owns parallelism policy);
- the existing serving entries: ``obs/exporter.py`` (the /metrics HTTP
  endpoint) and ``service/storage_proxy.py`` (the storage-proxy HTTP
  server).

Everything else needs an inline pragma naming why (e.g. the native
build's one-shot compiler invocation, the git-diff helper shelling out to
git) — process creation should be loud in review.

Three shapes are flagged:

- ``subprocess`` process creation (``Popen``/``run``/``call``/
  ``check_call``/``check_output``, dotted or from-imported) plus
  ``os.fork``/``os.system``/``os.spawn*``/``os.exec*``;
- any use of ``multiprocessing`` (its Process/Pool/shared memory all
  bypass the topology layer's supervision), flagged at the import;
- raw socket *servers*: ``socketserver.*Server`` / ``*HTTPServer``
  construction, ``socket.create_server``, and ``socket.socket`` whose
  enclosing function also calls ``.listen(...)`` (a bare client socket —
  connect-and-talk — stays legal); serving sockets belong behind the
  Flight gateway or the sanctioned HTTP entries.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule, dotted_name

# module-path fragments where process/socket primitives are legitimate
_ALLOWED = (
    "/scanplane/",
    "/fleet/",
    "/runtime/",
    "obs/exporter.py",
    "service/storage_proxy.py",
)

_SUBPROCESS_CALLS = {
    "subprocess.Popen", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
}
# bare names that from-imports commonly bind; only flagged when the module
# imports them FROM subprocess (tracked below)
_SUBPROCESS_NAMES = {"Popen", "run", "call", "check_call", "check_output"}

_OS_PROCESS_CALLS = {"os.fork", "os.forkpty", "os.system"}
_OS_PROCESS_PREFIXES = ("os.spawn", "os.exec", "os.posix_spawn")

_SERVER_CALLS = {"socket.create_server"}
_SERVER_SUFFIXES = ("HTTPServer", "TCPServer", "UDPServer", "UnixStreamServer")


def _is_server_ctor(name: str) -> bool:
    if name in _SERVER_CALLS:
        return True
    last = name.rsplit(".", 1)[-1]
    # class-shaped names ending in a server suffix: HTTPServer,
    # ThreadingHTTPServer, socketserver.TCPServer, ...
    return bool(last) and last[0].isupper() and any(
        last.endswith(s) for s in _SERVER_SUFFIXES
    )


def _function_listens(module: Module, node: ast.AST) -> bool:
    """Whether the function lexically enclosing ``node`` calls
    ``.listen(...)`` anywhere — the serving half of a raw socket; a
    client socket (connect-and-talk) never listens."""
    parents = module.parents()
    fn = node
    while fn is not None and not isinstance(
        fn, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        fn = parents.get(fn)
    scope = fn if fn is not None else module.tree
    for sub in ast.walk(scope):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "listen"
        ):
            return True
    return False


class RawProcessRule(Rule):
    id = "raw-process"
    title = (
        "ad-hoc subprocess/multiprocessing/socket server outside the"
        " process-topology layers"
    )

    def __init__(self, allowed: tuple[str, ...] = _ALLOWED):
        self.allowed = allowed

    def check(self, module: Module) -> Iterable[Finding]:
        rel = module.relpath
        if any(a in rel for a in self.allowed):
            return
        from_subprocess: set[str] = set()
        for node in module.walk():
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                yield from self._check_import(module, node, from_subprocess)
            elif isinstance(node, ast.Call):
                yield from self._check_call(module, node, from_subprocess)

    def _check_import(self, module, node, from_subprocess) -> Iterable[Finding]:
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".", 1)[0]
                if root == "multiprocessing":
                    yield Finding(
                        self.id, module.relpath, node.lineno,
                        "multiprocessing bypasses the scan-plane/runtime "
                        "process topology (supervised spawning, leases, "
                        "fork safety); spawn real service entries instead",
                    )
        else:  # ImportFrom
            mod = node.module or ""
            root = mod.split(".", 1)[0]
            if root == "multiprocessing":
                yield Finding(
                    self.id, module.relpath, node.lineno,
                    "multiprocessing bypasses the scan-plane/runtime "
                    "process topology (supervised spawning, leases, fork "
                    "safety); spawn real service entries instead",
                )
            elif root == "subprocess":
                for alias in node.names:
                    if alias.name in _SUBPROCESS_NAMES:
                        from_subprocess.add(alias.asname or alias.name)

    def _check_call(self, module, node, from_subprocess) -> Iterable[Finding]:
        name = dotted_name(node.func)
        if name is None:
            return
        if name.startswith("multiprocessing."):
            yield Finding(
                self.id, module.relpath, node.lineno,
                f"{name}(...) bypasses the scan-plane/runtime process "
                "topology (supervised spawning, leases, fork safety); "
                "spawn real service entries instead",
            )
        elif name in _SUBPROCESS_CALLS or name in from_subprocess:
            yield Finding(
                self.id, module.relpath, node.lineno,
                f"{name}(...) creates an unsupervised child process; "
                "process spawning lives in scanplane//runtime/ (leased, "
                "reaped, chaos-tested) — or justify with a pragma",
            )
        elif name in _OS_PROCESS_CALLS or any(
            name.startswith(p) for p in _OS_PROCESS_PREFIXES
        ):
            yield Finding(
                self.id, module.relpath, node.lineno,
                f"{name}(...) forks/execs outside the process-topology "
                "layers; route through a supervised service entry",
            )
        elif _is_server_ctor(name) or (
            name == "socket.socket" and _function_listens(module, node)
        ):
            yield Finding(
                self.id, module.relpath, node.lineno,
                f"{name}(...) opens a raw serving socket with no admission "
                "control/RBAC/metrics; serve through the Flight gateway or "
                "the sanctioned HTTP entries (obs/exporter.py, "
                "service/storage_proxy.py)",
            )
