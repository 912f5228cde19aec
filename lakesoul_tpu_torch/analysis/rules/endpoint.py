"""``hardcoded-endpoint``: connection endpoints come from config, not code.

The fleet plane made the process topology multi-host: gateways, workers,
autoscalers and trainers find each other through configuration (CLI args,
``LAKESOUL_*`` env vars, handle documents printed by the service role).  A
literal ``host:port`` — ``"grpc://10.0.0.5:8815"``, ``"localhost:9090"``
— baked into code is a deployment assumption that survives exactly one
machine: the moment a worker runs on another host, the literal silently
points at the wrong (or no) process, and no amount of fleet negotiation
can route around an address that never entered the config surface.

Flagged: a string literal (including f-string fragments that form one)
that names a concrete endpoint —

- a URI with an authority and a NONZERO port (``scheme://host:port``);
- a bare ``host:port`` where the host is an IPv4 address, a dotted
  hostname, or ``localhost``;
- any ``localhost`` / loopback-IP URI, with or without a port.

Allowed:

- port ``0`` (``"grpc://127.0.0.1:0"`` — "bind me anywhere", the
  ephemeral-port idiom every service entry uses for tests);
- docstrings (protocol documentation legitimately spells
  ``grpc://host:port``);
- literals that are the DEFAULT of an env lookup
  (``os.environ.get("LAKESOUL_X", "localhost:9090")``) — that IS config
  resolution: the operator can override it without a code change.

Everything else needs an inline pragma naming why the address is truly
invariant — endpoints should be loud in review.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule

# scheme://host:port (port captured; optional path suffix)
_URI_PORT_RE = re.compile(
    r"^[a-z][a-z0-9+.-]*://(?P<host>[^/:@\s]+):(?P<port>\d{1,5})(?:/\S*)?$"
)
# scheme://localhost-ish (no port needed — the host alone is the problem)
_URI_LOOPBACK_RE = re.compile(
    r"^[a-z][a-z0-9+.-]*://(?:localhost|127\.0\.0\.1|\[?::1\]?)(?:[:/]\S*)?$",
    re.IGNORECASE,
)
# bare host:port where the host is unambiguously a network endpoint:
# IPv4, a dotted hostname, or localhost (a lone word:digits like
# "attempt:3" is a label, not an address)
_BARE_HOSTPORT_RE = re.compile(
    r"^(?P<host>(?:\d{1,3}(?:\.\d{1,3}){3}"
    r"|[A-Za-z0-9-]+(?:\.[A-Za-z0-9-]+)+"
    r"|localhost)):(?P<port>\d{1,5})$",
    re.IGNORECASE,
)


def _endpoint_in(text: str) -> "str | None":
    """The offending endpoint spelling, or None if the text is clean."""
    m = _URI_PORT_RE.match(text)
    if m:
        # port 0 is "bind me anywhere" — sanctioned even on loopback
        return text if int(m.group("port")) != 0 else None
    if _URI_LOOPBACK_RE.match(text):
        return text
    m = _BARE_HOSTPORT_RE.match(text)
    if m and int(m.group("port")) != 0:
        return text
    return None


def _docstring_constants(tree: ast.AST) -> "set[int]":
    """ids of Constant nodes that are docstrings (module/class/function)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            continue
        body = getattr(node, "body", [])
        if (
            body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            out.add(id(body[0].value))
    return out


def _is_env_default(node: ast.AST, parents: dict) -> bool:
    """Is this literal an argument of an env lookup (``os.environ.get`` /
    ``os.getenv``)?  That literal is the config surface's DEFAULT — the
    sanctioned home for a fallback endpoint."""
    cur = parents.get(node)
    hops = 0
    while cur is not None and hops < 3:
        if isinstance(cur, ast.Call):
            f = cur.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            return name in ("get", "getenv")
        cur = parents.get(cur)
        hops += 1
    return False


class HardcodedEndpointRule(Rule):
    id = "hardcoded-endpoint"
    title = "literal network endpoint outside config/env resolution"

    def check(self, module: Module) -> Iterable[Finding]:
        docstrings = _docstring_constants(module.tree)
        parents = module.parents()
        for node in module.walk():
            if not (
                isinstance(node, ast.Constant) and isinstance(node.value, str)
            ):
                continue
            if id(node) in docstrings:
                continue
            endpoint = _endpoint_in(node.value)
            if endpoint is None:
                continue
            if _is_env_default(node, parents):
                continue
            yield Finding(
                self.id,
                module.relpath,
                node.lineno,
                f"hardcoded endpoint {endpoint!r}; resolve it through"
                " configuration (CLI arg, LAKESOUL_* env var, or a service"
                " handle) so the fleet can be re-homed without a code"
                " change",
            )
