"""CUDA launch-safety rules (the device-side rule pack).

The port's counterpart of ``lakesoul_tpu/analysis/rules/jaxtpu.py``.  The
reference guarded jit/pallas-traced code; this package's device half is
hand-written CUDA C++ behind ``ctypes`` (``csrc/*.cu``, built by
``_build.py``), and its failure modes are as silent: an ``argtypes`` list
one argument short shifts every later argument into the wrong register; a
float64 tensor handed to a ``float*`` parameter is read as garbage floats;
a data-dependent length breaks the shape-bucketing contract; a host sync
inside a delivery or a kernel wrapper stalls the copy stream behind the
device; and a raw C entry called from elsewhere skips its wrapper's device,
contiguity and bounds checks and its launch counter.  One rule for each,
each the counterpart of one reference rule:

============================  ==========================
``kernel-abi``                ``pallas-blockspec``
``device-host-sync``          ``trace-host-sync``
``kernel-dtype-width``        ``tpu-dtype-width``
``launch-shape-unbucketed``   ``jit-static-arg-shape``
``kernel-raw-entry``          ``trace-impure-call``
============================  ==========================

Everything here keys off the **device index** built once per project
(:func:`device_index`), reading text and never importing:

- **entries** — the ``extern "C"`` functions of every ``csrc/*.cu`` beside
  the linted modules: parameters (pointer or scalar, and the scalar's
  width) and, where the body casts a parameter
  (``static_cast<const float*>(q)``), the element type it reads;
- **bindings** — the ``ctypes`` argument lists bound to them: a table of
  ``{"ls_entry": ("source", [argtypes])}`` (``vector/kernels.py``), a call
  ``_build.entry(_build.load("source"), "ls_entry", [argtypes])``
  (``annplane/ragged.py``), or a raw ``lib.ls_entry.argtypes = [...]``.
  ``_build.entry`` appends the stream itself, so its lists stop before the
  C function's trailing ``void* stream``;
- **register** — the ``KernelPort`` fields (``tensorplane/smoke.py``):
  each names an entry point and its source;
- **kernel wrappers** — the functions that count their launches
  (``wrapper.launches += 1``);
- **pallas kernels** — the first argument of every ``pl.pallas_call`` in
  the linted tree, so the port can enumerate the reference's kernels
  (:func:`enumerate_pallas_kernels`) without importing it.

The runtime counterpart is :mod:`lakesoul_tpu_torch.analysis.tracecheck`
(``LAKESOUL_TRACECHECK=1``): these rules catch the lexical causes of shape
thrash and rebuilds, the detector whatever survives them.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Project,
    Rule,
    dotted_name,
    walk_stopping_at_functions,
)

# ------------------------------------------------------------ C prototypes

_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_EXTERN_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_C_FUNC = re.compile(r"([A-Za-z_][\w\s\*]*?)\b([A-Za-z_]\w*)\s*\(([^()]*)\)\s*\{")
_C_CAST = re.compile(r"static_cast<\s*(?:const\s+)?(\w+)\s*\*\s*>\s*\(\s*(\w+)\s*\)")

# element type named in a cast -> the tensor dtype it reads
_C_ELEMENT = {
    "float": "float32", "double": "float64", "int": "int32", "int32_t": "int32",
    "int64_t": "int64", "uint8_t": "uint8", "bool": "bool",
}
_C_SCALARS = {
    "int64_t": "i64", "long long": "i64", "ptrdiff_t": "i64", "int": "i32",
    "int32_t": "i32", "unsigned": "u32", "unsigned int": "u32", "uint32_t": "u32",
    "size_t": "u64", "uint64_t": "u64", "float": "f32", "double": "f64", "bool": "bool",
}
_CTYPES_KINDS = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_int64": "i64", "c_longlong": "i64",
    "c_ssize_t": "i64", "c_int": "i32", "c_int32": "i32", "c_uint": "u32",
    "c_uint32": "u32", "c_size_t": "u64", "c_uint64": "u64", "c_ulonglong": "u64",
    "c_float": "f32", "c_double": "f64", "c_bool": "bool",
}
_KIND_WORDS = {
    "ptr": "a pointer", "i64": "int64_t", "i32": "int", "u32": "unsigned int",
    "u64": "size_t", "f32": "float", "f64": "double", "bool": "bool",
}


def _c_kind(ctype: str) -> str | None:
    if "*" in ctype:
        return "ptr"
    words = [w for w in ctype.split() if w not in ("const", "volatile", "restrict")]
    return _C_SCALARS.get(" ".join(words))


@dataclass(frozen=True)
class CEntry:
    """One ``extern "C"`` function of a kernel source."""

    name: str
    source: str  # repo-relative path of the .cu file
    line: int
    params: tuple  # ((kind or None, C type, name), ...)
    pointee: dict = field(compare=False, hash=False)  # param -> dtype it reads

    @property
    def stem(self) -> str:
        return Path(self.source).stem

    def bound_params(self) -> tuple:
        """The parameters a ``_build.entry`` binding lists: all but the
        trailing stream, which the launcher appends."""
        if self.params and self.params[-1][2] == "stream" and self.params[-1][0] == "ptr":
            return self.params[:-1]
        return self.params


def _blank_comments(text: str) -> str:
    """Comments replaced by spaces, newlines kept (line numbers survive)."""
    return _C_COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)


def _matching_brace(text: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i
    return len(text) - 1


def _parse_entry(text: str, m: re.Match, source: str) -> CEntry | None:
    name, raw_params = m.group(2), m.group(3).strip()
    if m.group(1).strip() in ("if", "for", "while", "switch", "return"):
        return None
    params = []
    if raw_params and raw_params != "void":
        for p in raw_params.split(","):
            p = " ".join(p.split())
            pm = re.match(r"(.*?)([A-Za-z_]\w*)$", p)
            if pm is None:
                return None
            ctype = pm.group(1).strip()
            params.append((_c_kind(ctype), ctype, pm.group(2)))
    body_end = _matching_brace(text, m.end() - 1)
    body = text[m.end():body_end]
    names = {p[2] for p in params}
    pointee = {}
    for cm in _C_CAST.finditer(body):
        if cm.group(2) in names and cm.group(1) in _C_ELEMENT:
            pointee.setdefault(cm.group(2), _C_ELEMENT[cm.group(1)])
    line = text.count("\n", 0, m.start(2)) + 1
    return CEntry(name, source, line, tuple(params), pointee)


def parse_entries(path: Path, relpath: str) -> list[CEntry]:
    """The ``extern "C"`` functions defined in one ``.cu`` file."""
    try:
        text = _blank_comments(path.read_text(encoding="utf-8"))
    except OSError:
        return []
    out = []
    for block in _EXTERN_BLOCK.finditer(text):
        start, end = block.end(), _matching_brace(text, block.end() - 1)
        pos = start
        while True:
            m = _C_FUNC.search(text, pos, end)
            if m is None:
                break
            entry = _parse_entry(text, m, relpath)
            if entry is not None:
                out.append(entry)
            pos = _matching_brace(text, m.end() - 1) + 1
    return out


# ----------------------------------------------------------- python side


@dataclass(frozen=True)
class Binding:
    """One ``ctypes`` argument list bound to a C entry."""

    entry: str
    source: str | None  # the library's source stem ("packed_dot"), if named
    relpath: str
    line: int
    argtypes: tuple | None  # kinds, or None where the list is not literal
    appends_stream: bool  # bound through _build.entry


@dataclass(frozen=True)
class RegisterField:
    """One ``KernelPort`` of the register: the entry point and source."""

    entry_point: str
    source: str  # as written: a repo path or a file name
    relpath: str
    line: int


def _module_ctypes_aliases(mod: Module) -> dict[str, str]:
    """Module-level names bound to ctypes types (``_PTR = ctypes.c_void_p``,
    ``_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64``)."""
    out: dict[str, str] = {}

    def kind_of(expr) -> str | None:
        name = dotted_name(expr) or ""
        return _CTYPES_KINDS.get(name.rsplit(".", 1)[-1]) if name.startswith("ctypes.") \
            or name in _CTYPES_KINDS else None

    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                k = kind_of(node.value)
                if k:
                    out[tgt.id] = k
            elif isinstance(tgt, ast.Tuple) and isinstance(node.value, ast.Tuple):
                for t, v in zip(tgt.elts, node.value.elts):
                    k = kind_of(v)
                    if isinstance(t, ast.Name) and k:
                        out[t.id] = k
    return out


def _eval_argtypes(expr, aliases: dict) -> list | None:
    """Kinds of a literal argtypes expression (lists, ``[x] * n``, ``a + b``),
    or None where it is not literal."""
    if isinstance(expr, (ast.List, ast.Tuple)):
        out: list = []
        for e in expr.elts:
            if isinstance(e, ast.Starred):
                inner = _eval_argtypes(e.value, aliases)
                if inner is None:
                    return None
                out += inner
                continue
            name = dotted_name(e)
            if name is None:
                return None
            kind = aliases.get(name) or _CTYPES_KINDS.get(name.rsplit(".", 1)[-1])
            out.append(kind)
        return out
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        a, b = _eval_argtypes(expr.left, aliases), _eval_argtypes(expr.right, aliases)
        return None if a is None or b is None else a + b
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for lst, n in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                inner = _eval_argtypes(lst, aliases)
                return None if inner is None else inner * n.value
        return None
    return None


def _str(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) \
        else None


def _load_source(expr) -> str | None:
    """``_build.load("source")`` / ``load("source")`` → ``"source"``."""
    if isinstance(expr, ast.Call) and (dotted_name(expr.func) or "").rsplit(".", 1)[-1] \
            == "load" and expr.args:
        return _str(expr.args[0])
    return None


def _collect_bindings(mod: Module) -> list[Binding]:
    aliases = _module_ctypes_aliases(mod)
    out = []
    for node in mod.walk():
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                entry = _str(k) if k is not None else None
                if entry is None or not isinstance(v, ast.Tuple) or len(v.elts) != 2:
                    continue
                src = _str(v.elts[0])
                if src is None or not isinstance(v.elts[1], (ast.List, ast.BinOp)):
                    continue
                kinds = _eval_argtypes(v.elts[1], aliases)
                out.append(Binding(entry, src, mod.relpath, k.lineno,
                                   None if kinds is None else tuple(kinds), True))
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.rsplit(".", 1)[-1] == "entry" and len(node.args) >= 3:
                entry = _str(node.args[1])
                if entry is None:
                    continue
                kinds = _eval_argtypes(node.args[2], aliases)
                out.append(Binding(entry, _load_source(node.args[0]), mod.relpath,
                                   node.lineno, None if kinds is None else tuple(kinds), True))
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and tgt.attr == "argtypes" and \
                        isinstance(tgt.value, ast.Attribute):
                    kinds = _eval_argtypes(node.value, aliases)
                    out.append(Binding(tgt.value.attr, None, mod.relpath, node.lineno,
                                       None if kinds is None else tuple(kinds), False))
    return out


_PORT_SLOTS = ("wrapper", "plain", "counter", "entry_point", "source")


def _port_call_fields(call: ast.Call, slots) -> dict:
    got = {}
    for i, a in enumerate(call.args):
        if i < len(slots):
            got[slots[i]] = a
    for kw in call.keywords:
        if kw.arg:
            got[kw.arg] = kw.value
    return got


def _collect_register(mod: Module) -> list[RegisterField]:
    """``KernelPort(...)`` calls, directly or through a module-local helper
    that forwards its parameters into one (``_port(...)``)."""
    helpers: dict[str, dict] = {}  # helper name -> {role: (param, position)}
    for node in mod.tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        params = [a.arg for a in node.args.args]
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and dotted_name(sub.func) == "KernelPort":
                roles = {}
                fields = _port_call_fields(sub, _PORT_SLOTS)
                for role in ("entry_point", "source"):
                    expr = fields.get(role)
                    names = [n.id for n in ast.walk(expr) if isinstance(n, ast.Name)] \
                        if expr is not None else []
                    for n in names:
                        if n in params:
                            roles[role] = (n, params.index(n))
                if roles:
                    helpers[node.name] = roles
    out = []
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        if fname == "KernelPort":
            fields = {k: _str(v) for k, v in _port_call_fields(node, _PORT_SLOTS).items()}
        elif fname in helpers:
            fields = {}
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            for role, (pname, pos) in helpers[fname].items():
                expr = kw.get(pname, node.args[pos] if pos < len(node.args) else None)
                fields[role] = _str(expr) if expr is not None else None
        else:
            continue
        if fields.get("entry_point") and fields.get("source"):
            out.append(RegisterField(fields["entry_point"], fields["source"], mod.relpath,
                                     node.lineno))
    return out


def _counts_launches(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Attribute) \
                and node.target.attr == "launches":
            return True
    return False


def _unwrap_partial(expr: ast.expr) -> ast.expr:
    if isinstance(expr, ast.Call) and dotted_name(expr.func) in (
            "functools.partial", "partial") and expr.args:
        return expr.args[0]
    return expr


class DeviceIndex:
    """C entries, their bindings, the register, the kernel wrappers and the
    pallas kernels — built ONCE per project and shared by the pack."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.entries: dict[str, list[CEntry]] = {}
        self.bindings: list[Binding] = []
        self.register: list[RegisterField] = []
        self._wrappers: "set[str] | None" = None
        self._pallas: "set[str] | None" = None

    @property
    def wrappers(self) -> set[str]:
        """Qnames of the launch-counting functions (from the call graph,
        built on first use: reading the C side and the bindings needs none)."""
        if self._wrappers is None:
            graph = self.project.callgraph()
            self._wrappers = {q for q, fn in graph.functions.items()
                              if _counts_launches(fn.node)}
        return self._wrappers

    @property
    def pallas_kernels(self) -> set[str]:
        """Qnames of the functions passed to ``pl.pallas_call``."""
        if self._pallas is None:
            graph = self.project.callgraph()
            self._pallas = set()
            for caller_q, edges in graph.edges.items():
                caller = graph.functions.get(caller_q)
                relpath = caller_q.split("::", 1)[0]
                for e in edges:
                    if e.attr != "pallas_call" or not e.node.args:
                        continue
                    ref = dotted_name(_unwrap_partial(e.node.args[0]))
                    q = graph.resolve_reference(relpath, caller, ref) if ref else None
                    if q is not None:
                        self._pallas.add(q)
        return self._pallas

    def entry(self, name: str, source: str | None = None) -> CEntry | None:
        cands = self.entries.get(name, [])
        if source is not None:
            stem = Path(source).stem
            cands = [c for c in cands if c.stem == stem]
        return cands[0] if cands else None

    @classmethod
    def build(cls, project: Project) -> "DeviceIndex":
        idx = cls(project)
        root = Path(project.root).resolve()
        dirs: set[Path] = set()
        for mod in project.modules:
            here = Path(mod.path).resolve().parent
            for d in (here, *here.parents):
                if (d / "csrc").is_dir():
                    dirs.add(d / "csrc")
                if d == root or root not in d.parents:
                    break
        for d in sorted(dirs):
            for cu in sorted(d.glob("*.cu")):
                try:
                    rel = cu.relative_to(root).as_posix()
                except ValueError:
                    rel = cu.as_posix()
                for e in parse_entries(cu, rel):
                    idx.entries.setdefault(e.name, []).append(e)
        for mod in project.modules:
            idx.bindings += _collect_bindings(mod)
            idx.register += _collect_register(mod)
        return idx


def device_index(project: Project) -> DeviceIndex:
    """The per-project device index, built once and shared by the pack
    (same contract as ``Project.callgraph()``)."""
    idx = getattr(project, "_device_index", None)
    if idx is None:
        idx = DeviceIndex.build(project)
        project._device_index = idx
    return idx


# the text every binding, register field and pallas call site carries: a
# module without any of them adds nothing to the entries' side of the index
BINDING_TEXT = ("argtypes", ".entry(", "KernelPort", "pallas_call")


def index_tree(tree: Path | str, root: Path | str | None = None, *,
               text_filter: "tuple[str, ...] | None" = None) -> DeviceIndex:
    """The device index of every ``.py`` file under ``tree`` (text only:
    nothing is imported).  ``text_filter`` parses only the files containing
    one of its strings (:data:`BINDING_TEXT` suffices for the entries,
    bindings and register, not for the call-graph parts)."""
    tree = Path(tree).resolve()
    root = Path(root).resolve() if root is not None else tree.parent
    project = Project(root=root)
    for path in sorted(tree.rglob("*.py")):
        if text_filter is not None:
            try:
                text = path.read_text(encoding="utf-8")
            except OSError:
                continue
            if not any(t in text for t in text_filter):
                continue
        mod = Module.load(path, root)
        if mod is not None:
            project.modules.append(mod)
    return device_index(project)


def enumerate_pallas_kernels(tree: Path | str, root: Path | str | None = None) -> list[str]:
    """Every ``pl.pallas_call`` kernel of a tree, by qname
    (``<relpath>::<function>``), read from its text."""
    return sorted(index_tree(tree, root).pallas_kernels)


def _register_problems(idx: DeviceIndex) -> list[tuple[str, int, str]]:
    """(path, line, message) for each disagreement between the register,
    the bindings and the entries: a register field whose entry point is not
    in its source, an entry with no binding, an entry no register field
    names (only where there is a register)."""
    out = []
    for f in idx.register:
        if idx.entry(f.entry_point, f.source) is None:
            out.append((f.relpath, f.line,
                        f"register entry point {f.entry_point} is no extern \"C\" "
                        f"function of {Path(f.source).name}"))
    bound = {b.entry for b in idx.bindings}
    named = {f.entry_point for f in idx.register}
    for name, cands in sorted(idx.entries.items()):
        for e in cands:
            if name not in bound:
                out.append((e.source, e.line, f"extern \"C\" {name} has no ctypes binding: "
                                              "nothing launches it through a checked wrapper"))
            elif idx.register and name not in named:
                out.append((e.source, e.line, f"extern \"C\" {name} has no register field: the "
                                              "on-card register never holds it against its "
                                              "plain version"))
    return out


def register_problems(idx: DeviceIndex) -> list[str]:
    """What the register, the bindings and ``csrc/`` disagree on, as text
    (``chip_smoke.py``'s ``register`` phase requires none)."""
    return [f"{path}:{line} {message}" for path, line, message in _register_problems(idx)]


def _label(qname: str) -> str:
    return qname.rsplit("::", 1)[-1]


# --------------------------------------------------------------- kernel-abi


class KernelAbiRule(Rule):
    id = "kernel-abi"
    title = "ctypes binding or register field that disagrees with the C entry point"

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = device_index(project)
        for b in idx.bindings:
            entry = idx.entry(b.entry, b.source)
            if entry is None:
                if not b.appends_stream:
                    continue  # a raw binding of a helper, not of a kernel entry
                where = f"{b.source}.cu" if b.source else "any csrc/*.cu"
                yield Finding(self.id, b.relpath, b.line,
                              f"binding of {b.entry} names no extern \"C\" function of {where}")
                continue
            if b.argtypes is None:
                continue
            want = entry.bound_params() if b.appends_stream else entry.params
            if len(b.argtypes) != len(want):
                yield Finding(
                    self.id, b.relpath, b.line,
                    f"binding of {b.entry} lists {len(b.argtypes)} argtypes but "
                    f"{entry.source}:{entry.line} takes {len(want)}"
                    + (" before the stream" if b.appends_stream else "")
                    + " — every later argument lands in the wrong register")
                continue
            for i, (got, (kind, ctype, pname)) in enumerate(zip(b.argtypes, want)):
                if got is None or kind is None or got == kind:
                    continue
                yield Finding(
                    self.id, b.relpath, b.line,
                    f"binding of {b.entry} passes argument {i} ({pname}) as "
                    f"{_KIND_WORDS.get(got, got)} but {entry.source}:{entry.line} "
                    f"declares {ctype}")
        for path, line, message in _register_problems(idx):
            yield Finding(self.id, path, line, message)


# --------------------------------------------------------- device-host-sync

# the device halves of the loader and the replay cache; the kernel wrappers
# join them from the index
_DEVICE_ROOTS = (
    ("data/torch_iter.py", "TorchBatchIterator._put_cuda"),
    ("data/torch_iter.py", "TorchBatchIterator._ready_cuda"),
    ("data/torch_iter.py", "TorchBatchIterator._replayed"),
    ("tensorplane/replay.py", "DeviceReplayCache.*"),
)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_NOT_TENSOR_CALLS = ("torch.device", "torch.dtype", "torch.cuda.", "torch.is_", "torch.numel",
                     "torch.get_", "torch.backends.", "torch.finfo", "torch.iinfo")
_TENSOR_METHODS = frozenset({
    "any", "all", "sum", "max", "min", "amax", "amin", "eq", "ne", "gt", "lt", "ge", "le",
    "isfinite", "isnan", "abs", "mean", "logical_and", "logical_or", "logical_not",
})


def _is_torch_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    return name.startswith("torch.") and not name.startswith(_NOT_TENSOR_CALLS)


def _assigns(fn) -> list:
    """``fn``'s own assignments (not nested functions'), in source order."""
    found = [n for n in walk_stopping_at_functions(fn.body) if isinstance(n, ast.Assign)]
    return sorted(found, key=lambda n: (n.lineno, n.col_offset))


def _tensor_names(fn) -> set[str]:
    """Local names assigned a tensor-valued expression (a ``torch.*`` call,
    or arithmetic over one) in ``fn``."""
    names: set[str] = set()
    for node in _assigns(fn):
        if _tensorish(node.value, names):
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def _tensorish(expr, names: set) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in names
    if _is_torch_call(expr):
        return True
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) and \
            expr.func.attr in _TENSOR_METHODS:
        return _tensorish(expr.func.value, names)
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, names)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, names) or _tensorish(expr.right, names)
    if isinstance(expr, ast.Compare):
        return any(_tensorish(e, names) for e in (expr.left, *expr.comparators))
    if isinstance(expr, ast.BoolOp):
        return any(_tensorish(e, names) for e in expr.values)
    return False


class DeviceHostSyncRule(Rule):
    id = "device-host-sync"
    title = "host sync inside a delivery to the card, the replay cache or a kernel wrapper"

    def __init__(self, roots: tuple = _DEVICE_ROOTS):
        self.roots = roots

    def _root_qnames(self, graph, idx) -> dict[str, str]:
        out = {q: "kernel wrapper" for q in idx.wrappers}
        for suffix, name in self.roots:
            for fn in graph.functions_in((suffix,)):
                if fn.name == name or (name.endswith(".*") and
                                       fn.name.startswith(name[:-1])):
                    out.setdefault(fn.qname, f"{fn.name} (device half)")
        return out

    def finalize(self, project: Project) -> Iterable[Finding]:
        graph = project.callgraph()
        idx = device_index(project)
        reach: dict[str, str] = {}
        for q, why in self._root_qnames(graph, idx).items():
            reach.setdefault(q, why)
            for callee in graph.reachable(q, 4):
                reach.setdefault(callee, f"reached from {_label(q)}")
        for q, why in sorted(reach.items()):
            fn = graph.functions.get(q)
            if fn is None:
                continue
            tensors = _tensor_names(fn.node)
            label = _label(q)
            for node in walk_stopping_at_functions(fn.node.body):
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func) or ""
                    if name in _SYNC_CALLS:
                        yield Finding(self.id, fn.relpath, node.lineno,
                                      f"{name}() inside {label} ({why}) blocks the host "
                                      "until the device drains")
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _SYNC_METHODS and not node.args:
                        yield Finding(self.id, fn.relpath, node.lineno,
                                      f".{node.func.attr}() inside {label} ({why}) copies a "
                                      "device value to the host and waits for it")
                    elif name == "bool" and node.args and _tensorish(node.args[0], tensors):
                        yield Finding(self.id, fn.relpath, node.lineno,
                                      f"bool(tensor) inside {label} ({why}) reads the "
                                      "value back to the host")
                test = None
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    test = node.test
                elif isinstance(node, ast.Assert):
                    test = node.test
                if test is not None and _tensorish(test, tensors):
                    yield Finding(self.id, fn.relpath, node.lineno,
                                  f"a tensor used as a truth value inside {label} ({why}) "
                                  "reads the value back to the host")


# ------------------------------------------------------- kernel-dtype-width

_TORCH_DTYPES = {
    "torch.float64": "float64", "torch.double": "float64", "torch.float32": "float32",
    "torch.float": "float32", "torch.int64": "int64", "torch.long": "int64",
    "torch.int32": "int32", "torch.int": "int32", "torch.uint8": "uint8",
    "torch.bool": "bool", "torch.float16": "float16", "torch.bfloat16": "bfloat16",
    "np.float64": "float64", "np.int64": "int64", "np.float32": "float32",
    "np.int32": "int32", "numpy.float64": "float64", "numpy.int64": "int64",
}
_DTYPE_METHODS = {"double": "float64", "float": "float32", "long": "int64", "int": "int32",
                  "half": "float16", "bfloat16": "bfloat16", "bool": "bool"}
_WIDTH_CHECKED = {"float32", "int32"}


def _dtype_of(expr, known: dict) -> str | None:
    """The dtype an expression evidently has: an explicit ``dtype=``, a
    cast (``.double()``, ``.to(torch.float64)``, ``.astype(np.int64)``), a
    torch default (``torch.arange`` is int64), or a name assigned one."""
    if isinstance(expr, ast.Name):
        return known.get(expr.id)
    if not isinstance(expr, ast.Call):
        return None
    for kw in expr.keywords:
        if kw.arg == "dtype":
            return _TORCH_DTYPES.get(dotted_name(kw.value) or "")
    name = dotted_name(expr.func) or ""
    if isinstance(expr.func, ast.Attribute):
        attr = expr.func.attr
        if attr in _DTYPE_METHODS and not expr.args:
            return _DTYPE_METHODS[attr]
        if attr in ("to", "type", "astype") and expr.args:
            got = _TORCH_DTYPES.get(dotted_name(expr.args[0]) or "")
            if got:
                return got
        if attr in ("contiguous", "clone", "cuda", "to", "detach"):
            return _dtype_of(expr.func.value, known)
    if name in ("torch.arange", "torch.randint", "torch.argsort", "torch.argmax",
                "torch.argmin", "torch.nonzero"):
        return "int64"
    if name in ("torch.from_numpy", "torch.as_tensor", "torch.tensor") and expr.args:
        return _dtype_of(expr.args[0], known)
    return None


def _launcher_entries(mod: Module, idx: DeviceIndex) -> dict[str, str | None]:
    """Module-local launcher factories: function name -> the entry it binds
    (None: the entry is the launcher's string argument)."""
    out: dict[str, str | None] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and (dotted_name(sub.func) or "").rsplit(
                    ".", 1)[-1] == "entry" and len(sub.args) >= 2:
                lit = _str(sub.args[1])
                out[node.name] = lit if lit in idx.entries else None
    return out


class KernelDtypeWidthRule(Rule):
    id = "kernel-dtype-width"
    title = "a 64-bit tensor reaching a float* or int32_t* kernel parameter"

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = device_index(project)
        if not idx.entries:
            return
        for mod in project.modules:
            launchers = _launcher_entries(mod, idx)
            if not launchers:
                continue
            for fn in ast.walk(mod.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_fn(mod, fn, launchers, idx)

    def _check_fn(self, mod, fn, launchers, idx):
        known: dict[str, str] = {}
        for node in _assigns(fn):
            if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                got = _dtype_of(node.value, known)
                if got:
                    known[node.targets[0].id] = got
        for node in walk_stopping_at_functions(fn.body):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)):
                continue
            inner = node.func
            lname = dotted_name(inner.func)
            if lname not in launchers:
                continue
            entry_name = launchers[lname] or (_str(inner.args[0]) if inner.args else None)
            entry = idx.entry(entry_name) if entry_name else None
            if entry is None:
                continue
            params = entry.bound_params()
            for arg, (_kind, ctype, pname) in zip(node.args[1:], params):
                want = entry.pointee.get(pname)
                if want not in _WIDTH_CHECKED:
                    continue
                tensor = arg.func.value if (isinstance(arg, ast.Call) and isinstance(
                    arg.func, ast.Attribute) and arg.func.attr == "data_ptr") else None
                got = _dtype_of(tensor, known) if tensor is not None else None
                if got and got != want and got in ("float64", "int64"):
                    yield Finding(
                        self.id, mod.relpath, node.lineno,
                        f"{dotted_name(tensor) or 'tensor'} is {got} but {entry.name} "
                        f"reads {pname} as {want} ({entry.source}:{entry.line}) — the "
                        "kernel reinterprets its bytes; cast before the launch")


# -------------------------------------------------- launch-shape-unbucketed

_BUCKET_CALLS = frozenset({"_pow2_bucket", "_pad_tail", "next_pow2"})
_DATA_DEPENDENT_CALLS = frozenset({
    "torch.nonzero", "torch.unique", "torch.masked_select", "torch.unique_consecutive",
    "np.nonzero", "np.unique", "np.flatnonzero", "numpy.nonzero", "numpy.unique",
})


def _calls_any(expr, names) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            dn = dotted_name(n.func) or ""
            if dn in names or dn.rsplit(".", 1)[-1] in names:
                return True
    return False


def _data_dependent(expr, masks: set, dep: dict) -> str | None:
    """Why ``expr`` has a data-dependent length, or None (``dep``: names
    already known to, with the reason)."""
    if isinstance(expr, ast.Name):
        return dep.get(expr.id)
    if isinstance(expr, ast.Subscript):
        sl = expr.slice
        if isinstance(sl, ast.Compare) or (isinstance(sl, ast.Name) and sl.id in masks):
            return "boolean-mask indexing"
        if isinstance(sl, ast.Call) and (dotted_name(sl.func) or "") in _DATA_DEPENDENT_CALLS:
            return "index by a data-dependent selection"
    if isinstance(expr, ast.Call):
        dn = dotted_name(expr.func) or ""
        if dn in _DATA_DEPENDENT_CALLS or (isinstance(expr.func, ast.Attribute) and
                                           expr.func.attr in ("nonzero", "unique")):
            return f"{dn or expr.func.attr}(...)"
        if isinstance(expr.func, ast.Attribute) and expr.func.attr in ("contiguous", "clone"):
            return _data_dependent(expr.func.value, masks, dep)
    return None


class LaunchShapeUnbucketedRule(Rule):
    id = "launch-shape-unbucketed"
    title = "data-dependent length reaching a bucketed search body without _pow2_bucket"

    def finalize(self, project: Project) -> Iterable[Finding]:
        graph = project.callgraph()
        # bucketed bodies: callees that some caller hands a padded argument
        bucketed: set[str] = set()
        for caller_q, edges in graph.edges.items():
            fn = graph.functions.get(caller_q)
            if fn is None:
                continue
            padded = set()
            for node in _assigns(fn.node):
                if _calls_any(node.value, _BUCKET_CALLS):
                    padded |= {n.id for t in node.targets for n in ast.walk(t)
                               if isinstance(n, ast.Name)}
            for e in edges:
                if e.callee is None:
                    continue
                args = [*e.node.args, *(k.value for k in e.node.keywords)]
                if any((isinstance(a, ast.Name) and a.id in padded) or
                       _calls_any(a, _BUCKET_CALLS) for a in args):
                    bucketed.add(e.callee)
        for caller_q, edges in graph.edges.items():
            fn = graph.functions.get(caller_q)
            if fn is None:
                continue
            masks: set[str] = set()
            dep: dict[str, str] = {}
            for node in _assigns(fn.node):
                names = {n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)}
                why = _data_dependent(node.value, masks, dep)
                if isinstance(node.value, ast.Compare):
                    masks |= names
                elif _calls_any(node.value, _BUCKET_CALLS):
                    for n in names:
                        dep.pop(n, None)
                elif why:
                    dep.update(dict.fromkeys(names, why))
            for e in edges:
                if e.callee not in bucketed:
                    continue
                for a in [*e.node.args, *(k.value for k in e.node.keywords)]:
                    why = _data_dependent(a, masks, dep)
                    if why:
                        yield Finding(
                            self.id, fn.relpath, e.line,
                            f"{_label(e.callee)} is a bucketed search body but "
                            f"{_label(caller_q)} hands it {why} — every distinct length "
                            "is a new shape; pad to a bucketed size (_pow2_bucket + "
                            "_pad_tail) first")
                        break


# --------------------------------------------------------- kernel-raw-entry


class KernelRawEntryRule(Rule):
    id = "kernel-raw-entry"
    title = "a C entry point bound or called outside its wrapper's module"

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = device_index(project)
        if not idx.entries:
            return
        # an entry's home: the module that binds it through _build.entry,
        # preferring one whose wrappers count launches
        with_wrappers = {q.split("::", 1)[0] for q in idx.wrappers}
        home: dict[str, str] = {}
        for b in sorted(idx.bindings, key=lambda b: (b.relpath not in with_wrappers,
                                                     b.relpath, b.line)):
            if b.appends_stream:
                home.setdefault(b.entry, b.relpath)
        for b in idx.bindings:
            if b.entry in idx.entries and home.get(b.entry) not in (None, b.relpath):
                yield Finding(self.id, b.relpath, b.line,
                              f"{b.entry} is bound again outside {home[b.entry]} — its "
                              "launches skip the wrapper's checks and launch counter")
            elif b.entry in idx.entries and not b.appends_stream:
                yield Finding(self.id, b.relpath, b.line,
                              f"{b.entry} is bound raw (lib.{b.entry}.argtypes) — bind it "
                              "once through _build.entry in its wrapper's module")
        for mod in project.modules:
            register_args: set[int] = set()
            for node in mod.walk():
                if isinstance(node, ast.Call) and dotted_name(node.func) in (
                        "KernelPort", "_port"):
                    register_args |= {id(n) for n in ast.walk(node)}
            for node in mod.walk():
                if id(node) in register_args:
                    continue
                name = None
                if isinstance(node, ast.Attribute) and node.attr in idx.entries and \
                        not isinstance(getattr(node, "ctx", None), ast.Store):
                    name = node.attr
                elif isinstance(node, ast.Call):
                    for a in node.args:
                        lit = _str(a)
                        if lit in idx.entries:
                            name = lit
                if name is None or home.get(name) in (None, mod.relpath):
                    continue
                yield Finding(self.id, mod.relpath, node.lineno,
                              f"{name} is reached outside its wrapper's module "
                              f"{home[name]} — call the wrapper, which checks the device "
                              "and contiguity and counts the launch")


def device_rules() -> list[Rule]:
    """The device pack, in the order ``all_rules()`` lists it (last)."""
    return [KernelAbiRule(), DeviceHostSyncRule(), KernelDtypeWidthRule(),
            LaunchShapeUnbucketedRule(), KernelRawEntryRule()]
