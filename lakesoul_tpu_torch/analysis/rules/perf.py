"""``hot-path-materialize``: intermediate table materializations are banned
in the scan/loader hot-path modules.

The zero-copy scan path closed its efficiency gap by deleting exactly
these: the rebatcher's ``pa.concat_tables`` per window (rebuilt a table of
everything buffered for every pop), the collate's per-column
``combine_chunks`` (a full copy per window), and the general class of
"make a big table so the next line can slice it".  The zero-copy
discipline that replaced them — chunk slice descriptors,
``Table.from_batches`` over zero-copy slices, direct view→buffer memcpys —
only survives if new code can't quietly reintroduce a materialization
later on.

Flagged calls, anywhere in the hot-path modules (``data/torch_iter.py``,
``io/reader.py``, ``io/streaming_merge.py``):

- ``concat_tables(...)`` (any qualification) — chunk-list concat is cheap,
  but every historical regression started as "just concat the pending
  tables"; the survivors are pragma'd with their zero-copy justification.
- ``.combine_chunks()`` — a full buffer copy of the receiver.
- ``.to_pandas()`` — a full copy *and* a pandas dependency on the hot path.

Sites that are allowed to materialize (a bounded remainder copy that unpins
decoded parents, a zero-copy chunk-list append) carry an inline
``# lakelint: ignore[hot-path-materialize] <reason>`` pragma, so every
exception is justified in place.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule, dotted_name

SCOPE = ("data/torch_iter.py", "io/reader.py", "io/streaming_merge.py")

_METHODS = ("combine_chunks", "to_pandas")


class HotPathMaterializeRule(Rule):
    id = "hot-path-materialize"
    title = "intermediate table materialization in the scan/loader hot path"

    def __init__(self, scope: tuple[str, ...] = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(module.relpath.endswith(s) for s in self.scope):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            callee = None
            name = dotted_name(node.func)
            if name is not None and name.split(".")[-1] == "concat_tables":
                callee = "concat_tables()"
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
                f"{callee} materializes an intermediate table in the"
                " scan/loader hot path — use zero-copy chunk slices"
                " (Table.from_batches over slices, window descriptors,"
                " view→buffer copies) or move the copy off the hot path;"
                " a justified exception needs an inline pragma",
            )
