"""``stage-nondeterminism``: wall-clock and unseeded randomness are banned
inside the ordered data path.

The runtime pipeline promises byte-identical output between serial and
pipelined execution (benchmarks/micro.py asserts it).  ``time.time()`` is
not monotonic (NTP steps break stage deadlines and latency math — use
``time.monotonic()`` / ``time.perf_counter()``) and the module-global
``random.*`` RNG draws depend on scheduling order across worker threads —
both produce runs that can't be reproduced from a seed, the failure mode
arxiv 2604.21275 ties most pipeline debugging pain to.  Seeded
``random.Random(seed)`` instances (fault injection) remain legal.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule, dotted_name

# the ordered data path: modules whose code runs inside (or schedules)
# pipeline stages where determinism is part of the contract
ORDERED_STAGE_MODULES = (
    "runtime/pipeline.py",
    "runtime/pool.py",
    "runtime/faults.py",
    "io/reader.py",
    "io/streaming_merge.py",
    "io/merge.py",
    "io/page_cache.py",
    "data/torch_iter.py",
    # scan-plane producers: spool segments must be byte-identical no matter
    # which worker produces them, so their code paths stay deterministic
    "scanplane/worker.py",
    "scanplane/spool.py",
)

# random-module calls that draw from the GLOBAL rng; random.Random /
# random.SystemRandom construct an instance and stay allowed
_GLOBAL_RNG_BLOCKLIST_EXEMPT = {"Random", "SystemRandom", "seed"}


class StageNondeterminismRule(Rule):
    id = "stage-nondeterminism"
    title = "time.time()/global random.* inside ordered pipeline stages"

    def __init__(self, scope: tuple[str, ...] = ORDERED_STAGE_MODULES):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(module.relpath.endswith(m) for m in self.scope):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "time.time":
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    "time.time() in an ordered pipeline stage — wall clock "
                    "is not monotonic; use time.monotonic() or "
                    "time.perf_counter()",
                )
            elif (
                name is not None
                and name.startswith("random.")
                and name.split(".", 1)[1] not in _GLOBAL_RNG_BLOCKLIST_EXEMPT
            ):
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    f"{name}(...) draws from the global RNG in an ordered "
                    "pipeline stage — scheduling order changes the stream; "
                    "use a seeded random.Random instance",
                )
