"""lakelint rule catalog.

Every rule encodes one invariant this codebase has already been burned by
(or will be at production scale).  The catalog, with rationale, lives in
ARCHITECTURE.md §Analysis; adding a rule = subclass
:class:`~lakesoul_tpu_torch.analysis.engine.Rule` in a module here and list it in
:func:`all_rules`.

Two generations: the per-function rules (``check(module)`` over one
file's shared AST) and the interprocedural rules (``finalize(project)``
over the shared project call graph — ``Project.callgraph()``).  On top of
those ride the themed packs — concurrency (thread-root locksets + buffer
lifetimes), durability (atomic publication), isolation (READ COMMITTED
portability), boundedness (resource budgets + thread/child/scratch
lifecycles), and the device pack (CUDA launch safety: C ABI, host syncs,
dtype widths, shape buckets, raw entries — the counterpart of the
reference's five jit/pallas rules) — 40 rules total.
"""

from __future__ import annotations

from lakesoul_tpu_torch.analysis.engine import Rule

from lakesoul_tpu_torch.analysis.rules.concurrency import (
    LockHeldCallRule,
    RawThreadRule,
    SqliteScopeRule,
    TransitiveLockHeldCallRule,
)
from lakesoul_tpu_torch.analysis.rules.conventions import (
    MetricNameRule,
    UndocumentedEnvRule,
)
from lakesoul_tpu_torch.analysis.rules.determinism import StageNondeterminismRule
from lakesoul_tpu_torch.analysis.rules.device import device_rules
from lakesoul_tpu_torch.analysis.rules.durability import (
    BarrierOrderRule,
    TornPublishRule,
    UnfsyncedRenameRule,
)
from lakesoul_tpu_torch.analysis.rules.boundedness import (
    ChildReapRule,
    ShmDebrisRule,
    ThreadLifecycleRule,
    UnboundedGrowthRule,
    UnboundedQueueRule,
)
from lakesoul_tpu_torch.analysis.rules.endpoint import HardcodedEndpointRule
from lakesoul_tpu_torch.analysis.rules.identity import FleetIdentityLabelRule
from lakesoul_tpu_torch.analysis.rules.isolation import (
    CasGuardRule,
    ReadModifyWriteRule,
    SqliteIsmRule,
    TxnBoundaryRule,
)
from lakesoul_tpu_torch.analysis.rules.lifetime import (
    RingAliasingRule,
    ViewEscapesReleaseRule,
)
from lakesoul_tpu_torch.analysis.rules.loops import UnstoppableLoopRule
from lakesoul_tpu_torch.analysis.rules.perf import HotPathMaterializeRule
from lakesoul_tpu_torch.analysis.rules.process import RawProcessRule
from lakesoul_tpu_torch.analysis.rules.races import (
    RacyCheckThenActRule,
    SharedStateRaceRule,
)
from lakesoul_tpu_torch.analysis.rules.replay import ReplayHostRoundtripRule
from lakesoul_tpu_torch.analysis.rules.resources import (
    InterproceduralUnclosedReaderRule,
    UnclosedReaderRule,
)
from lakesoul_tpu_torch.analysis.rules.robustness import AdHocRetryRule
from lakesoul_tpu_torch.analysis.rules.security import (
    RbacGateReachabilityRule,
    TaintPathSegmentsRule,
)
from lakesoul_tpu_torch.analysis.rules.wallclock import WallClockLeaseRule

__all__ = ["all_rules", "rule_ids"]


def all_rules() -> list[Rule]:
    return [
        # per-function
        RawThreadRule(),
        LockHeldCallRule(),
        StageNondeterminismRule(),
        UnclosedReaderRule(),
        UndocumentedEnvRule(),
        MetricNameRule(),
        SqliteScopeRule(),
        AdHocRetryRule(),
        WallClockLeaseRule(),
        HotPathMaterializeRule(),
        RawProcessRule(),
        UnstoppableLoopRule(),
        ReplayHostRoundtripRule(),
        FleetIdentityLabelRule(),
        HardcodedEndpointRule(),
        # interprocedural (call graph + dataflow)
        RbacGateReachabilityRule(),
        TaintPathSegmentsRule(),
        TransitiveLockHeldCallRule(),
        InterproceduralUnclosedReaderRule(),
        # concurrency-soundness pack (thread roots + locksets + lifetimes)
        SharedStateRaceRule(),
        RacyCheckThenActRule(),
        ViewEscapesReleaseRule(),
        RingAliasingRule(),
        # durability pack (atomic-publication discipline)
        TornPublishRule(),
        UnfsyncedRenameRule(),
        BarrierOrderRule(),
        # isolation pack (READ COMMITTED portability of the metadata path)
        CasGuardRule(),
        ReadModifyWriteRule(),
        TxnBoundaryRule(),
        SqliteIsmRule(),
        # boundedness pack (resource budgets + lifecycles for soak runs)
        UnboundedQueueRule(),
        UnboundedGrowthRule(),
        ThreadLifecycleRule(),
        ChildReapRule(),
        ShmDebrisRule(),
        # device pack (CUDA launch safety over csrc/ and its ctypes bindings)
        *device_rules(),
    ]


def rule_ids() -> list[str]:
    return [r.id for r in all_rules()]
