"""lakelint: project-native static analysis of ``lakesoul_tpu_torch``.

The port of the reference package's static half.  It imports only the
standard library (``ast``), keeps the reference's rule ids, messages,
pragma form (``# lakelint: ignore[<rule>] <reason>``), baseline format and
CLI contract, and aims every package scope at this package.

- :mod:`engine` + :mod:`rules` — AST lint over the package with
  project-specific rules (thread discipline, lock-held blocking calls,
  stage determinism, reader lifetimes, env-var docs, metric naming, sqlite
  scope), a checked-in ``baseline.json`` and inline
  ``# lakelint: ignore[rule]`` pragmas.  CLI:
  ``python -m lakesoul_tpu_torch.analysis`` (also the console's ``lint``
  command); CI gate: ``tests/test_torch_analysis_clean.py``.
- :mod:`callgraph` + :mod:`dataflow` — the interprocedural layer: a
  project-wide call graph (conservative unknown edges for dynamic
  dispatch) and a forward taint framework, powering the whole-program
  rules (``rbac-gate-reachability``, ``taint-path-segments``,
  ``transitive-lock-held-call``, ``interprocedural-unclosed-reader``).
  Output/CI upgrades ride along: ``--format sarif`` (:mod:`sarif`) and the
  diff-aware ``--diff BASE`` gate (:mod:`gitdiff`).
- :mod:`threadroots` + :mod:`rules.races` + :mod:`rules.lifetime` — the
  concurrency-soundness pack: thread-root inference over the call graph
  (Thread targets, pool submissions, pipeline stages, ``do_*`` handlers)
  feeding Eraser-style static locksets (``shared-state-race``,
  ``racy-check-then-act``) and the zero-copy buffer-lifetime rules
  (``view-escapes-release``, ``ring-aliasing``).
- :mod:`rules.durability`, :mod:`rules.isolation` (over :mod:`sqlinfo`)
  and :mod:`rules.boundedness` — atomic publication, READ COMMITTED
  portability of the metadata path, and resource budgets + lifecycles.
- :mod:`rules.device` — the device pack, the counterpart of the
  reference's jit/pallas rules: CUDA launch safety over ``csrc/*.cu``, its
  ``ctypes`` bindings and the kernel register (``kernel-abi``,
  ``device-host-sync``, ``kernel-dtype-width``, ``launch-shape-unbucketed``,
  ``kernel-raw-entry``) — 40 rules in all.
- The opt-in runtime detectors, each armed by its variable: lock order
  (:mod:`lockgraph`, ``LAKESOUL_LOCKCHECK``), races and the reuse ring's
  canary (:mod:`racecheck`, ``LAKESOUL_RACECHECK``), leaks
  (:mod:`leakcheck`, ``LAKESOUL_LEAKCHECK``), crash-prefix replay
  (:mod:`fscheck`, ``LAKESOUL_FSCHECK``), transaction replay
  (:mod:`txncheck`, ``LAKESOUL_TXNCHECK``) and shape signatures and kernel
  rebuilds (:mod:`tracecheck`, ``LAKESOUL_TRACECHECK``); :mod:`arm` arms
  them around a test suite by its name.
"""

from lakesoul_tpu_torch.analysis.engine import (
    Baseline,
    EngineError,
    Finding,
    Rule,
    default_baseline_path,
    run,
    run_repo,
)

__all__ = [
    "Baseline",
    "EngineError",
    "Finding",
    "Rule",
    "default_baseline_path",
    "run",
    "run_repo",
]
