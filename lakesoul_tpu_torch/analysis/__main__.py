"""lakelint CLI.

::

    python -m lakesoul_tpu_torch.analysis                  # lint the package
    python -m lakesoul_tpu_torch.analysis --format json    # machine-readable
    python -m lakesoul_tpu_torch.analysis --format sarif   # SARIF 2.1.0 log
    python -m lakesoul_tpu_torch.analysis --sarif          # alias for the above
    python -m lakesoul_tpu_torch.analysis --rule raw-thread --rule sqlite-scope
    python -m lakesoul_tpu_torch.analysis --diff origin/main   # changed lines only
    python -m lakesoul_tpu_torch.analysis path/to/file.py  # lint specific paths
    python -m lakesoul_tpu_torch.analysis --write-baseline # absorb current findings

Exit status contract (mirrored by the console ``lint`` command and relied
on by CI): 0 = no unsuppressed findings, 1 = findings, 2 = the analyzer
itself failed (unknown --rule id, unreadable baseline, git diff failure,
bad usage).  Stale baseline entries (suppressions that no longer match
anything) are reported on stderr so the baseline only ever shrinks — they
do not fail the run, the CI gate test does that.

``--diff BASE`` resolves findings against ``git diff BASE``: only findings
on changed/added lines are reported, so a new rule can gate strictly on
new code while legacy findings live in the baseline.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from lakesoul_tpu_torch.analysis.engine import (
    Baseline,
    EngineError,
    default_baseline_path,
    package_root,
    run,
)

FORMATS = ("text", "json", "sarif")


def _select_rules(rule_ids: list[str] | None):
    from lakesoul_tpu_torch.analysis.rules import all_rules

    rules = all_rules()
    if not rule_ids:
        return rules
    known = {r.id for r in rules}
    unknown = [r for r in rule_ids if r not in known]
    if unknown:
        raise EngineError(
            f"unknown rule id(s): {', '.join(unknown)} — known rules: "
            + ", ".join(sorted(known))
        )
    wanted = set(rule_ids)
    return [r for r in rules if r.id in wanted]


def render(findings, rules, fmt: str) -> str:
    """Findings in the requested format (shared with the console's ``lint``
    command so both surfaces emit identical bytes; the clean text line is
    the console's)."""
    if fmt == "json":
        return json.dumps(
            [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "message": f.message}
                for f in findings
            ],
            indent=2,
        )
    if fmt == "sarif":
        from lakesoul_tpu_torch.analysis.sarif import to_sarif

        return json.dumps(to_sarif(findings, rules), indent=2)
    lines = [f.render() for f in findings]
    if findings:
        lines.append(f"\n{len(findings)} finding(s)")
    else:
        lines.append("lint clean: no unsuppressed findings")
    return "\n".join(lines)


def report_stale(baseline) -> None:
    """Stale baseline entries (suppressions that matched nothing) on
    stderr, so the baseline only ever shrinks."""
    for stale in baseline.stale_entries():
        print(
            "stale baseline entry (fixed? delete it): "
            f"[{stale['rule']}] {stale['path']}: {stale['message']}",
            file=sys.stderr,
        )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="lakesoul-lint",
        description="project-native static analysis for lakesoul_tpu_torch",
    )
    parser.add_argument("paths", nargs="*", help="files/dirs (default: the package)")
    parser.add_argument(
        "--format", choices=FORMATS, default=None,
        help="findings format on stdout (default: text)",
    )
    parser.add_argument(
        "--json", action="store_true", help="alias for --format json"
    )
    parser.add_argument(
        "--sarif", action="store_true", help="alias for --format sarif"
    )
    parser.add_argument(
        "--rule", action="append", metavar="ID", dest="rules",
        help="run only this rule id (repeatable)",
    )
    parser.add_argument(
        "--diff", metavar="BASE", default=None,
        help="report only findings on lines changed since the git ref BASE "
        "(strict-on-new-code mode; legacy findings stay in the baseline)",
    )
    parser.add_argument(
        "--baseline",
        default=str(default_baseline_path()),
        help="baseline file (default: analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true", help="ignore the baseline entirely"
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write all current findings into the baseline (reasons start as "
        "TODO and must be justified before review)",
    )
    args = parser.parse_args(argv)

    fmt = args.format or ("json" if args.json else "sarif" if args.sarif else "text")
    paths = [Path(p) for p in args.paths] or None

    try:
        rules = _select_rules(args.rules)
        baseline = (
            Baseline([]) if args.no_baseline else Baseline.load(Path(args.baseline))
        )

        if args.write_baseline:
            if args.rules:
                raise EngineError(
                    "--write-baseline with --rule would overwrite the "
                    "baseline with ONLY the filtered rule's findings, "
                    "deleting every other rule's justified suppressions — "
                    "run it without --rule"
                )
            findings, _ = run(paths, rules=rules, baseline=Baseline([]))
            payload = {
                "version": 1,
                "suppressions": [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "message": f.message,
                        "reason": "TODO: justify or fix",
                    }
                    for f in findings
                ],
            }
            Path(args.baseline).write_text(
                json.dumps(payload, indent=2) + "\n", encoding="utf-8"
            )
            print(f"wrote {len(findings)} suppressions to {args.baseline}")
            return 0

        findings, baseline = run(paths, rules=rules, baseline=baseline)

        if args.diff is not None:
            from lakesoul_tpu_torch.analysis.gitdiff import filter_to_diff

            findings = filter_to_diff(
                findings, args.diff, package_root().parent
            )
    except EngineError as e:
        print(f"lakesoul-lint: engine error: {e}", file=sys.stderr)
        return 2
    except (OSError, ValueError) as e:
        print(f"lakesoul-lint: engine error: {e}", file=sys.stderr)
        return 2

    print(render(findings, rules, fmt))

    if not args.rules:  # a rule filter makes other rules' entries look stale
        report_stale(baseline)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
