"""Diff-aware finding resolution: ``--diff BASE`` mode.

New interprocedural rules must be able to land *strict on new code* while
pre-existing findings live in ``baseline.json``.  The mechanism: run
``git diff BASE --unified=0`` over the repo, parse the post-image hunk
ranges, and keep only findings whose line falls on a changed/added line of
a changed file.  A finding an edit merely *moved* still fires (its line is
in a hunk); a finding in untouched code does not block the gate.

``git`` failures (not a repo, unknown BASE, missing binary) raise
:class:`~lakesoul_tpu_torch.analysis.engine.EngineError` — the CLI maps that to
exit 2 so CI can distinguish "your diff has findings" from "the gate
itself is broken".
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

from lakesoul_tpu_torch.analysis.engine import EngineError, Finding

__all__ = ["changed_lines", "filter_to_diff"]

_HUNK_RE = re.compile(r"^@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")


def changed_lines(base: str, root: Path) -> dict[str, set[int]]:
    """``{repo-relative posix path: {changed post-image line, ...}}`` for
    ``git diff <base>`` under ``root``.  Zero-length post-hunks (pure
    deletions) contribute no lines — nothing new to lint there."""
    try:
        # pin the prefix and disable external diff drivers: a user's
        # diff.mnemonicprefix/diff.noprefix config would change the '+++'
        # prefix and silently empty the changed-line map (a vacuously
        # green strict-on-new-code gate)
        proc = subprocess.run(  # lakelint: ignore[raw-process] git CLI is the diff oracle: a bounded, reaped, check=False invocation — not a serving/worker process
            [
                "git", "-c", "diff.mnemonicprefix=false",
                "-c", "diff.noprefix=false", "diff", "--no-ext-diff",
                "--unified=0", "--no-color", base, "--", "*.py",
            ],
            cwd=str(root),
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise EngineError(f"git diff {base!r} failed to run: {e}")
    if proc.returncode not in (0, 1):  # 1 = differences found (fine)
        raise EngineError(
            f"git diff {base!r} exited {proc.returncode}: "
            f"{proc.stderr.strip() or proc.stdout.strip()}"
        )
    out: dict[str, set[int]] = {}
    current: set[int] | None = None
    for line in proc.stdout.splitlines():
        if line.startswith("+++ "):
            target = line[4:].strip()
            if target == "/dev/null":  # deleted file: nothing to lint
                current = None
                continue
            if target.startswith("b/"):
                target = target[2:]
            current = out.setdefault(target, set())
            continue
        m = _HUNK_RE.match(line)
        if m and current is not None:
            start = int(m.group(1))
            count = int(m.group(2)) if m.group(2) is not None else 1
            current.update(range(start, start + count))
    return out


def filter_to_diff(
    findings: list[Finding], base: str, root: Path
) -> list[Finding]:
    """Findings that touch lines changed since ``base``."""
    changed = changed_lines(base, root)
    return [
        f for f in findings
        if f.line in changed.get(f.path, ())
    ]
