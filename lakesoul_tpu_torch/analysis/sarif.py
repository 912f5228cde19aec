"""SARIF 2.1.0 rendering for lakelint findings.

SARIF is what code-scanning UIs (GitHub code scanning, VS Code SARIF
viewer, Azure DevOps) ingest, so `lakesoul-lint --format sarif` makes the
project-native rules first-class citizens next to any generic scanner in
the same pipeline.  Only the shape those consumers actually read is
emitted: tool.driver with the rule catalog, and one result per finding
with ruleId, message.text and a physicalLocation (artifactLocation.uri is
repo-relative with posix separators, matching ``Finding.path``).
"""

from __future__ import annotations

from typing import Iterable

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def to_sarif(findings: Iterable, rules: Iterable) -> dict:
    """``(findings, rules) -> SARIF 2.1.0 log`` as a plain dict (the CLI
    json-dumps it).  ``rules`` is the full catalog that ran, not just the
    ids that fired — consumers use it to render titles and to know a rule
    ran clean."""
    rule_list = [
        {
            "id": r.id,
            "shortDescription": {"text": r.title or r.id},
        }
        for r in rules
    ]
    results = [
        {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": f.line},
                    }
                }
            ],
        }
        for f in findings
    ]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "lakesoul-lint",
                        "informationUri": (
                            "https://github.com/lakesoul-io/LakeSoul"
                        ),
                        "rules": rule_list,
                    }
                },
                "results": results,
            }
        ],
    }
