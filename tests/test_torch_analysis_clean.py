"""CI gate for the port: ``lakesoul_tpu_torch`` must lint clean under its
lakelint's 40 rules (the reference's 35 host-side rules and the port's own
device pack, the counterpart of the reference's jit/pallas pack), and its
lakelint must find over ``lakesoul_tpu/`` what the reference's finds there
under the common rules (the counterpart of ``tests/test_analysis_clean.py``).

``python -m lakesoul_tpu_torch.analysis`` must exit 0 — no unsuppressed
finding over the whole package — and the port's baseline must stay honest:
every suppression justified, none stale.  The interprocedural,
concurrency, durability, isolation and boundedness packs hold with no
baseline at all.  A new finding here means: fix the code, or add an
inline pragma (or a justified baseline entry) with its reason."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

from lakesoul_tpu_torch.analysis import Baseline, run
from lakesoul_tpu_torch.analysis.engine import default_baseline_path
from lakesoul_tpu_torch.analysis.rules import all_rules, rule_ids

ROOT = pathlib.Path(__file__).resolve().parent.parent

DEVICE_RULES = {
    "trace-impure-call", "trace-host-sync", "tpu-dtype-width",
    "jit-static-arg-shape", "pallas-blockspec",
}
# the port's device pack: CUDA launch safety, one rule for each of the above
PORT_DEVICE_RULES = ["kernel-abi", "device-host-sync", "kernel-dtype-width",
                     "launch-shape-unbucketed", "kernel-raw-entry"]
# the rules whose scopes name a package or the loader module: the port aims
# them at itself, so over lakesoul_tpu/ they read what the reference's do not
REAIMED_RULES = {
    "stage-nondeterminism", "hot-path-materialize", "replay-host-roundtrip",
    "shared-state-race", "racy-check-then-act", "view-escapes-release",
    "ring-aliasing", "txn-boundary", "unbounded-growth", "thread-lifecycle",
    "shm-debris", "fleet-identity-label",
}
PACKS = {
    "interprocedural": {"rbac-gate-reachability", "taint-path-segments",
                        "transitive-lock-held-call", "interprocedural-unclosed-reader"},
    "concurrency": {"shared-state-race", "racy-check-then-act", "view-escapes-release",
                    "ring-aliasing"},
    "durability": {"torn-publish", "unfsynced-rename", "barrier-order"},
    "isolation": {"cas-guard", "read-modify-write", "txn-boundary", "sqlite-ism"},
    "boundedness": {"unbounded-queue", "unbounded-growth", "thread-lifecycle",
                    "child-reap", "shm-debris"},
}


@pytest.fixture(scope="module", autouse=True)
def cli_gate():
    """``python -m lakesoul_tpu_torch.analysis`` as CI runs it, started with
    the module so that it lints beside the in-process runs."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("LAKESOUL_", "JAX_"))}
    proc = subprocess.Popen([sys.executable, "-m", "lakesoul_tpu_torch.analysis"], cwd=ROOT,
                            env={**env, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def port_findings():
    """The whole port under every rule, with no baseline (one run, shared)."""
    findings, _ = run(baseline=Baseline([]))
    return findings


def _render(findings) -> str:
    return "\n".join(f.render() for f in findings)


def test_the_35_rules_are_the_references_less_the_device_pack():
    from lakesoul_tpu.analysis.rules import rule_ids as ref_rule_ids

    ids = [r for r in rule_ids() if r not in PORT_DEVICE_RULES]
    assert len(ids) == len(set(ids)) == 35
    assert ids == [r for r in ref_rule_ids() if r not in DEVICE_RULES]
    assert rule_ids() == ids + PORT_DEVICE_RULES  # 40 rules, the device pack last
    assert REAIMED_RULES <= set(ids) and set().union(*PACKS.values()) <= set(ids)


def test_package_lints_clean(port_findings):
    baseline = Baseline.load(default_baseline_path())
    left = [f for f in port_findings if not baseline.suppresses(f)]
    assert left == [], "unsuppressed lint findings:\n" + _render(left)
    stale = baseline.stale_entries()
    assert stale == [], "stale baseline entries (delete them):\n" + "\n".join(
        f"[{e['rule']}] {e['path']}: {e['message']}" for e in stale)


def test_baseline_entries_are_justified_and_name_the_port():
    baseline = Baseline.load(default_baseline_path())
    assert sorted((e["rule"], e["path"]) for e in baseline.entries) == [
        ("raw-thread", "lakesoul_tpu_torch/obs/exporter.py"),
        ("raw-thread", "lakesoul_tpu_torch/service/storage_proxy.py"),
    ]
    for e in baseline.entries:
        assert e["reason"] and "TODO" not in e["reason"], e


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_pack_clean_package_wide_without_baseline(port_findings, pack):
    """Each pack holds with NO baseline entry: every intentionally
    unguarded site carries an inline pragma whose reason names why."""
    assert len(PACKS[pack]) == len([r for r in all_rules() if r.id in PACKS[pack]])
    got = [f for f in port_findings if f.rule in PACKS[pack]]
    assert got == [], _render(got)


def test_the_ports_lint_over_the_reference_is_the_references():
    """Over ``lakesoul_tpu/``, rule for rule: the port's 35 common rules
    find what the reference's same rules find, apart from the re-aimed ones,
    whose scopes now point at the port (they find nothing there); the port's
    device pack finds nothing there either (the reference has no csrc/)."""
    from lakesoul_tpu.analysis import Baseline as RefBaseline
    from lakesoul_tpu.analysis import run as ref_run
    from lakesoul_tpu.analysis.rules import all_rules as ref_all_rules

    paths = [ROOT / "lakesoul_tpu"]
    common = set(rule_ids()) - REAIMED_RULES - set(PORT_DEVICE_RULES)
    got, _ = run(paths, root=ROOT, baseline=Baseline([]))
    want, _ = ref_run(paths, root=ROOT, baseline=RefBaseline([]),
                      rules=[r for r in ref_all_rules() if r.id in set(rule_ids())])

    def rows(findings, ids):
        return sorted((f.rule, f.path, f.line, f.message) for f in findings if f.rule in ids)

    assert rows(got, common) == rows(want, common)
    assert rows(got, common), "the reference's own baselined findings are expected"
    assert rows(got, REAIMED_RULES) == []
    assert rows(got, set(PORT_DEVICE_RULES)) == []


def test_the_cli_gate_exits_zero(cli_gate):
    out, err = cli_gate.communicate(timeout=300)
    assert cli_gate.returncode == 0, out + err
    assert out == "lint clean: no unsuppressed findings\n"
    assert err == ""  # no stale baseline entry
