"""The port's kernel register (``lakesoul_tpu_torch/tensorplane/smoke.py``)
against the reference's enumeration of its Pallas kernels, and the
reference's lint (``lakesoul_tpu.analysis``) over the port.

On the CPU every wrapper takes its plain version, so ``run_smoke`` can only
show that the plain paths run (``cpu_plain``); ``chip_smoke.py``'s
``register`` phase runs the register on the card, where every case must
``pass``.
"""

from __future__ import annotations

import collections
import inspect
import pathlib

import pytest

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.tensorplane import smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent

# What the reference's lint finds in the port, each (rule, file) with its
# count: recorded, not suppressed (ROADMAP.md Queue 3).  A new finding fails.
LINT_FINDINGS = {
    ("raw-process", "lakesoul_tpu_torch/_build.py"): 1,
    ("raw-process", "lakesoul_tpu_torch/native/__init__.py"): 1,
    ("raw-process", "lakesoul_tpu_torch/parallel/launch.py"): 1,
    ("undocumented-env", "lakesoul_tpu_torch/native/__init__.py"): 1,
    ("transitive-lock-held-call", "lakesoul_tpu_torch/native/__init__.py"): 1,
    ("raw-thread", "lakesoul_tpu_torch/vector/serving.py"): 1,
    ("raw-thread", "lakesoul_tpu_torch/obs/exporter.py"): 1,  # as the reference's baseline
}

PORTS = [(case.name, port) for case in smoke.smoke_cases() for port in case.ports]


def test_register_covers_the_references_enumeration():
    from lakesoul_tpu.tensorplane.smoke import enumerate_pallas_kernels

    enumerated = enumerate_pallas_kernels()
    assert sorted(smoke.REFERENCE_KERNELS) == enumerated
    covered = sorted(k for case in smoke.smoke_cases() for k in case.kernels)
    assert covered == enumerated  # each kernel by exactly one case


def test_register_keeps_the_references_case_names():
    from lakesoul_tpu.tensorplane.smoke import smoke_cases as ref_cases

    ref = {c.name: tuple(c.kernels) for c in ref_cases() if c.kind == "pallas"}
    assert {c.name: c.kernels for c in smoke.smoke_cases()} == ref


def test_every_entry_point_is_registered_once():
    assert sorted(p.entry_point for _, p in PORTS) == sorted([
        "ls_packed_dot", "ls_packed_estimate", "ls_packed_dot_batch",
        "ls_packed_estimate_batch", "ls_packed_scan", "ls_bruteforce_distances",
        "ls_ragged_score"])


@pytest.mark.parametrize("case,port", PORTS, ids=[p.entry_point for _, p in PORTS])
def test_entry_resolves_to_a_counted_wrapper_and_its_plain_version(case, port):
    wrapper, plain, counter = (smoke.resolve(r) for r in (port.wrapper, port.plain, port.counter))
    assert isinstance(counter.launches, int)
    # the plain version takes the wrapper's arguments; the wrapper may add
    # optional keyword-only tuning knobs (the batch kernel's query tile)
    w, p = inspect.signature(wrapper).parameters, inspect.signature(plain).parameters
    assert list(p) == [n for n in w if n in p]
    assert all(w[n].kind is inspect.Parameter.KEYWORD_ONLY and w[n].default is not
               inspect.Parameter.empty for n in w if n not in p)
    source = (ROOT / port.source).read_text()
    assert f"{port.entry_point}(" in source and 'extern "C"' in source


def test_run_smoke_on_the_cpu_reports_cpu_plain():
    report = smoke.run_smoke(device="cpu")
    assert report["ok"] and not report["on_card"]
    assert [c["status"] for c in report["cases"]] == ["cpu_plain"] * 5
    assert report["kernel_enumeration"]["uncovered"] == []
    assert report["untested_on_card"] == [c.name for c in smoke.smoke_cases()]
    assert all(c["detail"]["max_abs_err"] == 0.0 for c in report["cases"])  # plain vs plain


def test_run_smoke_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        assert smoke.run_smoke()["on_card"]
    else:  # never the CPU in its place
        with pytest.raises(ConfigError):
            smoke.run_smoke()


def test_a_failing_case_fails_the_report(monkeypatch):
    cases = smoke.smoke_cases()

    def broken(dev):
        raise AssertionError("diverged")

    cases[1] = smoke.SmokeCase(cases[1].name, cases[1].kind, broken, cases[1].kernels,
                               cases[1].ports)
    monkeypatch.setattr(smoke, "smoke_cases", lambda: cases)
    report = smoke.run_smoke(device="cpu")
    assert not report["ok"]
    assert report["cases"][1]["status"] == "fail" and "diverged" in report["cases"][1]["error"]


def test_an_uncovered_kernel_fails_the_report(monkeypatch):
    cases = smoke.smoke_cases()
    monkeypatch.setattr(smoke, "smoke_cases", lambda: cases[1:])
    report = smoke.run_smoke(device="cpu")
    assert not report["ok"] and report["kernel_enumeration"]["uncovered"] == list(cases[0].kernels)


def test_the_references_lint_finds_only_the_recorded_findings():
    from lakesoul_tpu.analysis.engine import run

    findings, _ = run(paths=[ROOT / "lakesoul_tpu_torch"], root=ROOT)
    got = collections.Counter((f.rule, f.path) for f in findings)
    assert dict(got) == LINT_FINDINGS, [f for f in findings
                                        if (f.rule, f.path) not in LINT_FINDINGS]
