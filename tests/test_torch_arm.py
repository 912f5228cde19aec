"""``lakesoul_tpu_torch/analysis/arm.py``: a suite's autouse fixture arms
the detectors whose variable is set and whose list names the suite, gets
back what they recorded (replays included), and leaves every detector
disabled and reset; with no variable set nothing is armed.  The lists
mirror ``tests/conftest.py``'s, aimed at the port's suites, and name only
suites that exist and carry the fixture."""

from __future__ import annotations

import pathlib
import threading

import pytest

from lakesoul_tpu_torch.analysis import arm

TESTS = pathlib.Path(__file__).resolve().parent
VARS = {
    "lockgraph": "LAKESOUL_LOCKCHECK", "racecheck": "LAKESOUL_RACECHECK",
    "leakcheck": "LAKESOUL_LEAKCHECK", "fscheck": "LAKESOUL_FSCHECK",
    "txncheck": "LAKESOUL_TXNCHECK", "tracecheck": "LAKESOUL_TRACECHECK",
}


@pytest.fixture()
def no_vars(monkeypatch):
    for var in VARS.values():
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_the_lists_name_the_ports_suites_which_carry_the_fixture():
    assert arm.DETECTORS == {
        "lockgraph": ("test_torch_loader", "test_torch_compaction"),
        "racecheck": ("test_torch_loader", "test_torch_vector_serving", "test_torch_compaction"),
        "leakcheck": ("test_torch_scanplane", "test_torch_autoscale", "test_torch_freshness"),
        "fscheck": ("test_torch_scanplane", "test_torch_fleet_train"),
        "txncheck": ("test_torch_compaction", "test_torch_streaming"),
        "tracecheck": ("test_torch_vector_kernels", "test_torch_vector_index",
                       "test_torch_loader"),
    }
    for suite in {s for suites in arm.DETECTORS.values() for s in suites}:
        text = (TESTS / f"{suite}.py").read_text()
        assert "with armed(__name__, device=\"cpu\") as found:" in text, suite


def test_nothing_is_armed_without_a_variable(no_vars):
    for suite in ("test_torch_loader", "test_torch_scanplane", "tests.test_torch_compaction"):
        assert arm.requested(suite) == []
        with arm.armed(suite) as found:
            for name in VARS:
                assert not arm._module(name).enabled()
        assert found == []


@pytest.mark.parametrize("name", sorted(VARS))
def test_each_variable_arms_its_detector_for_its_suites_only(name, no_vars):
    no_vars.setenv(VARS[name], "1")
    mod = arm._module(name)
    for suite in arm.DETECTORS[name]:
        assert arm.requested(suite) == [name]
        with arm.armed(f"tests.{suite}", device="cpu") as found:
            assert mod.enabled()
        assert not mod.enabled() and found == []
    assert arm.requested("test_torch_sql") == []


def test_an_armed_block_returns_its_violations_and_resets(no_vars):
    no_vars.setenv("LAKESOUL_LOCKCHECK", "1")
    no_vars.setenv("LAKESOUL_RACECHECK", "1")
    from lakesoul_tpu_torch.analysis import lockgraph, racecheck

    with arm.armed("test_torch_loader", device="cpu") as found:
        a, b = threading.Lock(), threading.Lock()
        for first, second in ((a, b), (b, a)):
            def take(first=first, second=second):
                with first:
                    with second:
                        pass

            t = threading.Thread(target=take)
            t.start()
            t.join()
    assert [(name, v.kind) for name, v in found] == [("lockgraph", "lock-cycle")]
    assert "lockgraph: [lock-cycle]" in found.render()
    assert not lockgraph.enabled() and not racecheck.enabled()
    assert lockgraph.violations() == [] and racecheck.violations() == []


def test_replays_run_at_exit(no_vars, tmp_path):
    """The crash replay runs when the block ends: a torn publication made
    inside is reported."""
    no_vars.setenv("LAKESOUL_FSCHECK", "1")
    with arm.armed("test_torch_fleet_train", device="cpu") as found:
        with open(tmp_path / "member-x.json", "w") as f:
            f.write("{}")
    assert found and {v.kind for _, v in found} == {"torn-state"}


def test_a_detector_someone_else_armed_is_left_alone(no_vars):
    no_vars.setenv("LAKESOUL_TRACECHECK", "1")
    from lakesoul_tpu_torch.analysis import tracecheck

    tracecheck.reset()
    tracecheck.enable()
    try:
        with arm.armed("test_torch_vector_kernels") as found:
            pass
        assert tracecheck.enabled() and found == []
    finally:
        tracecheck.disable()
        tracecheck.reset()
