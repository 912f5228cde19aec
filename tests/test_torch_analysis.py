"""The port's lakelint (``lakesoul_tpu_torch/analysis/``) against the
reference's (``lakesoul_tpu/analysis/``), on the reference's fixtures.

- Every fixture under ``tests/fixtures/lint/`` but ``jax/`` (the device pack,
  which the port does not have) is linted by both engines with their 35
  common rules: the findings must be equal as (rule, path, line, message),
  with each catalog's default scopes and with every scope aimed at the
  fixture.  The port finds each ``SEED: <rule>`` line, and no other line of
  that rule.  The fixtures are read, never written.
- Suppression (pragma and baseline), the call graph over ``lakesoul_tpu/``
  (its nodes, resolved and unknown edges, equal across engines), the two
  CLIs' exit codes, ``json`` and ``sarif`` output and ``--diff``.
- The rules whose scopes the port re-aims at itself, on modules the tests
  write into ``tmp_path`` under the port's paths: each seeded line is found
  and each sanctioned form stays silent (the pinned-ring guard, the slot
  that travels with its batch, ``.to(device)``); under the reference's
  paths the same modules are out of the port's scope.
"""

from __future__ import annotations

import inspect
import json
import pathlib
import shutil
import subprocess

import pytest

from lakesoul_tpu.analysis import run as ref_run
from lakesoul_tpu.analysis.__main__ import main as ref_main
from lakesoul_tpu.analysis.engine import Module as RefModule
from lakesoul_tpu.analysis.engine import Project as RefProject
from lakesoul_tpu.analysis.rules import all_rules as ref_all_rules
from lakesoul_tpu_torch.analysis import Baseline, run
from lakesoul_tpu_torch.analysis.__main__ import main
from lakesoul_tpu_torch.analysis.engine import Module, Project
from lakesoul_tpu_torch.analysis.rules import all_rules

ROOT = pathlib.Path(__file__).resolve().parent.parent
LINT = ROOT / "tests" / "fixtures" / "lint"
INTERPROC = LINT / "interproc"

# the rules whose port speaks the port's idiom: the lifetime rules' guards
# and hand-off, and the replay rule's device→host calls
RING_RULE = "ring-aliasing"
IDIOM_RULES = {"view-escapes-release", "replay-host-roundtrip"}

FIXTURES = sorted(
    p.relative_to(LINT).as_posix()
    for p in [*LINT.glob("*.py"), *INTERPROC.glob("*.py")]
    if p.name.startswith(("bad_", "ok_"))
)


def common_ref_rules():
    ids = {r.id for r in all_rules()}
    return [r for r in ref_all_rules() if r.id in ids]


def scoped(rules, rel: str):
    """Each rule that takes a ``scope``, aimed at the fixture ``rel``."""
    return [type(r)(scope=(rel,)) if "scope" in inspect.signature(type(r).__init__).parameters
            else r for r in rules]


def rows(findings, *, messages: bool = True) -> list:
    return sorted((f.rule, f.path, f.line, f.message if messages else "") for f in findings)


def seeded_lines(src: str, rule: str) -> set:
    return {i + 1 for i, line in enumerate(src.splitlines()) if f"SEED: {rule}" in line}


def assert_seed_lines(findings, src: str, rule: str) -> None:
    """Every finding of ``rule`` sits on a line with its SEED marker and every
    marker is found — no misses, no drift."""
    got = {f.line for f in findings if f.rule == rule}
    assert got == seeded_lines(src, rule), (rule, sorted(got), sorted(seeded_lines(src, rule)))


# ------------------------------------------------------------ the fixtures


def test_the_fixture_set_is_the_references_less_the_device_pack():
    assert len([f for f in FIXTURES if "/" not in f and f.startswith("bad_")]) == 20
    assert "ok_pragma.py" in FIXTURES
    assert {f for f in FIXTURES if f.startswith("interproc/")} == {
        "interproc/bad_gate.py", "interproc/bad_lockchain.py",
        "interproc/bad_reader_drop.py", "interproc/bad_taint.py"}
    assert not any(f.startswith("jax/") for f in FIXTURES)


@pytest.mark.parametrize("rel", FIXTURES)
def test_default_catalogs_agree_on_the_fixture(rel):
    want, _ = ref_run([LINT / rel], root=LINT, rules=common_ref_rules())
    got, _ = run([LINT / rel], root=LINT)
    assert rows(got) == rows(want)


@pytest.mark.parametrize("rel", FIXTURES)
def test_catalogs_aimed_at_the_fixture_agree(rel):
    """Every scope aimed at the fixture, so every rule reads it.  The ring
    rule's guards are the port's own (held by its own test below); the
    idiom rules flag the same lines under their port's message."""
    want, _ = ref_run([LINT / rel], root=LINT, rules=scoped(common_ref_rules(), rel))
    got, _ = run([LINT / rel], root=LINT, rules=scoped(all_rules(), rel))
    want = [f for f in want if f.rule != RING_RULE]
    got = [f for f in got if f.rule != RING_RULE]
    assert rows(got, messages=False) == rows(want, messages=False)
    assert rows([f for f in got if f.rule not in IDIOM_RULES]) == rows(
        [f for f in want if f.rule not in IDIOM_RULES])


@pytest.mark.parametrize("rel", FIXTURES)
def test_the_port_finds_every_seed_of_the_fixture(rel):
    src = (LINT / rel).read_text()
    got, _ = run([LINT / rel], root=LINT, rules=scoped(all_rules(), rel))
    seeded_rules = {r.id for r in all_rules() if seeded_lines(src, r.id)} - {RING_RULE}
    for rule in seeded_rules:
        assert_seed_lines(got, src, rule)


def test_the_ring_rule_holds_the_ports_guards_on_the_references_fixture():
    """The reference sanctions ``cache != 'device'`` and the measured
    ``delivery_copies(...)`` probe; the port has neither (its CPU tensor
    aliases the collate buffer under any cache), so those two rings are
    findings here beside the three seeded ones."""
    from lakesoul_tpu_torch.analysis.rules.lifetime import RingAliasingRule

    src = (LINT / "bad_viewescape.py").read_text()
    got, _ = run([LINT / "bad_viewescape.py"], root=LINT,
                 rules=[RingAliasingRule(scope=("bad_viewescape.py",))])
    lines = src.splitlines()
    guarded = {i + 1 for i, line in enumerate(lines) if "ok: the" in line and "_BufferRing" in line}
    assert len(guarded) == 2
    assert {f.line for f in got} == seeded_lines(src, RING_RULE) | guarded
    assert all("not device_put" in f.message and "self._pin" in f.message for f in got)


# ------------------------------------------------------------ suppression


def test_inline_pragma_suppresses_finding():
    got, _ = run([LINT / "ok_pragma.py"], root=LINT)
    assert got == []
    assert Module.load(LINT / "ok_pragma.py", LINT).pragma_rules(7) == {"raw-thread"}


def test_baseline_suppresses_and_reports_stale(tmp_path):
    findings, _ = run([LINT / "bad_threads.py"], root=LINT)
    assert findings
    entries = [{"rule": f.rule, "path": f.path, "message": f.message, "reason": "test"}
               for f in findings]
    stale = {"rule": "raw-thread", "path": "gone.py", "message": "was fixed long ago",
             "reason": "test"}
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "suppressions": entries + [stale]}))
    left, baseline = run([LINT / "bad_threads.py"], root=LINT, baseline=Baseline.load(path))
    assert left == []
    assert baseline.stale_entries() == [stale]


def test_baseline_requires_reasons(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"version": 1, "suppressions": [
        {"rule": "x", "path": "y", "message": "z"}]}))
    with pytest.raises(ValueError, match="justified"):
        Baseline.load(path)


# ------------------------------------------------------------ call graph


def _graph(project_cls, module_cls, paths, root):
    project = project_cls(root=root)
    for p in paths:
        mod = module_cls.load(p, root)
        if mod is not None:
            project.modules.append(mod)
    return project.callgraph()


def _edges(graph) -> list:
    return sorted((e.caller, e.callee or "", e.line, e.col, e.raw, e.receiver or "", e.attr)
                  for edges in graph.edges.values() for e in edges)


def test_the_call_graph_over_the_reference_is_the_references():
    paths = sorted(p for p in (ROOT / "lakesoul_tpu").rglob("*.py")
                   if not p.name.endswith("_pb2.py"))
    got = _graph(Project, Module, paths, ROOT)
    want = _graph(RefProject, RefModule, paths, ROOT)
    assert sorted(got.functions) == sorted(want.functions)
    assert sorted(got.classes) == sorted(want.classes)
    assert _edges(got) == _edges(want)
    stats = got.stats()
    assert stats == want.stats()
    assert stats["resolved_edges"] > 1000 and stats["unknown_edges"] > 1000
    q = got.resolve_method("lakesoul_tpu/service/flight_sql.py::LakeSoulFlightSqlServer",
                           "_check")
    assert q == "lakesoul_tpu/service/flight.py::LakeSoulFlightServer._check"


def test_the_call_graph_resolves_and_records_unknown_edges():
    graph = _graph(Project, Module, sorted(INTERPROC.glob("*.py")), LINT)
    edges = graph.callees("interproc/bad_lockchain.py::do_work")
    assert any(e.callee == "interproc/bad_lockchain.py::_helper" for e in edges)
    edges = graph.callees("interproc/bad_gate.py::BadServer.do_action")
    assert any(e.callee == "interproc/bad_gate.py::BadServer._mutate_helper" for e in edges)
    dyn = [e for e in graph.callees("interproc/bad_gate.py::BadServer._mutate_helper")
           if e.attr == "drop_table"]
    assert len(dyn) == 1 and not dyn[0].resolved
    assert (dyn[0].receiver, dyn[0].raw) == ("self.catalog", "self.catalog.drop_table")


def test_module_names_follow_the_ports_paths():
    from lakesoul_tpu_torch.analysis.callgraph import _module_dotted

    assert _module_dotted("lakesoul_tpu_torch/service/flight.py") == \
        "lakesoul_tpu_torch.service.flight"
    assert _module_dotted("lakesoul_tpu_torch/analysis/__init__.py") == \
        "lakesoul_tpu_torch.analysis"


# ------------------------------------------------------------ the CLIs


@pytest.mark.parametrize("engine", ["port", "reference"])
def test_cli_exit_codes(engine, capsys):
    cli = main if engine == "port" else ref_main
    assert cli([str(LINT / "ok_pragma.py"), "--no-baseline"]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli([str(LINT / "bad_threads.py"), "--no-baseline", "--json"]) == 1
    assert {f["rule"] for f in json.loads(capsys.readouterr().out)} == {"raw-thread"}
    assert cli(["--rule", "nosuch"]) == 2
    assert "unknown rule id" in capsys.readouterr().err
    assert cli(["--rule", "raw-thread", "--write-baseline"]) == 2
    assert "--write-baseline with --rule" in capsys.readouterr().err
    assert cli([str(LINT / "bad_threads.py"), "--no-baseline", "--diff",
                "no-such-ref-xyzzy"]) == 2
    assert "engine error" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_cli_output_is_the_references_over_the_common_rules(fmt, capsys):
    argv = [*(str(LINT / rel) for rel in FIXTURES), "--no-baseline", "--format", fmt]
    for rule in all_rules():
        argv += ["--rule", rule.id]
    assert main(argv) == 1
    got = capsys.readouterr().out
    assert ref_main(argv) == 1
    want = capsys.readouterr().out
    assert got == want
    if fmt == "sarif":
        (sarif_run,) = json.loads(got)["runs"]
        assert len(sarif_run["tool"]["driver"]["rules"]) == 35
        assert sarif_run["results"]
    else:
        assert len(json.loads(got)) > 20


def test_the_text_format_prints_the_consoles_clean_line(capsys):
    assert main([str(LINT / "ok_pragma.py"), "--no-baseline"]) == 0
    assert capsys.readouterr().out == "lint clean: no unsuppressed findings\n"
    assert main([str(LINT / "bad_threads.py"), "--no-baseline", "--rule", "raw-thread"]) == 1
    out = capsys.readouterr().out
    assert out.endswith("\n\n2 finding(s)\n") and "[raw-thread]" in out


def _git(cwd, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                   cwd=str(cwd), check=True, capture_output=True)


def test_diff_mode_gives_the_references_lines(tmp_path):
    from lakesoul_tpu.analysis.gitdiff import changed_lines as ref_changed
    from lakesoul_tpu.analysis.gitdiff import filter_to_diff as ref_filter
    from lakesoul_tpu_torch.analysis.gitdiff import changed_lines, filter_to_diff

    _git(tmp_path, "init", "-q")
    mod = tmp_path / "mod.py"
    legacy = "import threading\n\ndef legacy():\n    return threading.Thread(target=print)\n"
    mod.write_text(legacy)
    _git(tmp_path, "add", "mod.py")
    _git(tmp_path, "commit", "-qm", "base")
    mod.write_text(legacy + "\ndef fresh():\n    return threading.Thread(target=print)\n")
    _git(tmp_path, "add", "mod.py")
    _git(tmp_path, "commit", "-qm", "new code")

    got, _ = run([mod], root=tmp_path, rules=[r for r in all_rules() if r.id == "raw-thread"])
    want, _ = ref_run([mod], root=tmp_path,
                      rules=[r for r in ref_all_rules() if r.id == "raw-thread"])
    assert rows(got) == rows(want) and {f.line for f in got} == {4, 7}
    assert changed_lines("HEAD~1", tmp_path) == ref_changed("HEAD~1", tmp_path) == {
        "mod.py": {5, 6, 7}}
    kept = filter_to_diff(got, "HEAD~1", tmp_path)
    assert rows(kept) == rows(ref_filter(want, "HEAD~1", tmp_path))
    assert [f.line for f in kept] == [7]
    assert filter_to_diff(got, "HEAD", tmp_path) == []
    _git(tmp_path, "config", "diff.mnemonicprefix", "true")
    assert changed_lines("HEAD~1", tmp_path) == {"mod.py": {5, 6, 7}}


# ------------------------------------------------- the re-aimed rules


TORCH_ITER = '''\
import os
import time


class _BufferRing:
    def __init__(self, size):
        self._slots = [{} for _ in range(size)]

    def next_slot(self):
        return self._slots[0]


def _np_column_views(batch):
    return {"c": batch}


class Loader:
    def __init__(self, device_put, pin, collate_fn=None):
        self._pin = pin
        self._ring = None
        if collate_fn is None and os.environ.get("R") == "1" and (not device_put or self._pin):
            self._ring = _BufferRing(4)  # ok: a host consumer or pinned slots
        if device_put:
            self._bad = _BufferRing(4)  # SEED: ring-aliasing
        if not self._pin:
            self._bad = _BufferRing(4)  # SEED: ring-aliasing
        if self._pin:
            self._pinned = _BufferRing(4)  # ok: pinned slots wait on their copy's event
        else:
            self._bad = _BufferRing(4)  # SEED: ring-aliasing
        self._unguarded = _BufferRing(4)  # SEED: ring-aliasing
        self._host = _BufferRing(2) if not device_put else None  # ok: host consumer

    def _host_batch(self, window):
        slot = self._ring.next_slot()
        batch = window.collate(slot, None)
        batch = dict(batch)
        return len(window), batch, slot  # ok: the slot travels with its batch

    def _stray(self, window, other):
        slot = self._ring.next_slot()
        window.collate(slot, None)
        return len(window), other, slot  # SEED: view-escapes-release

    def _keep(self, batch):
        slot = self._ring.next_slot()
        self._kept = slot  # SEED: view-escapes-release
        views = _np_column_views(batch)
        self._pending = [(batch, views)]  # ok: the view travels with its batch
        return views  # SEED: view-escapes-release

    def _stamp(self, table):
        t0 = time.time()  # SEED: stage-nondeterminism
        return table.combine_chunks(), t0  # SEED: hot-path-materialize
'''

TENSORPLANE = '''\
import numpy as np
import torch


def replay(batches, device):
    out = []
    for rows, batch in batches:
        host = batch["x"].cpu()  # SEED: replay-host-roundtrip
        arr = batch["x"].numpy()  # SEED: replay-host-roundtrip
        n = batch["n"].item()  # SEED: replay-host-roundtrip
        back = np.asarray(batch["x"])  # SEED: replay-host-roundtrip
        listed = batch["x"].tolist()  # SEED: replay-host-roundtrip
        out.append((rows, host, arr, n, back, listed))
    return out


def to_device(batch, host, device):
    # allowed: each moves toward the device
    a = batch["x"].to(device)
    b = batch["x"].cuda()
    c = torch.as_tensor(host, device=device)
    d = torch.asarray(host, device=device)
    return a, b, c, d, sum(leaf.nbytes for leaf in batch.values())


def verify(got, want):
    return got.cpu().numpy() == want  # lakelint: ignore[replay-host-roundtrip] verification readback against the host twin
'''

REAIMED_FILES = {
    "data/torch_iter.py": TORCH_ITER,
    "tensorplane/replay.py": TENSORPLANE,
}
# reference fixtures placed under the port's paths: what they seed for the
# rules re-aimed from lakesoul_tpu/ to lakesoul_tpu_torch/
PLACED = {
    "scanplane/bad_races.py": ("bad_races.py", ("shared-state-race", "racy-check-then-act")),
    "scanplane/bad_leaks.py": ("bad_leaks.py",
                               ("unbounded-growth", "thread-lifecycle", "shm-debris")),
    "meta/bad_isolation.py": ("bad_isolation.py", ("txn-boundary",)),
}


def _write_tree(root: pathlib.Path, package: str) -> dict:
    """The modules under ``package``; the reference's loader module is
    ``data/jax_iter.py``."""
    written = dict(REAIMED_FILES)
    for rel, (fixture, _) in PLACED.items():
        written[rel] = (LINT / fixture).read_text()
    for rel, src in written.items():
        if package == "lakesoul_tpu":
            rel = rel.replace("torch_iter", "jax_iter")
        path = root / package / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return written


@pytest.fixture(scope="module")
def reaimed(tmp_path_factory):
    root = tmp_path_factory.mktemp("reaimed")
    written = _write_tree(root, "lakesoul_tpu_torch")
    findings, _ = run([root / "lakesoul_tpu_torch"], root=root)
    yield written, findings
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("rule", ["ring-aliasing", "view-escapes-release",
                                  "stage-nondeterminism", "hot-path-materialize"])
def test_the_loader_rules_read_torch_iter(reaimed, rule):
    written, findings = reaimed
    got = [f for f in findings if f.path == "lakesoul_tpu_torch/data/torch_iter.py"]
    assert_seed_lines(got, written["data/torch_iter.py"], rule)
    assert seeded_lines(written["data/torch_iter.py"], rule)


def test_the_replay_rule_flags_torchs_device_to_host_moves(reaimed):
    written, findings = reaimed
    got = [f for f in findings if f.path == "lakesoul_tpu_torch/tensorplane/replay.py"]
    assert {f.rule for f in got} == {"replay-host-roundtrip"}
    assert_seed_lines(got, written["tensorplane/replay.py"], "replay-host-roundtrip")
    msgs = "\n".join(f.message for f in got)
    for callee in (".cpu()", ".numpy()", ".item()", "np.asarray()", ".tolist()"):
        assert callee in msgs


@pytest.mark.parametrize("placed", sorted(PLACED))
def test_the_package_scoped_rules_read_the_port(reaimed, placed):
    written, findings = reaimed
    got = [f for f in findings if f.path == f"lakesoul_tpu_torch/{placed}"]
    for rule in PLACED[placed][1]:
        assert seeded_lines(written[placed], rule)
        assert_seed_lines(got, written[placed], rule)


def test_under_the_references_paths_the_re_aimed_rules_stay_silent(tmp_path):
    """The same modules under ``lakesoul_tpu/``: the port's re-aimed rules
    do not read them, the reference's package-scoped ones do."""
    _write_tree(tmp_path, "lakesoul_tpu")
    reaimed_ids = {"ring-aliasing", "view-escapes-release", "stage-nondeterminism",
                   "hot-path-materialize", "replay-host-roundtrip"} | {
        rule for _, rules in PLACED.values() for rule in rules}
    got, _ = run([tmp_path / "lakesoul_tpu"], root=tmp_path)
    assert not {f.rule for f in got} & reaimed_ids
    want, _ = ref_run([tmp_path / "lakesoul_tpu"], root=tmp_path)
    assert {f.rule for f in want} >= reaimed_ids


def test_the_identity_rule_exempts_the_ports_fleet_module(tmp_path):
    src = (LINT / "bad_identity.py").read_text()
    for package, exempt in (("lakesoul_tpu_torch", True), ("lakesoul_tpu", False)):
        path = tmp_path / package / "obs" / "fleet.py"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        got, _ = run([path], root=tmp_path,
                     rules=[r for r in all_rules() if r.id == "fleet-identity-label"])
        assert (got == []) == exempt
        if not exempt:
            assert_seed_lines(got, src, "fleet-identity-label")
