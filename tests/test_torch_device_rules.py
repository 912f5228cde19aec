"""The port's device pack (``lakesoul_tpu_torch/analysis/rules/device.py``),
the counterpart of the reference's jit/pallas pack and of its cases in
``tests/test_analysis.py``: each of the five rules trips on every seeded
line of its fixture and stays silent on the sound twin beside it, each
fixture trips only its own rule, the device index reads the C entries,
their ``ctypes`` bindings and the register, and the rules ride SARIF and
``--diff``.  The fixtures are written into ``tmp_path``: a tiny package
with a ``csrc/`` of its own.  Against the real trees: the index of
``lakesoul_tpu/`` enumerates the reference's Pallas kernels as
``REFERENCE_KERNELS`` lists them (reading text, importing nothing), every
``extern "C"`` entry of the port has a binding and a register field, and
the port lints under 40 rules."""

from __future__ import annotations

import pathlib
import subprocess
import textwrap

import pytest

from lakesoul_tpu_torch.analysis import run
from lakesoul_tpu_torch.analysis.rules import all_rules, rule_ids
from lakesoul_tpu_torch.analysis.rules.device import (
    DeviceHostSyncRule,
    device_index,
    device_rules,
    enumerate_pallas_kernels,
    index_tree,
    register_problems,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEVICE_RULES = ["kernel-abi", "device-host-sync", "kernel-dtype-width",
                "launch-shape-unbucketed", "kernel-raw-entry"]

KERNEL_CU = """\
// two entry points of a tiny kernel library
#include <cstdint>

extern "C" {

int ls_scale(const void* x, void* out, int64_t n, float alpha, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  (void)xf; (void)o; (void)n; (void)alpha; (void)stream;
  return 0;
}

int ls_gather(const void* idx, const void* src, void* out, int64_t n, void* stream) {
  const auto* i = static_cast<const int*>(idx);
  const auto* s = static_cast<const float*>(src);
  (void)i; (void)s; (void)out; (void)n; (void)stream;
  return 0;
}

}  // extern "C"
"""

# the wrappers' module: one checked binding table, the launcher, two
# launch-counting wrappers and their plain versions
KERN_PY = """\
import ctypes
import functools

import torch

from pkg import _build

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_ENTRY_POINTS = {
    "ls_scale": ("k", [_PTR, _PTR, _I64, _F32]),
    "ls_gather": ("k", [_PTR] * 3 + [_I64]),
}


@functools.cache
def _launcher(name):
    source, argtypes = _ENTRY_POINTS[name]
    return _build.entry(_build.load(source), name, argtypes)


def scale(x, alpha):
    if x.device.type == "cpu":
        return x * alpha
    out = torch.empty_like(x)
    _launcher("ls_scale")(x.device, x.data_ptr(), out.data_ptr(), len(x), alpha)
    scale.launches += 1
    return out


scale.launches = 0


def gather(idx, src):
    if src.device.type == "cpu":
        return src[idx.long()]
    out = src.new_empty(len(idx))
    _launcher("ls_gather")(src.device, idx.data_ptr(), src.data_ptr(), out.data_ptr(), len(idx))
    gather.launches += 1
    return out


gather.launches = 0
"""

REGISTER_PY = """\
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelPort:
    wrapper: str
    plain: str
    counter: str
    entry_point: str
    source: str


def _port(wrapper, entry_point, source):
    return KernelPort(wrapper, wrapper, wrapper, entry_point, f"pkg/csrc/{source}")


PORTS = [_port("scale", "ls_scale", "k.cu"), _port("gather", "ls_gather", "k.cu")]
"""

BAD_ABI = """\
import ctypes

from pkg import _build

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_ENTRY_POINTS = {
    "ls_scale": ("k", [_PTR, _PTR, _I64]),  # SEED: kernel-abi (one argument too few)
    "ls_gather": ("k", [_PTR, _PTR, _PTR, ctypes.c_int]),  # SEED: kernel-abi (int for int64_t)
    "ls_scal": ("k", [_PTR, _PTR, _I64, _F32]),  # SEED: kernel-abi (names no entry)
}
WIDE = _build.entry(_build.load("k"), "ls_scale", [_PTR, _I64, _I64, _F32])  # SEED: kernel-abi (scalar for a pointer)
GOOD = _build.entry(_build.load("k"), "ls_gather", [_PTR, _PTR, _PTR, _I64])
"""

BAD_REGISTER = """\
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelPort:
    wrapper: str
    plain: str
    counter: str
    entry_point: str
    source: str


def _port(wrapper, entry_point, source):
    return KernelPort(wrapper, wrapper, wrapper, entry_point, f"pkg/csrc/{source}")


PORTS = [
    _port("scale", "ls_scale", "k.cu"),
    _port("gather", "ls_gathr", "k.cu"),  # SEED: kernel-abi (names no entry)
    KernelPort("g", "g", "g", "ls_gather", "pkg/csrc/other.cu"),  # SEED: kernel-abi (wrong source)
]
"""

BAD_HOST_SYNC = """\
import torch

from pkg.kern import scale


def checked_scale(x, alpha):
    if x.device.type == "cpu":
        return x * alpha
    n = x.sum().item()  # SEED: device-host-sync (.item())
    rows = x.tolist()  # SEED: device-host-sync (.tolist())
    torch.cuda.synchronize()  # SEED: device-host-sync (torch.cuda.synchronize())
    bad = torch.isnan(x).any()
    if bad:  # SEED: device-host-sync (tensor as a truth value)
        raise ValueError("nan")
    del n, rows
    out = torch.empty_like(x)
    checked_scale.launches += 1
    return out


checked_scale.launches = 0


def clean_wrapper(x, alpha):
    # shape reads, device-side assertions and host scalars never sync
    n = x.shape[0]
    if n == 0:
        return x
    torch._assert_async(torch.isfinite(x).all())
    out = torch.empty_like(x)
    clean_wrapper.launches += 1
    return out


clean_wrapper.launches = 0


class Loader:
    def _put_cuda(self, batch):
        host = batch["x"].cpu()  # SEED: device-host-sync (.cpu() in the delivery)
        return host

    def host_side(self, batch):
        return batch["x"].numpy()  # on the host half: not a device path
"""

# a wrapper module of its own: the launches are its, so only the widths
# of what they pass can be wrong
BAD_DTYPE = """\
import ctypes
import functools

import numpy as np
import torch

from pkg import _build

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_ENTRY_POINTS = {
    "ls_scale": ("k", [_PTR, _PTR, _I64, _F32]),
    "ls_gather": ("k", [_PTR, _PTR, _PTR, _I64]),
}


@functools.cache
def _launcher(name):
    source, argtypes = _ENTRY_POINTS[name]
    return _build.entry(_build.load(source), name, argtypes)


def scale64(x, alpha):
    wide = x.double()
    out = torch.empty_like(wide)
    _launcher("ls_scale")(x.device, wide.data_ptr(), out.data_ptr(), len(x), alpha)  # SEED: kernel-dtype-width (float64 into float*)
    return out


def gather64(src, n):
    idx = torch.arange(n, device=src.device)
    out = src.new_empty(n)
    _launcher("ls_gather")(src.device, idx.data_ptr(), src.data_ptr(), out.data_ptr(), n)  # SEED: kernel-dtype-width (int64 into int*)
    return out


def gather_np(src, ids):
    idx = torch.from_numpy(ids.astype(np.int64))
    out = src.new_empty(len(ids))
    _launcher("ls_gather")(src.device, idx.data_ptr(), src.data_ptr(), out.data_ptr(), len(ids))  # SEED: kernel-dtype-width (np.int64 into int*)
    return out


def gather_ok(src, n):
    idx = torch.arange(n, device=src.device, dtype=torch.int32)
    flt = src.float()
    out = src.new_empty(n)
    _launcher("ls_gather")(src.device, idx.data_ptr(), flt.data_ptr(), out.data_ptr(), n)
    return out
"""

BAD_SHAPE = """\
import torch


def _pow2_bucket(n, floor=8):
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_tail(a, n_pad):
    return torch.cat([a, a.new_zeros(n_pad - len(a))])


def _search_body(codes, q, *, k):
    return torch.topk(codes * q, k).indices


def search(codes, q, k):
    n_pad = _pow2_bucket(len(codes))
    padded = _pad_tail(codes, n_pad)
    return _search_body(padded, q, k=k)


def filtered_search(codes, q, k):
    live = codes > 0
    kept = codes[live]
    return _search_body(kept, q, k=k)  # SEED: launch-shape-unbucketed (boolean mask)


def unique_search(codes, q, k):
    return _search_body(torch.unique(codes), q, k=k)  # SEED: launch-shape-unbucketed (unique)


def nonzero_search(codes, q, k):
    rows = torch.nonzero(codes)
    return _search_body(rows, q, k=k)  # SEED: launch-shape-unbucketed (nonzero)


def rebucketed_search(codes, q, k):
    kept = codes[codes > 0]
    kept = _pad_tail(kept, _pow2_bucket(len(kept)))
    return _search_body(kept, q, k=k)
"""

BAD_RAW = """\
import ctypes

from pkg import _build
from pkg import kern


def sneaky(x, out, n):
    lib = _build.load("k")
    lib.ls_scale(x, out, n, 1.0, None)  # SEED: kernel-raw-entry (raw C call)
    return kern._launcher("ls_gather")  # SEED: kernel-raw-entry (another module's launcher)


def rebind():
    return _build.entry(_build.load("k"), "ls_scale", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float])  # SEED: kernel-raw-entry (second binding)


def through_the_wrapper(x):
    return kern.scale(x, 2.0)
"""


def _tree(tmp_path, files: dict) -> pathlib.Path:
    """A tiny package ``pkg`` under ``tmp_path`` with the given files, and
    the kernel source where a file binds or launches it."""
    pkg = tmp_path / "pkg"
    csrc = {"csrc/k.cu": KERNEL_CU} if any("ls_" in t for t in files.values()) else {}
    for rel, text in {"__init__.py": "", **csrc, **files}.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return pkg


def _lint(tmp_path, files: dict, rules=None):
    pkg = _tree(tmp_path, files)
    findings, _ = run([pkg], root=tmp_path, rules=rules or device_rules())
    return findings, pkg


def seeded(text: str, rule: str) -> set:
    return {i + 1 for i, line in enumerate(text.splitlines()) if f"SEED: {rule}" in line}


def assert_seed_lines(findings, rel: str, text: str, rule: str) -> None:
    got = {f.line for f in findings if f.rule == rule and f.path == rel}
    assert got == seeded(text, rule), (rule, rel, sorted(got), sorted(seeded(text, rule)))


SOUND = {"kern.py": KERN_PY, "register.py": REGISTER_PY}


# ----------------------------------------------------------- the five rules


def test_kernel_raw_entry_catches_each_bypass(tmp_path):
    found, _ = _lint(tmp_path, {**SOUND, "bad_raw.py": BAD_RAW})
    raw = [f for f in found if f.rule == "kernel-raw-entry"]
    assert_seed_lines(raw, "pkg/bad_raw.py", BAD_RAW, "kernel-raw-entry")
    msgs = "\n".join(f.message for f in raw)
    assert "outside its wrapper's module pkg/kern.py" in msgs
    assert "bound again" in msgs
    assert not [f for f in raw if f.path != "pkg/bad_raw.py"]


def test_device_host_sync_catches_syncs_and_delivery_stage(tmp_path):
    rule = DeviceHostSyncRule(roots=(("pkg/bad_host_sync.py", "Loader._put_cuda"),))
    found, _ = _lint(tmp_path, {**SOUND, "bad_host_sync.py": BAD_HOST_SYNC}, rules=[rule])
    assert_seed_lines(found, "pkg/bad_host_sync.py", BAD_HOST_SYNC, "device-host-sync")
    msgs = "\n".join(f.message for f in found)
    assert "kernel wrapper" in msgs and "Loader._put_cuda (device half)" in msgs


def test_device_host_sync_clean_half_without_the_delivery_root(tmp_path):
    """With the default roots (the port's own device halves) the fixture's
    kernel-wrapper seeds still fire; only the stand-in delivery needs its
    root named."""
    found, _ = _lint(tmp_path, {**SOUND, "bad_host_sync.py": BAD_HOST_SYNC},
                     rules=[DeviceHostSyncRule()])
    lines = {f.line for f in found if f.path == "pkg/bad_host_sync.py"}
    delivery = {i + 1 for i, l in enumerate(BAD_HOST_SYNC.splitlines()) if ".cpu()  #" in l}
    assert len(delivery) == 1
    assert lines == seeded(BAD_HOST_SYNC, "device-host-sync") - delivery


def test_kernel_dtype_width_catches_each_flow(tmp_path):
    found, _ = _lint(tmp_path, {"bad_dtype.py": BAD_DTYPE})
    width = [f for f in found if f.rule == "kernel-dtype-width"]
    assert_seed_lines(width, "pkg/bad_dtype.py", BAD_DTYPE, "kernel-dtype-width")
    msgs = "\n".join(f.message for f in width)
    assert "float64 but ls_scale reads x as float32" in msgs
    assert "int64 but ls_gather reads idx as int32" in msgs


def test_launch_shape_unbucketed_catches_each_shape_hazard(tmp_path):
    found, _ = _lint(tmp_path, {"bad_shape.py": BAD_SHAPE})
    shape = [f for f in found if f.rule == "launch-shape-unbucketed"]
    assert_seed_lines(shape, "pkg/bad_shape.py", BAD_SHAPE, "launch-shape-unbucketed")
    msgs = "\n".join(f.message for f in shape)
    assert "boolean-mask indexing" in msgs
    assert "torch.unique" in msgs
    assert "pad to a bucketed size" in msgs


def test_kernel_abi_catches_each_mismatch(tmp_path):
    orphan = KERNEL_CU.replace(
        '}  // extern "C"',
        'int ls_orphan(const void* x, int64_t n, void* stream) { return 0; }\n\n}  // extern "C"')
    found, _ = _lint(tmp_path, {**SOUND, "bad_abi.py": BAD_ABI, "register.py": BAD_REGISTER,
                                "csrc/k.cu": orphan})
    abi = [f for f in found if f.rule == "kernel-abi"]
    assert_seed_lines(abi, "pkg/bad_abi.py", BAD_ABI, "kernel-abi")
    assert_seed_lines(abi, "pkg/register.py", BAD_REGISTER, "kernel-abi")
    (cu,) = [f for f in abi if f.path == "pkg/csrc/k.cu"]
    assert "ls_orphan has no ctypes binding" in cu.message
    assert cu.line == orphan.splitlines().index(
        next(l for l in orphan.splitlines() if "ls_orphan" in l)) + 1
    msgs = "\n".join(f.message for f in abi)
    assert "lists 3 argtypes but pkg/csrc/k.cu:6 takes 4 before the stream" in msgs
    assert "argument 3 (n) as int but" in msgs and "declares int64_t" in msgs
    assert "argument 1 (out) as int64_t but" in msgs
    assert "names no extern \"C\" function of k.cu" in msgs


def test_device_pack_fixture_files_trip_only_their_own_rule(tmp_path):
    """Cross-contamination guard: each fixture seeds exactly one rule; the
    sound package beside it stays silent under the whole catalog."""
    for i, (files, rule) in enumerate([
        ({**SOUND, "bad_raw.py": BAD_RAW}, "kernel-raw-entry"),
        ({"bad_dtype.py": BAD_DTYPE}, "kernel-dtype-width"),
        ({**SOUND, "bad_shape.py": BAD_SHAPE}, "launch-shape-unbucketed"),
        ({"bad_abi.py": BAD_ABI}, "kernel-abi"),
    ]):
        found, _ = _lint(tmp_path / str(i), files, rules=all_rules())
        others = [f for f in found if f.rule != rule and f.rule != "undocumented-env"]
        assert others == [], (rule, [f.render() for f in others])
    found, _ = _lint(tmp_path / "sound", SOUND, rules=all_rules())
    assert [f for f in found if f.rule in DEVICE_RULES] == []


def test_device_index_shapes(tmp_path):
    """The shared index reads the fixture package: the C entries with their
    parameters and the element types their casts name, the bindings, the
    register's fields and the launch-counting wrappers."""
    from lakesoul_tpu_torch.analysis.engine import Module, Project

    pkg = _tree(tmp_path, SOUND)
    project = Project(root=tmp_path)
    for path in sorted(pkg.rglob("*.py")):
        project.modules.append(Module.load(path, tmp_path))
    idx = device_index(project)
    assert device_index(project) is idx  # built once
    scale = idx.entry("ls_scale", "k")
    assert [p[0] for p in scale.params] == ["ptr", "ptr", "i64", "f32", "ptr"]
    assert [p[0] for p in scale.bound_params()] == ["ptr", "ptr", "i64", "f32"]
    assert scale.pointee == {"x": "float32", "out": "float32"}
    assert idx.entry("ls_gather").pointee == {"idx": "int32", "src": "float32"}
    assert {(b.entry, b.source, b.argtypes) for b in idx.bindings} == {
        ("ls_scale", "k", ("ptr", "ptr", "i64", "f32")),
        ("ls_gather", "k", ("ptr", "ptr", "ptr", "i64")),
    }
    assert {(f.entry_point, f.source) for f in idx.register} == {
        ("ls_scale", "k.cu"), ("ls_gather", "k.cu")}
    assert {q.rsplit("::", 1)[1] for q in idx.wrappers} == {"scale", "gather"}
    assert register_problems(idx) == []


def test_device_rules_in_sarif_and_diff(tmp_path):
    from lakesoul_tpu_torch.analysis.gitdiff import filter_to_diff
    from lakesoul_tpu_torch.analysis.sarif import to_sarif

    findings, _ = _lint(tmp_path / "s", {"bad_shape.py": BAD_SHAPE})
    log = to_sarif(findings, all_rules())
    ids = {r["id"] for r in log["runs"][0]["tool"]["driver"]["rules"]}
    assert set(DEVICE_RULES) <= ids
    assert {r["ruleId"] for r in log["runs"][0]["results"]} == {"launch-shape-unbucketed"}

    _git(tmp_path, "init", "-q")
    mod = tmp_path / "mod.py"
    head = textwrap.dedent("""\
        import torch


        def _pow2_bucket(n):
            return n


        def _body(x):
            return x


        def padded(x):
            return _body(_pow2_bucket(len(x)))


        def legacy(x):
            return _body(x[x > 0])
        """)
    mod.write_text(head)
    _git(tmp_path, "add", "mod.py")
    _git(tmp_path, "commit", "-qm", "base")
    mod.write_text(head + "\n\ndef fresh(x):\n    return _body(torch.unique(x))\n")
    _git(tmp_path, "add", "mod.py")
    _git(tmp_path, "commit", "-qm", "new code")
    found, _ = run([mod], root=tmp_path, rules=device_rules())
    shape = [f for f in found if f.rule == "launch-shape-unbucketed"]
    assert {f.line for f in shape} == {17, 21}
    kept = filter_to_diff(shape, "HEAD~1", tmp_path)
    assert [f.line for f in kept] == [21]


def _git(cwd, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                   cwd=str(cwd), check=True, capture_output=True)


# ------------------------------------------------------------ real trees


def test_the_index_enumerates_the_references_pallas_kernels():
    """Read as text, never imported: the reference's five ``pl.pallas_call``
    kernels, as the register's static list names them and as the
    reference's own enumeration finds them."""
    from lakesoul_tpu.tensorplane.smoke import enumerate_pallas_kernels as ref_enumerate
    from lakesoul_tpu_torch.tensorplane.smoke import REFERENCE_KERNELS

    got = enumerate_pallas_kernels(ROOT / "lakesoul_tpu")
    assert got == list(REFERENCE_KERNELS) == ref_enumerate()
    assert enumerate_pallas_kernels(ROOT / "lakesoul_tpu_torch") == []


def test_every_port_entry_point_has_a_binding_and_a_register_field():
    from lakesoul_tpu_torch.analysis.rules.device import BINDING_TEXT

    idx = index_tree(ROOT / "lakesoul_tpu_torch")
    assert register_problems(idx) == []
    quick = index_tree(ROOT / "lakesoul_tpu_torch", text_filter=BINDING_TEXT)  # chip_smoke's
    assert (quick.entries, quick.bindings, quick.register) == (
        idx.entries, idx.bindings, idx.register)
    names = set(idx.entries)
    assert names == {b.entry for b in idx.bindings if b.appends_stream}
    assert names == {f.entry_point for f in idx.register}
    assert len(names) == 7 and {e.stem for v in idx.entries.values() for e in v} == {
        "packed_dot", "ragged_score", "bruteforce"}
    assert len(idx.wrappers) == 7


def test_the_port_lints_under_40_rules_with_the_device_pack_last():
    ids = rule_ids()
    assert len(ids) == len(set(ids)) == 40
    assert ids[-5:] == DEVICE_RULES


@pytest.fixture(scope="module")
def port_device_findings():
    """The device pack over the whole port, with no baseline (one run)."""
    findings, _ = run(rules=device_rules())
    return findings


@pytest.mark.parametrize("rule", DEVICE_RULES)
def test_each_device_rule_is_clean_over_the_port(rule, port_device_findings):
    found = [f for f in port_device_findings if f.rule == rule]
    assert found == [], "\n".join(f.render() for f in found)
