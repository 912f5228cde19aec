"""The Moonlight cell's pieces: its FLOP count against a hand count, its
readers against stand-in runs, and its driver on the CPU at a tiny width
(float32), where a sound run is correct and each fault planted under the
timed path (the state unchanged, half a batch, one token altered, the
selection-bias update skipped) fails the check.  The control, at the
cell's size, runs on the card (``-m chip``)."""

import copy
import json
import time
from types import SimpleNamespace

import pytest

import harness
from conftest import BENCH, load, manifest
from counts.moonlight_flops import held_expert_flops, moonlight_step_flops

RUN = harness.load_module(BENCH / "run.py", "cellbench_run")
CELL = "moonlight_lm_table"
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}


def tiny_moonlight() -> dict:
    cfg = copy.deepcopy(load("configs/moonlight_16b_a3b_ep8.json"))
    cfg.update(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               intermediate_size=128, moe_intermediate_size=32, router_experts=16,
               n_routed_experts=4, num_experts_per_tok=4, max_position_embeddings=32,
               seq_len=32, batch_size=4, initializer_range=0.05)
    cfg["precision"]["body"] = "float32"
    cfg["table"].update(rows=48, hash_bucket_num=2)
    return cfg


def tiny_ctx(*, seed=2**31 + 29, seconds=0.5, trace=False, faults=()):
    import tracing

    spec = harness.resolve_cell(manifest(), CELL)
    return SimpleNamespace(seed=seed, seeds=[seed], seconds=seconds, trace=trace, device="cpu",
                           config=tiny_moonlight(), traffic=spec["traffic"], cell=spec["cell"],
                           t0=time.perf_counter(), spans=tracing.Spans(trace),
                           faults=set(faults))


# ----------------------------------------------------------------- counts
def test_the_step_count_by_hand():
    cfg = load("configs/moonlight_16b_a3b_ep8.json")
    f = moonlight_step_flops(cfg, rows=4)
    tokens = 4 * 8192
    # a token's forward: MLA projections 2·(2048·3072 + 2048·576 + 512·4096
    # + 2048·2048) = 27.53e6 a layer, 9 layers; dense SwiGLU 6·2048·11264;
    # shared 6·2048·2816 and held 0.75 · 6·2048·1408 a MoE layer, 8 layers;
    # router 2·2048·64 a MoE layer; head 2·2048·20480 at 8,191 of 8,192
    assert f["projections"] / 3 / tokens == pytest.approx(9 * 27_525_120)
    assert f["dense_ffn"] / 3 / tokens == pytest.approx(138_412_032)
    assert f["shared_experts"] / 3 / tokens == pytest.approx(8 * 34_603_008)
    assert f["held_experts"] / 3 / tokens == pytest.approx(8 * 0.75 * 17_301_504)
    assert f["router"] / 3 / tokens == pytest.approx(8 * 262_144)
    assert f["head"] / 3 == pytest.approx(2 * 2048 * 20480 * 4 * 8191)
    # attention: 2·16·(192 + 128) a pair, 8192·8193/2 pairs a row, 9 layers
    assert f["attention"] / 3 == pytest.approx(2 * 16 * 320 * 8192 * 8193 / 2 * 4 * 9)
    assert f["total"] == pytest.approx(sum(v for k, v in f.items() if k != "total"))
    assert f["total"] / 1e12 == pytest.approx(121.0, abs=1.0)


def test_the_held_experts_count_is_per_slot_and_pass():
    cfg = load("configs/moonlight_16b_a3b_ep8.json")
    assert held_expert_flops(cfg, slots=10) == 10 * 6 * 2048 * 1408
    assert held_expert_flops(cfg, slots=10, passes=3) == 3 * held_expert_flops(cfg, slots=10)


def test_the_start_biases_balance_every_moe_layer_of_their_batch():
    import torch

    import inputs
    from reference import moonlight_ref as ref

    cfg = dict(tiny_moonlight(), num_hidden_layers=4)
    w = inputs.bert_weights(5, ref.param_shapes(cfg), cfg["initializer_range"], "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg["vocab_size"], (4, 32), generator=g)

    def loads(bias):
        seq = ref._Seq(w, bias, cfg, "float32")
        with torch.no_grad():
            per_row = [seq.loss(row, 4)[2] for row in tokens]
        return torch.stack([sum(r[i] for r in per_row) for i in ref.moe_layers(cfg)])

    zero = loads({i: torch.zeros(16) for i in ref.moe_layers(cfg)})
    assert (zero.max(1).values > 1.5 * zero.mean(1)).all()  # the init's skew
    even = loads(ref.balanced_biases(w, tokens, cfg))
    want = 4 * 32 * cfg["num_experts_per_tok"] / 16
    assert ((even - want).abs() <= 0.1 * want).all(), even


# ----------------------------------------------------------------- readers
@pytest.fixture
def registry(monkeypatch):
    from lakesoul_tpu_torch.obs import metrics, tracing

    monkeypatch.setattr(metrics, "_REGISTRY", metrics.MetricsRegistry())
    monkeypatch.setattr(tracing, "_CLOCK", tracing._DeviceClock())
    return metrics.registry()


def _spans(reg, steps, **seconds):
    """``steps`` device-timed spans of each name, ``seconds`` each a step."""
    for _ in range(steps):
        reg.histogram("lakesoul_span_device_seconds", name="train.step").observe(0.5)
        for name, s in seconds.items():
            reg.histogram("lakesoul_span_device_seconds",
                          name=name.replace("__", ".")).observe(s)


def _run(steps=10, **counters):
    return {"window_s": 5.0, "counters": {"steps": steps, **counters}}


@pytest.mark.parametrize("name,want", [
    ("attention_share.moonlight", 100.0 * 10 * (0.1 + 0.2) / 5.0),
    ("moe_share.moonlight", 100.0 * 10 * (0.05 + 0.1) / 5.0),
])
def test_each_span_share_reads_its_spans_over_the_window(registry, name, want):
    _spans(registry, 10, lm__attention=0.1, lm__attention__backward=0.2, moe=0.05,
           moe__backward=0.1)
    assert harness.metric_reader(name)(_run()) == pytest.approx(want)
    assert harness.metric_reader(name)(_run(steps=11)) is None  # a step not timed


def test_the_expert_roofline_reads_the_counted_flops_over_the_experts_spans(registry):
    _spans(registry, 10, moe__experts=0.002, moe__experts__backward=0.004)
    flops = 0.5 * 989e12 * 10 * 0.006  # half the peak over the spans' time
    got = harness.metric_reader("expert_gemm_roofline.moonlight")(_run(held_expert_flops=flops))
    assert got == pytest.approx(50.0)
    assert harness.metric_reader("expert_gemm_roofline.moonlight")(_run()) is None


def test_a_program_without_the_spans_gives_no_share(registry):
    _spans(registry, 10)  # train.step alone: the parent's program
    for name in ("attention_share.moonlight", "moe_share.moonlight",
                 "expert_gemm_roofline.moonlight"):
        assert harness.metric_reader(name)(_run(held_expert_flops=1e12)) is None


def test_the_copied_readers_read_as_berts():
    run = {"window_s": 4.0, "counters": {"model_flops": 989e12, "queue_s": 0.2},
           "trace": {"window_s": 4.0, "busy_s": 3.0}}
    assert harness.metric_reader("step_mfu.moonlight")(run) == pytest.approx(25.0)
    assert harness.metric_reader("loader_wait_share.moonlight")(run) == pytest.approx(5.0)
    assert harness.metric_reader("device_idle_share.moonlight")(run) == pytest.approx(25.0)


def test_the_cell_is_found_with_its_metrics():
    spec = harness.resolve_cell(manifest(), CELL)
    assert spec["driver"].name == "train_lm_from_table.py"
    assert sorted(m["name"] for m in spec["end_to_end"]) == ["setup_s", "train_rows_per_s"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "step_mfu.moonlight", "attention_share.moonlight", "moe_share.moonlight",
        "expert_gemm_roofline.moonlight", "step_gap_share.moonlight",
        "device_idle_share.moonlight", "loader_wait_share.moonlight"}
    cfg = spec["config"]
    assert cfg["n_routed_experts"] * 8 == cfg["published_values"]["n_routed_experts"]
    assert cfg["vocab_size"] * 8 == cfg["published_values"]["vocab_size"]


# ------------------------------------------------------------ the driver
def finish(**kw):
    spec = harness.resolve_cell(manifest(), CELL)
    ctx = tiny_ctx(**kw)
    run = harness.load_module(spec["driver"]).run(ctx)
    correct, line, _ = RUN.report(spec, run, ctx.trace, DEVICE)
    out = json.loads(line)
    assert out["correct"] == correct and list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("faults,fails", [
    ((), set()),
    (("unchanged",), {"update_gap"}),
    (("half_batch",), {"loss_gap"}),
    (("token",), {"rows_wrong"}),
    (("bias",), {"update_gap"}),
])
def test_a_broken_timed_path_is_not_correct(faults, fails):
    out = finish(faults=faults)
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert out["correct"] is (not faults), out["checks"]
    assert fails <= over, out["checks"]
    assert out["attempted"] > 0 and out["checks"]["dropped"]["value"] == 0


def test_a_traced_run_reports_its_per_layer_metrics():
    out = finish(trace=True)
    assert {"step_mfu.moonlight", "loader_wait_share.moonlight"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.chip
def test_the_control_is_not_correct_at_the_cells_size(chip):
    import tracing

    spec = harness.resolve_cell(manifest(), CELL)
    seed = 4_000_000_007
    ctx = SimpleNamespace(seed=seed, seeds=[seed], seconds=2.0, trace=False, device="cuda",
                          config=spec["config"], traffic=spec["traffic"], cell=spec["cell"],
                          t0=time.perf_counter(), spans=tracing.Spans(False), faults=set())
    limits = {**spec["config"]["limits"], "rows_wrong": 0.0}
    rows = harness.load_module(spec["driver"]).control(ctx)
    for r in rows:
        over = any(r[k] > v for k, v in limits.items() if k in r) or r.get("failed", 0) > 0
        assert over is (r["variant"] != "sound"), json.dumps(r)
