"""The port's DeepSeek-V3 decoder (``models/deepseek.py``) and its dropless
held-expert layer (``parallel/experts.py``) against the benchmark's plain
reference (``cellbench/reference/moonlight_ref.py``, loaded by path) on the
CPU, at a tiny width of Moonlight-16B-A3B's block: the loss, every
gradient, three AdamW steps and the selection biases after them; the share
test (the held ranges' routed parts plus the shared experts once are the
uncut layer); dropless routing under a skewed router; and neither side
imports JAX."""

import ast
import copy
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from lakesoul_tpu_torch.models import DeepseekConfig, make_lm_train_state, make_lm_train_step
from lakesoul_tpu_torch.models.deepseek import lm_loss
from lakesoul_tpu_torch.parallel.experts import DroplessMoe, publish_counters, swiglu

ROOT = Path(__file__).resolve().parent.parent
REF_PATH = ROOT / "cellbench" / "reference" / "moonlight_ref.py"
CONFIG = ROOT / "cellbench" / "configs" / "moonlight_16b_a3b_ep8.json"


def _load_ref():
    spec = importlib.util.spec_from_file_location("moonlight_ref_under_test", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_ref()


def tiny_cfg(**over) -> dict:
    """The cell's configuration at a tiny width: 2 layers (1 dense, 1 MoE),
    16 routed experts of which 2 are held, top-4."""
    cfg = copy.deepcopy(json.loads(CONFIG.read_text()))
    cfg.update(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               intermediate_size=128, moe_intermediate_size=32, router_experts=16,
               n_routed_experts=2, held_expert_first=6, num_experts_per_tok=4,
               aux_loss_alpha=0.05, bias_update_speed=1e-3, seq_len=32, batch_size=3)
    cfg.update(over)
    return cfg


def program_config(cfg: dict) -> DeepseekConfig:
    return DeepseekConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], kv_rank=cfg["kv_lora_rank"],
        qk_nope=cfg["qk_nope_head_dim"], qk_rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], ff=cfg["intermediate_size"],
        dense_layers=cfg["first_k_dense_replace"], n_experts=cfg["router_experts"],
        held=(cfg["held_expert_first"], cfg["n_routed_experts"]),
        top_k=cfg["num_experts_per_tok"], expert_ff=cfg["moe_intermediate_size"],
        n_shared=cfg["n_shared_experts"], routed_scaling=cfg["routed_scaling_factor"],
        rms_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        aux_alpha=cfg["aux_loss_alpha"], bias_speed=cfg["bias_update_speed"],
        init_std=0.05, dtype="float32")


def _weights(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(shape, generator=g) * 0.05 if kind == "normal" else torch.ones(shape))
            for k, (shape, kind) in REF.param_shapes(cfg).items()}


def _tokens(cfg, seed=1, steps=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg["vocab_size"], (cfg["batch_size"], cfg["seq_len"]), generator=g)
            for _ in range(steps)]


def _program(cfg, weights):
    model, opt = make_lm_train_state(program_config(cfg), lr=cfg["optimizer"]["lr"],
                                     device="cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return model, opt


def test_the_model_matches_the_reference_in_loss_and_every_gradient():
    cfg = tiny_cfg()
    w = _weights(cfg)
    (tokens,) = _tokens(cfg)
    model, _ = _program(cfg, w)
    loss = lm_loss(model, tokens)
    loss.backward()

    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    seq = REF._Seq(p, {i: torch.zeros(cfg["router_experts"]) for i in REF.moe_layers(cfg)},
                   cfg, "float32")
    want, grads = 0.0, {k: torch.zeros_like(v) for k, v in p.items()}
    for row in tokens:
        val, _, _ = seq.loss(row, tokens.shape[0])
        for (k, acc), g in zip(grads.items(), torch.autograd.grad(val, list(p.values()))):
            acc += g
        want += float(val.detach())
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for k, prm in model.named_parameters():
        assert torch.allclose(prm.grad, grads[k], rtol=1e-4, atol=1e-6), k
    moe = model.layers[1].moe
    assert moe.router.grad.abs().sum() > 0 and moe.expert_w13.grad.abs().sum() > 0


def test_three_adamw_steps_and_the_selection_biases_match_the_reference():
    cfg = tiny_cfg()
    w = _weights(cfg, seed=2)
    batches = _tokens(cfg, seed=3, steps=3)
    model, opt = _program(cfg, w)
    step = make_lm_train_step(model, opt, device="cpu")
    losses, selections = [], None
    for b in batches:
        losses.append(float(step(b)))
        if selections is None:
            selections = torch.stack([m.last_selection for m in model.moe_layers()])
    start = {i: torch.zeros(cfg["router_experts"]) for i in REF.moe_layers(cfg)}
    ref = REF.train(w, start, batches, cfg, cfg["optimizer"])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert torch.equal(selections.sort(-1).values, ref["selections"][0].sort(-1).values)
    for k, prm in model.named_parameters():
        assert float((prm.detach() - w[k]).norm()) == pytest.approx(
            ref["update_norms"][k], rel=1e-3, abs=1e-7), k
    for i, lp in enumerate(model.layers):
        if hasattr(lp, "moe"):
            got = lp.moe.selection_bias
            want = ref["biases"][REF.bias_name(i)]
            assert torch.allclose(got, want, atol=1e-7), (got, want)
            assert got.abs().sum() > 0
    for k, b in REF.bias_after(ref["selections"], cfg, start).items():
        assert torch.equal(b, ref["biases"][k]), k


@pytest.mark.parametrize("first,count", [(0, 16), (6, 2)])
def test_the_untimed_layer_changes_nothing_but_its_counters(first, count):
    """Each forward adds its routed slots and held loads to the layer's
    device counters; publishing reads and zeroes them."""
    cfg = tiny_cfg(held_expert_first=first, n_routed_experts=count)
    model, _ = _program(cfg, _weights(cfg))
    (tokens,) = _tokens(cfg)
    lm_loss(model, tokens)
    lm_loss(model, tokens)
    moe = model.moe_layers()[0]
    held = (moe.last_selection >= first) & (moe.last_selection < first + count)
    got = publish_counters(model.moe_layers())
    assert got["routed_slots"] == 2 * int(held.sum()) and got["dropped"] == 0
    assert got["held_load_mean"] == pytest.approx(2 * int(held.sum()) / count)
    assert int(moe.counters.sum()) == 0


def _layer_params(cfg, seed=5):
    h, fe, E = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["router_experts"]
    g = torch.Generator().manual_seed(seed)
    fs = cfg["n_shared_experts"] * fe
    return {"router": torch.randn(h, E, generator=g) * 0.3,
            "expert_w13": torch.randn(E, h, 2 * fe, generator=g) * 0.05,
            "expert_w2": torch.randn(E, fe, h, generator=g) * 0.05,
            "shared_w13": torch.randn(h, 2 * fs, generator=g) * 0.05,
            "shared_w2": torch.randn(fs, h, generator=g) * 0.05}


def _held_layer(cfg, params, first, count, bias=None):
    def draw(*shape):
        return torch.nn.Parameter(torch.zeros(*shape))

    fe = cfg["moe_intermediate_size"]
    m = DroplessMoe(cfg["hidden_size"], fe, cfg["router_experts"], cfg["num_experts_per_tok"],
                    draw, held=(first, count), shared_ff=cfg["n_shared_experts"] * fe,
                    scaling=cfg["routed_scaling_factor"], bias_speed=cfg["bias_update_speed"])
    with torch.no_grad():
        m.router.copy_(params["router"])
        m.expert_w13.copy_(params["expert_w13"][first:first + count])
        m.expert_w2.copy_(params["expert_w2"][first:first + count])
        m.shared_w13.copy_(params["shared_w13"])
        m.shared_w2.copy_(params["shared_w2"])
        if bias is not None:
            m.selection_bias.copy_(bias)
    return m


def _shared(params, y):
    return swiglu(y, params["shared_w13"], params["shared_w2"])


def _uncut_reference(cfg, params, y, bias):
    """The reference's whole layer: every routed expert held."""
    whole = dict(cfg, n_routed_experts=cfg["router_experts"], held_expert_first=0,
                 first_k_dense_replace=0, num_hidden_layers=1)
    p = {f"layers.0.moe.{k}": v for k, v in params.items()}
    out, _, idx, _ = REF._Seq(p, {0: bias}, whole, "float32").moe(y, 0)
    return out, idx


def test_the_held_ranges_routed_parts_and_the_shared_experts_once_make_the_uncut_layer():
    cfg = tiny_cfg()
    params = _layer_params(cfg)
    y = torch.randn(40, cfg["hidden_size"], generator=torch.Generator().manual_seed(7))
    bias = torch.linspace(-0.05, 0.05, cfg["router_experts"])
    want, _ = _uncut_reference(cfg, params, y, bias)
    count = cfg["router_experts"] // 8
    shared = _shared(params, y)
    total = shared
    for r in range(8):  # eight ranks, EP 8, disjoint held ranges; each adds the shared part
        part, _ = _held_layer(cfg, params, r * count, count, bias=bias)(y)
        total = total + (part - shared)
    assert torch.allclose(total, want, rtol=1e-5, atol=1e-6)
    one, _ = _held_layer(cfg, params, 0, count, bias=bias)(y)
    assert not torch.allclose(one, want, atol=1e-4)  # one rank's share alone is not the layer


def test_a_skewed_router_drops_nothing():
    """Every token picks expert 7 and the three after it (a router column
    that dominates and a bias that lifts the rest): the held range 6..9
    gets three of each token's four picks, every one computed."""
    cfg = tiny_cfg()
    params = _layer_params(cfg)
    params["router"][:, 7] *= 0.0
    params["router"][:, 7] += 3.0
    bias = torch.zeros(cfg["router_experts"])
    bias[8:10] = 5.0
    bias[10] = 4.0
    y = torch.randn(64, cfg["hidden_size"], generator=torch.Generator().manual_seed(9)).abs()
    want, idx = _uncut_reference(cfg, params, y, bias)
    assert (idx.sort(-1).values == torch.tensor([7, 8, 9, 10])).all()
    layer = _held_layer(cfg, params, 6, 4, bias=bias)
    out, _ = layer(y)
    # the tenth expert's share is the rest of the uncut layer's routed part
    tenth, _ = _held_layer(cfg, params, 10, 1, bias=bias)(y)
    assert torch.allclose(out + tenth - _shared(params, y), want, rtol=1e-5, atol=1e-6)
    got = publish_counters([layer])
    assert got["routed_slots"] == 3 * 64 and got["dropped"] == 0
    assert got["held_load_max"] == 64 and got["held_load_mean"] == 48


def test_the_gradient_of_a_held_layer_under_the_bound_of_rows():
    """Every token picks all four held experts (R = N · k rows, no spare):
    the layer's gradients are the reference loop's."""
    cfg = tiny_cfg()
    params = _layer_params(cfg)
    bias = torch.zeros(cfg["router_experts"])
    bias[2:6] = 10.0
    y = torch.randn(24, cfg["hidden_size"], generator=torch.Generator().manual_seed(4))
    layer = _held_layer(cfg, params, 2, 4, bias=bias)
    yl = y.clone().requires_grad_(True)
    out, _ = layer(yl)
    gy = torch.randn_like(out)
    out.backward(gy)
    ref_p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    yr = y.clone().requires_grad_(True)
    whole = dict(cfg, n_routed_experts=cfg["router_experts"], held_expert_first=0)
    p = {f"layers.0.moe.{k}": v for k, v in ref_p.items()}
    ref, _, idx, _ = REF._Seq(p, {0: bias}, whole, "float32").moe(yr, 0)
    assert (idx.sort(-1).values == torch.arange(2, 6)).all()
    ref.backward(gy)
    assert torch.allclose(out, ref.detach(), rtol=1e-5, atol=1e-6)
    assert torch.allclose(yl.grad, yr.grad, rtol=1e-4, atol=1e-6)
    for k in ("router", "shared_w13", "shared_w2"):
        assert torch.allclose(getattr(layer, k).grad, ref_p[k].grad, rtol=1e-4, atol=1e-6), k
    assert torch.allclose(layer.expert_w13.grad, ref_p["expert_w13"].grad[2:6], rtol=1e-4,
                          atol=1e-6)
    assert torch.allclose(layer.expert_w2.grad, ref_p["expert_w2"].grad[2:6], rtol=1e-4,
                          atol=1e-6)


def test_the_balance_term_counts_each_sequence_apart():
    cfg = tiny_cfg()
    params = _layer_params(cfg)
    layer = _held_layer(cfg, params, 0, 2)
    y = torch.randn(2 * 16, cfg["hidden_size"], generator=torch.Generator().manual_seed(3))
    _, both = layer(y, sequences=2)
    _, a = layer(y[:16])
    _, b = layer(y[16:])
    assert float(both) == pytest.approx((float(a) + float(b)) / 2, rel=1e-6)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [
    ROOT / "lakesoul_tpu_torch" / "models" / "deepseek.py",
    ROOT / "lakesoul_tpu_torch" / "parallel" / "experts.py",
    REF_PATH,
], ids=lambda p: p.name)
def test_neither_the_model_nor_the_reference_imports_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "lakesoul_tpu"}
    if path == REF_PATH:
        assert "lakesoul_tpu_torch" not in _imports(path)
