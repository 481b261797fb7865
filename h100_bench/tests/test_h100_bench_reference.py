"""The plain reference against the port's plain path at a small size, its
parameters against the port's, and the frozen arithmetic against
PERF.md's table and a hand count."""

from __future__ import annotations

import pytest
import torch

from small import CELLS, small_cell

from h100_bench import work
from h100_bench.drivers.train import TrainRun, _program_model
from h100_bench.reference.model import Draws, Reference, param_specs


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_reference_parameters_are_the_ports(name):
    cell = small_cell(name)
    model = _program_model(cell.config, "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: s for k, s, _ in param_specs(cell.config)}
    assert got == want


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("dropout", [False, True])
def test_h100_bench_reference_forward_is_the_plain_paths(name, dropout):
    """The port's plain path (use_kernels=False, float32) and the reference
    give the same logits from the same weights, inputs and dropout seed."""
    cell = small_cell(name, compute_dtype="float32")
    r = TrainRun(cell, 5, "cpu")
    r.setup()
    weights = r.make_weights()
    batch, _ = r.reference_batches()[0]
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.models.mof import build_mof_model

    cfg = cell.config
    kw = dict(compute_dtype="float32", use_kernels=False, unimol_overrides=dict(cfg["unimol"]))
    if cfg["model"] == "mof":
        g = cfg["gas_env"]
        mof = {k: g[k] for k in ("gas_attr_input_dim", "gas_dim", "gas_max_count", "env_bins")}
        mof["env_min_max"] = {k: tuple(v) for k, v in g["env_min_max"].items()}
        plain = build_mof_model(1, len(cfg["atom_vocab"]), 1, "regression", mof_overrides=mof,
                                **kw)
    else:
        plain = build_model(1, len(cfg["atom_vocab"]), 1, cfg["chemberta"]["vocab_size"],
                            chemberta_overrides=dict(cfg["chemberta"]),
                            crossmodal_overrides=dict(cfg["crossmodal"]), **kw)
    plain.load_state_dict(weights)
    gens = [torch.Generator().manual_seed(11) if dropout else None for _ in range(2)]
    with torch.no_grad():
        want = plain(**batch, outputs="train", deterministic=not dropout,
                     generator=gens[0])["logits"]
        got, _, _ = Reference(cfg).forward(weights, batch, Draws(gens[1]))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_float32_program_meets_reference_tightly(name):
    """Run in float32, the port's train steps read as the reference's to
    float32 rounding; in bfloat16, within the cell's limits."""
    cell = small_cell(name, compute_dtype="float32")
    r = TrainRun(cell, 2 ** 31 + 99, "cpu")
    r.setup()
    r.free()
    gaps = r.check()
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 1e-3, gaps


def test_h100_bench_bounds_match_perf_table():
    # PERF.md section 6: pair-bias forward at B=32, N=64: 0.0125 ms (bytes)
    ms, by = work.pair_bias_fwd_bound(32, 64, 64, 8)
    assert round(ms, 4) == 0.0125 and by == "bytes"
    ms, by = work.pair_bias_bwd_bound(32, 64, 64, 8, True)
    assert round(ms, 4) == 0.0194 and by == "bytes"
    # gbf forward at N=280: 0.125 ms (operations); N=528, B=16: 0.222
    ms, by = work.gbf_fwd_bound(32, 280, 128, 64)
    assert round(ms, 3) == 0.125 and by == "operations"
    assert round(work.gbf_fwd_bound(16, 528, 128, 64)[0], 3) == 0.222
    assert round(work.gbf_bwd_bound(16, 528, 128, 64)[0], 3) == 0.591


def test_h100_bench_flops_against_a_hand_count():
    cfg = {"model": "mm_model",
           "unimol": {"encoder_layers": 1, "embed_dim": 4, "ffn_embed_dim": 8,
                      "attention_heads": 2, "gaussian_kernels": 2},
           "chemberta": {"num_hidden_layers": 1, "hidden_size": 4, "intermediate_size": 8},
           "crossmodal": {"num_layers": 1, "hidden_size": 4, "intermediate_size": 8}}
    # one layer over 3 tokens at width 4, FFN 8: q, k, v, o 4 * 2*3*4*4 = 384;
    # QK^T and PV 2 * 2*3*3*4 = 144; FFN 2 * 2*3*4*8 = 384 -> 912
    layer3 = 912
    # 2 tokens: 4 * 2*2*16 = 256, 2 * 2*2*2*4 = 64, 2 * 2*2*32 = 256 -> 576
    layer2 = 576
    # cross, 3 queries over 2 keys: q, o 2*2*3*16 = 192, k, v 2*2*2*16 = 128,
    # 2 * 2*3*2*4 = 96, FFN 2*2*3*32 = 384 -> 800; 2 over 3: 128 + 192 + 96 + 256
    cross = 800 + 672
    # the Gaussian projection over 9 pairs: 2 * 9 * (2*2 + 2*2) = 144
    fwd = layer3 + 144 + layer2 + cross
    assert work.forward_flops(cfg, 3, 2) == fwd
    assert work.train_flops(cfg, 3, 2) == 3 * fwd
