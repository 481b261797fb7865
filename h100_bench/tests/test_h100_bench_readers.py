"""The per-layer readers and the trace reduction on a synthetic trace."""

from __future__ import annotations

import pytest

import small  # noqa: F401  (puts the repo on the path)

from h100_bench import work
from h100_bench.registry import Registry
from h100_bench.trace import Trace


def _events():
    """Two steps of a one-layer model: per step a pair-bias forward and
    backward, a gbf forward and backward, a GEMM; a 10 us gap between
    steps, spin kernels at both ends, and a host launch over the gap."""
    ev, t = [], 0.0

    def kernel(name, dur):
        nonlocal t
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": dur})
        t += dur

    kernel("spin_kernel", 5.0)
    for step in range(2):
        kernel("void gbf_mma_fwd_kernel<64>", 4.0)
        kernel("void mmdti::pair_mma_fwd_kernel<8, true>", 2.0)
        kernel("nvjet_gemm", 10.0)
        kernel("void mmdti::pair_mma_bwd_kernel<8, true>", 3.0)
        kernel("void gbf_mma_bwd_kernel<64>", 6.0)
        if step == 0:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t,
                       "dur": 10.0})
            t += 10.0
    kernel("spin_kernel", 5.0)
    return ev


REG = Registry()
readers = {name: REG.metric(name).read for name in REG.names("metrics")}


class _Run:
    def __init__(self):
        self.trace = Trace(_events())
        self.steps = 2
        self.flops = 1e6
        self.shapes = {"B": 2, "N": 8, "H": 4, "D": 8, "K": 16, "layers": 1}


def test_h100_bench_trace_reduction():
    tr = Trace(_events())
    assert len(tr.device) == 10                       # the spin kernels left out
    assert tr.window_s == pytest.approx(60e-6)
    assert tr.busy_s == pytest.approx(50e-6) == pytest.approx(tr.device_sum_s())
    assert tr.idle_gaps(3) == [["cudaGraphLaunch", pytest.approx(10e-6)]]
    assert tr.top_ops(1) == [["nvjet_gemm", pytest.approx(20e-6)]]


def test_h100_bench_readers_arithmetic():
    run = _Run()
    assert readers["step_device_ms"](run) == pytest.approx(25e-3)
    assert readers["device_idle_share"](run) == pytest.approx(100 * 10 / 60)
    assert readers["step_mfu"](run) == pytest.approx(1e6 / 60e-6 / work.PEAK_BF16_FLOPS * 100)
    f, _ = work.pair_bias_fwd_bound(2, 8, 4, 8)
    b, _ = work.pair_bias_bwd_bound(2, 8, 4, 8, False)   # one layer: no logits gradient
    assert readers["pair_bias_roofline"](run) == pytest.approx(2 * (f + b) / 10e-3 * 100)
    gf, _ = work.gbf_fwd_bound(2, 8, 16, 4)
    gb, _ = work.gbf_bwd_bound(2, 8, 16, 4)
    assert readers["gbf_roofline"](run) == pytest.approx(2 * (gf + gb) / 20e-3 * 100)


def test_h100_bench_readers_find_nothing_to_read():
    run = _Run()
    run.trace = Trace([e for e in _events() if "mma" not in e["name"]])
    assert readers["pair_bias_roofline"](run) is None and readers["gbf_roofline"](run) is None
    run.trace = Trace([])
    assert readers["step_device_ms"](run) is None and readers["step_mfu"](run) is None
    assert readers["device_idle_share"](run) is None


def test_h100_bench_metric_files_read_through_readers():
    """Each per-layer entry is read by its quantity's file (step_mfu.train
    by metrics/step_mfu.py)."""
    run = _Run()
    for m in REG.bench["per_layer"]:
        name = m["name"].split(".")[0]
        assert REG.metric_file(m["name"]) == name
        assert REG.metric(m["name"]).read(run) == readers[name](run)
