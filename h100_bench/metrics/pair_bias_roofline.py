"""Pair-bias attention's bound time (work.py, at the shapes the kernels are
handed) of every forward and backward launch over their device time.  In
a step every layer's backward but the last one's also reads the gradient
of the logits it passed on."""

from h100_bench import work

LAYER = "kernels (csrc/pair_bias_attention.cu via ops/hopper_attention.py)"
UNIT = "%"
FWD, BWD = ("pair_mma_fwd",), ("pair_mma_bwd",)


def read(run):
    fwd, bwd = run.trace.kernels(*FWD), run.trace.kernels(*BWD)
    if not fwd or not bwd:
        return None
    s = run.shapes
    B, N, H, D, L = s["B"], s["N"], s["H"], s["D"], s["layers"]
    f, _ = work.pair_bias_fwd_bound(B, N, H, D)
    b3, _ = work.pair_bias_bwd_bound(B, N, H, D, True)
    b2, _ = work.pair_bias_bwd_bound(B, N, H, D, False)
    bound_ms = len(fwd) * f + len(bwd) * ((L - 1) * b3 + b2) / L
    return bound_ms / (sum(d for _, d, _ in fwd + bwd) / 1e3) * 100.0
