"""The fused Gaussian + gbf projection's bound time (work.py) of its
forward and backward launches over the device time of every gbf
kernel."""

from h100_bench import work

LAYER = "kernels (csrc/gbf_proj.cu via ops/hopper_gbf.py)"
UNIT = "%"
FWD, BWD, ALL = ("gbf_mma_fwd", "gbf_proj_kernel"), ("gbf_mma_bwd", "gbf_proj_bwd_kernel"), ("gbf_",)


def read(run):
    fwd, bwd = run.trace.kernels(*FWD), run.trace.kernels(*BWD)
    if not fwd or not bwd:
        return None
    s = run.shapes
    f, _ = work.gbf_fwd_bound(s["B"], s["N"], s["K"], s["H"])
    b, _ = work.gbf_bwd_bound(s["B"], s["N"], s["K"], s["H"])
    device_ms = sum(d for _, d, _ in run.trace.kernels(*ALL)) / 1e3
    return (len(fwd) * f + len(bwd) * b) / device_ms * 100.0
