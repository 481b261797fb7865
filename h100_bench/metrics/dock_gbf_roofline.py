"""The fused Gaussian + gbf projection's bound time (work.py) of the
forward and backward launches of a docking train step over the device time
of every gbf kernel of the step, each bound at the N it was handed: the
marks tell the ligand's launches (N = atom_pad, in ``unimol`` and
``unimol_bwd``) from the pocket's (pocket_pad, in ``pocket`` and
``pocket_bwd``) (h100_bench/dock_sections.py)."""

from h100_bench import dock_sections, work

LAYER = "kernels (csrc/gbf_proj.cu via ops/hopper_gbf.py)"
UNIT = "%"
FWD, BWD = ("gbf_mma_fwd", "gbf_proj_kernel"), ("gbf_mma_bwd", "gbf_proj_bwd_kernel")
ALL = ("gbf_",)
SECTIONS = {"unimol": "Nm", "pocket": "Np", "unimol_bwd": "Nm", "pocket_bwd": "Np"}


def read(run):
    split = dock_sections.steps(run)
    if split is None:
        return None
    s = run.shapes
    B, H, K = s["B"], s["H"], s["K"]
    bound_ms = device_ms = 0.0
    fwd = bwd = 0
    for step in split:
        for section, n in SECTIONS.items():
            for _, _, name in step[section]:
                if any(p in name for p in FWD):
                    bound_ms += work.gbf_fwd_bound(B, s[n], K, H)[0]
                    fwd += 1
                elif any(p in name for p in BWD):
                    bound_ms += work.gbf_bwd_bound(B, s[n], K, H)[0]
                    bwd += 1
        device_ms += sum(d for ops in step.values() for _, d, name in ops
                         if any(p in name for p in ALL)) / 1e3
    if not fwd or not bwd or device_ms <= 0:
        return None
    return bound_ms / device_ms * 100.0
