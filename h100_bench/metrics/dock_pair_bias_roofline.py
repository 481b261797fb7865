"""Pair-bias attention's bound time (work.py) of every launch of a docking
train step over their device time, each bound at the N it was handed: the
marks tell the ligand's launches (N = atom_pad, in ``unimol`` and
``unimol_bwd``) from the pocket's (pocket_pad, in ``pocket`` and
``pocket_bwd``) and the decoder's (their sum, in ``decoder`` and
``decoder_bwd``).  Every backward takes the logits-gradient bound: each
encoder's last logits feed the decoder, and the decoder's the heads
(h100_bench/dock_sections.py)."""

from h100_bench import dock_sections, work

LAYER = "kernels (csrc/pair_bias_attention.cu via ops/hopper_attention.py)"
UNIT = "%"
FWD, BWD = ("pair_mma_fwd",), ("pair_mma_bwd",)
SECTIONS = {"unimol": "Nm", "pocket": "Np", "decoder": "Nc",
            "unimol_bwd": "Nm", "pocket_bwd": "Np", "decoder_bwd": "Nc"}


def read(run):
    split = dock_sections.steps(run)
    if split is None:
        return None
    s = run.shapes
    B, H, D = s["B"], s["H"], s["D"]
    bound_ms = device_ms = 0.0
    for step in split:
        for section, n in SECTIONS.items():
            for _, d, name in step[section]:
                if any(p in name for p in FWD):
                    bound_ms += work.pair_bias_fwd_bound(B, s[n], H, D)[0]
                elif any(p in name for p in BWD):
                    bound_ms += work.pair_bias_bwd_bound(B, s[n], H, D, True)[0]
                else:
                    continue
                device_ms += d / 1e3
    if device_ms <= 0:
        return None
    return bound_ms / device_ms * 100.0
