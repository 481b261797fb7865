"""Source variants of a kernel file for scripts/*_variants.py: a variant is
the file with text edits (one part switched off), compiled into its own
library beside its own copy of the headers."""

from __future__ import annotations

import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mmdti_tpu_torch", "csrc")


def edit(text, old, new, occurrence):
    """text with the occurrence-th `old` replaced by `new`."""
    at = -1
    for _ in range(occurrence):
        at = text.index(old, at + 1)   # raises when the source no longer has `old`
    return text[:at] + new + text[at + len(old):]


def build(name, edits, src, out, nvcc, flags):
    """Compile csrc/<src> with edits [(old, new, occurrence)] under
    out/<name>/; returns the library's path."""
    d = os.path.join(out, name.replace(" ", "_").replace(":", ""))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
    with open(os.path.join(CSRC, src)) as f:
        text = f.read()
    for old, new, n in edits:
        text = edit(text, old, new, n)
    with open(os.path.join(d, src), "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    # each variant defines the same symbols; keep their function-local
    # statics apart (g++ would make them process-wide)
    cmd = [nvcc, *flags, "-Xcompiler", "-fno-gnu-unique", "-o", so, os.path.join(d, src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return so
