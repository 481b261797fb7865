#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this machine's cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds what the cell's driver needs (the port's kernels build on first use
into build/ inside the checkout), makes inputs and weights from --seed,
warms up until the process is WINDOW_OPENS_AT_S old, measures for
--seconds (or, with --trace 1, profiles the mix's traced steps), checks
the timed path against the plain reference, and prints one JSON line: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and last the numbers compared with their limits,
which also end standard error.  Exits non-zero without a result when there
is no CUDA card or fewer than the cell needs, or when JAX, flax or the JAX
package was imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mmdti_tpu")
# the window opens once the process is this many seconds old: over a
# process's first 10-35 s the host launches work about 7 % slower, whether
# or not it launches meanwhile (PERF.md section 5); the drivers warm up
# until then, inside set-up
WINDOW_OPENS_AT_S = 50.0


def pin_environment() -> None:
    """Every cache at a fixed path inside the checkout, no log files, and
    the program's default LayerNorm path."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    os.environ["MMDTI_DISABLE_FILE_LOG"] = "1"
    os.environ.pop("MMDTI_PALLAS_LN", None)


def process_start() -> float:
    """This process's start on CLOCK_BOOTTIME (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return start_ticks / os.sysconf("SC_CLK_TCK")


def now() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result_line(cell, registry, out: dict, trace: bool, device: dict) -> dict:
    """The contract's JSON object, with the checks last."""
    checks = {k: {"value": out["checks"][k], "limit": limit} for k, limit in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and out["failed"] == 0
    metrics = {}
    if trace:
        for m in registry.per_layer(cell.name):
            value = registry.metric(m["name"]).read(out["traced"])
            if value is None:
                # left out of the line, and named so that it does not
                # vanish unseen
                print(f"per-layer metric {m['name']} found nothing to read", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.end_to_end(cell.name):
            if m["name"] not in out["e2e"]:
                raise KeyError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        tr = out["traced"].trace
        line["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()
    pin_environment()

    import torch

    from h100_bench.registry import Cell, Registry

    registry = Registry()
    cell = Cell(registry, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = registry.driver(cell.mix["driver"]).run(cell, args.seed, args.seconds,
                                                  args.trace == 1, start=start, clock=now,
                                                  opens_at=start + WINDOW_OPENS_AT_S)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"], "power_limit": _power_limit()}
    if args.trace:
        tr = out["traced"].trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
    line = result_line(cell, registry, out, args.trace == 1, device)
    found = forbidden_modules()
    if found:
        print(f"imported {found}: the benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 3
    print(f"set-up phases {out['phases']}; largest gaps at {out['worst']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
