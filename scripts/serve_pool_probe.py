#!/usr/bin/env python3
"""What sharing one memory pool costs MolServe's CUDA graphs, on one card.

    python3 scripts/serve_pool_probe.py

Writes chip_smoke.py's flagship experiment dir (one seeded fold) and serves
it twice in one process: "shared" records every bucket's graph into the
server's one pool (as MolServe does), "private" gives each graph its own
pool (capture_graph with pool=None).  Alternating the two, it prints:

- the first request of 1, 8 and 20 SMILES on each server (featurization,
  the capture's warm-ups and the capture);
- the time of each recording alone (the featurization cached) over a list
  of buckets, with the reserved memory it added;
- what ``gc.collect()`` and ``torch.cuda.empty_cache()`` cost here, which
  ``torch.cuda.graph`` runs before every capture.

The card's name and power limit come first.  Needs a card; imports nothing
of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

DIR = os.path.join(REPO, "build", "serve_pool_probe")
# (batch, atoms, SMILES tokens): the default grid's corners and the largest
BUCKETS = [(1, 32, 32), (4, 48, 48), (16, 64, 64), (64, 64, 64), (32, 96, 128),
           (64, 160, 256), (64, 280, 512)]


def main() -> int:
    import torch

    from mmdti_tpu_torch import MolServe

    if not torch.cuda.is_available():
        print("serve_pool_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    from mmdti_tpu_torch.ops import _build

    card = chip_smoke.phase_card()
    _build.build_all()
    dev = torch.device("cuda")
    chip_smoke._write_serve_dir(DIR, seeds=(0,))
    servers = {"shared": MolServe(DIR, device=dev), "private": MolServe(DIR, device=dev)}
    servers["private"]._pool = None     # capture_graph gives each graph its own pool

    # first requests: featurize, warm up, record
    first = {name: {} for name in servers}
    for i, n in enumerate((1, 8, 20)):
        order = list(servers) if i % 2 == 0 else list(servers)[::-1]
        for name in order:
            t0 = time.perf_counter()
            servers[name].predict(chip_smoke.SMILES_20[:n])
            torch.cuda.synchronize()
            first[name][str(n)] = (time.perf_counter() - t0) * 1e3
    print("first_request_ms " + json.dumps(first), flush=True)

    # recordings alone, alternated, with the reserved memory each adds
    record = {name: {} for name in servers}
    for i, (b, na, ns) in enumerate(BUCKETS):
        order = list(servers) if i % 2 == 0 else list(servers)[::-1]
        for name in order:
            srv = servers[name]
            torch.cuda.synchronize()
            r0 = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            srv.warmup_buckets((b,), (na,), (ns,))
            torch.cuda.synchronize()
            record[name][f"{b}x{na}x{ns}"] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "reserved_gb_added": (torch.cuda.memory_reserved(dev) - r0) / 1e9}
    print("record " + json.dumps(record), flush=True)

    # what torch.cuda.graph runs before each capture, at this heap
    t_gc = []
    t_empty = []
    for _ in range(5):
        t0 = time.perf_counter()
        gc.collect()
        t_gc.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        t_empty.append((time.perf_counter() - t0) * 1e3)
    print("graph_enter_ms " + json.dumps({
        "gc_collect_median": statistics.median(t_gc), "gc_collect_all": t_gc,
        "empty_cache_median": statistics.median(t_empty),
        "reserved_gb_total": torch.cuda.memory_reserved(dev) / 1e9,
        "graphs": {name: len(srv.graphs) for name, srv in servers.items()},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
