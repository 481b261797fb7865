"""Batched conformer refinement on the device (port of
mmdti_tpu/ops/device_refine.py).

The same energy model as the host refiners (chem/conformer.py ``_refine``,
csrc/mmchem.cpp): bond springs k=1, 1-3 angle-distance springs k=0.6, a
soft nonbonded repulsion below 2.2 A, momentum 0.8, a step of 0.05 decaying
linearly to a tenth, the coordinates recentred every iteration.  All M
molecules of a padded group refine at once, in float32:

* a spring's displacement ``x[i] - x[j]`` is a gather (the JAX function's
  ``S @ x`` over the signed incidence matrix S, exactly); its endpoint
  forces go back through the incidence transpose, ``S^T @ f``, one batched
  GEMM, so that no atomic scatter changes the order of a sum from one call
  to the next.  Padded (0, 0) term rows have a zero row in S: no
  displacement and no force;
* the repulsion needs no pair list: the full [Np, Np] distance matrix,
  masked to real atoms off the diagonal and off the bonded and 1-3 pairs;
* the GEMMs run in full fp32 whatever the process's TF32 setting
  (``full_fp32``), since a TF32 incidence product would lose about 1e-3 A
  a call.

On a CUDA device the 300-iteration loop of each (molecules, atoms, terms,
iterations) shape is recorded once as a CUDA graph and replayed, the
counterpart of the JAX function's one jit a shape; the step schedule is a
device tensor, so nothing reads the iteration on the host.  Every replay
runs on one refinement stream of the device (``refine_stream``), so a
refinement neither waits for nor is overtaken by work the caller queued
on other streams once its inputs are ready.  These are plain PyTorch
operations, as the JAX function's are plain jnp: no Pallas kernel stands
behind them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

NB_FLOOR = 2.2   # soft lower bound for nonbonded pairs (Angstrom)
LR0 = 0.05
MOMENTUM = 0.8
BOND_K = 1.0
ANGLE_K = 0.6

# recorded refinement graphs, by (device, M, Np, NB, NA, iters); one memory
# pool and one stream per device; _GRAPH_LOCK serializes a graph's
# recording, input copy, replay and output clone, and the TF32 setting's
# save and restore
GRAPHS: Dict[tuple, "_RefineGraph"] = {}
_POOLS: Dict[torch.device, object] = {}
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_GRAPH_LOCK = threading.RLock()


def refine_stream(device) -> "torch.cuda.Stream":
    """The device's refinement stream, made at its first use."""
    device = torch.device(device)
    with _GRAPH_LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        return _STREAMS[device]


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls in full precision inside the block (no TF32 in cuBLAS,
    no bf16 in oneDNN); the process's settings come back after it.  Read
    and written through each backend's ``fp32_precision``: the legacy
    flags raise once a caller has set the new ones.

    The setting is the process's: while the block runs, every thread's
    fp32 matmuls run in full precision and a read of a legacy flag
    (``allow_tf32``) may raise.  So nothing else may run matmuls then, as
    nothing does under MolTrain's featurization and MolServe's lock.  The
    refinement holds the block for an eager run and a graph's recording
    only: a replay runs the GEMMs recorded, and leaves the setting alone."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    with _GRAPH_LOCK:
        saved = [b.fp32_precision for b in backends]
        for b in backends:
            b.fp32_precision = "ieee"
        try:
            yield
        finally:
            for b, prev in zip(backends, saved):
                b.fp32_precision = prev


def _nb_exclusion_mask(atom_mask, bond_idx, ang_idx):
    """[M, Np, Np] float32: 1 where the repulsion applies: both atoms real,
    i != j, the pair neither bonded nor 1-3 (in either order).  The covered
    pairs are set by a scatter of ones (the same value wherever indices
    repeat, so no order matters); padded (0, 0) rows cover the diagonal,
    which is out already."""
    m, np_ = atom_mask.shape
    mask = atom_mask[:, :, None] * atom_mask[:, None, :]
    mask = mask * (1.0 - torch.eye(np_, dtype=mask.dtype, device=mask.device))
    idx = torch.cat([bond_idx, ang_idx], dim=1)
    flat = idx[..., 0] * np_ + idx[..., 1]
    covered = torch.zeros(m, np_ * np_, dtype=mask.dtype, device=mask.device)
    covered.scatter_(1, flat, 1.0)
    covered = covered.view(m, np_, np_)
    covered = covered + covered.transpose(1, 2)
    return mask * (covered == 0).to(mask.dtype)


def _prepare(coords0, n_atoms, bond_idx, bond_len, ang_idx, ang_len, iters):
    """The loop's constant inputs on the device: the atom mask, the spring
    endpoints and targets (bonds then 1-3 terms), their force constants,
    the signed incidence matrix, the repulsion mask and the step
    schedule."""
    m, np_, _ = coords0.shape
    dev = coords0.device
    mask = (torch.arange(np_, device=dev)[None, :]
            < n_atoms.to(torch.int64)[:, None]).to(torch.float32)
    bidx = bond_idx.to(torch.int64)
    aidx = ang_idx.to(torch.int64)
    idx = torch.cat([bidx, aidx], dim=1)                        # [M, T, 2]
    target = torch.cat([bond_len, ang_len], dim=1).to(torch.float32)
    k2 = torch.cat([torch.full(bond_len.shape[1:], BOND_K * 2.0, device=dev),
                    torch.full(ang_len.shape[1:], ANGLE_K * 2.0, device=dev)])
    # signed incidence, transposed: s_t[m, a, t] = [i_t == a] - [j_t == a]
    # (one-hots by scatter: no host check of the indices, so it records)
    ends = [torch.zeros(m, np_, idx.shape[1], device=dev).scatter_(1, idx[:, None, :, e], 1.0)
            for e in (0, 1)]
    s_t = ends[0] - ends[1]                                     # [M, Np, T]
    gather = [idx[..., e, None].expand(m, idx.shape[1], 3) for e in (0, 1)]
    it = torch.arange(iters, dtype=torch.float32, device=dev)
    return {
        "mask": mask, "n_real": torch.clamp_min(mask.sum(1), 1.0)[:, None],
        "gather": gather, "target": target, "k2": k2, "s_t": s_t,
        "nb_mask": _nb_exclusion_mask(mask, bidx, aidx),
        "lr": LR0 * (1.0 - 0.9 * it / float(iters)),
    }


def _iterate(x, vel, c, it: int):
    """One iteration of the momentum descent on the group (x, vel [M, Np, 3])."""
    d = x.gather(1, c["gather"][0]) - x.gather(1, c["gather"][1])      # [M, T, 3]
    dist = torch.sqrt(torch.sum(d * d, dim=-1)) + 1e-9
    f = (c["k2"] * (dist - c["target"]) / dist)[..., None] * d
    grad = torch.bmm(c["s_t"], f)                                      # [M, Np, 3]
    # repulsion: each ordered pair (i, j) gives c_ij (x_i - x_j) to grad[i];
    # the (j, i) entry gives j the equal and opposite force
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1)) + 1e-9
    pen = torch.clamp_min(NB_FLOOR - dist, 0.0) * c["nb_mask"]
    coef = -0.3 * 2.0 * pen / dist
    grad = grad + torch.sum(coef[..., None] * diff, dim=2)
    vel = MOMENTUM * vel - c["lr"][it] * grad
    x = x + vel
    center = torch.sum(x * c["mask"][..., None], dim=1, keepdim=True) / c["n_real"][..., None]
    return x - center, vel


def _refine(inputs: Tuple[torch.Tensor, ...], iters: int, steps=None) -> torch.Tensor:
    c = _prepare(*inputs, iters)
    x = inputs[0].to(torch.float32)
    vel = torch.zeros_like(x)
    for it in range(iters if steps is None else steps):
        x, vel = _iterate(x, vel, c, it)
    return x


class _RefineGraph:
    """One shape's recorded refinement: static input buffers (outside the
    pool), the graph and its output."""

    def __init__(self, inputs, iters, pool, gate):
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        for s, t in zip(self.inputs, inputs):
            s.copy_(t)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _refine(self.inputs, iters, steps=1)   # cuBLAS and the allocator, once
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with gate if gate is not None else contextlib.nullcontext():
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = _refine(self.inputs, iters)


@torch.no_grad()
def refine_conformers(
    coords0: torch.Tensor,     # [M, Np, 3] float32 initial coordinates
    n_atoms: torch.Tensor,     # [M] int real-atom counts (mask built here)
    bond_idx: torch.Tensor,    # [M, NB, 2] int, (0,0)-padded (int16 from the host)
    bond_len: torch.Tensor,    # [M, NB] float32 ideal bond lengths
    ang_idx: torch.Tensor,     # [M, NA, 2] int, (0,0)-padded (int16 from the host)
    ang_len: torch.Tensor,     # [M, NA] float32 ideal 1-3 distances
    iters: int = 300,
    *,
    use_graph: bool = True,
    capture_gate=None,
) -> torch.Tensor:
    """Refine a group of molecules; returns the refined [M, Np, 3]
    coordinates (padded rows are meaningless) on the inputs' device.

    On a CUDA device with ``use_graph`` the loop replays the CUDA graph
    recorded for this shape (recorded at its first call, holding
    ``capture_gate``, a lock, while it records: a device -> host copy in
    another thread invalidates a capture) on the device's refinement
    stream, after the caller's stream's work so far; the output is a
    clone, which the next replay does not overwrite, and the caller's
    stream waits for it.  Elsewhere, or without ``use_graph``, it runs
    eagerly on the caller's stream."""
    inputs = (coords0, n_atoms, bond_idx, bond_len, ang_idx, ang_len)
    dev = coords0.device
    if dev.type != "cuda" or not use_graph:
        with full_fp32():
            return _refine(inputs, int(iters))
    key = (dev, *coords0.shape[:2], bond_idx.shape[1], ang_idx.shape[1], int(iters))
    caller = torch.cuda.current_stream(dev)
    stream = refine_stream(dev)
    with _GRAPH_LOCK, torch.cuda.device(dev), torch.cuda.stream(stream):
        stream.wait_stream(caller)
        prog = GRAPHS.get(key)
        if prog is None:
            pool = _POOLS.setdefault(dev, torch.cuda.graph_pool_handle())
            with full_fp32():
                prog = GRAPHS[key] = _RefineGraph(inputs, int(iters), pool, capture_gate)
        else:
            for s, t in zip(prog.inputs, inputs):
                s.copy_(t)
        prog.graph.replay()
        out = prog.out.clone()
    if caller != stream:
        caller.wait_stream(stream)
        out.record_stream(caller)
    return out


@torch.no_grad()
def refine_energy(coords, atom_mask, bond_idx, bond_len, ang_idx, ang_len):
    """The energy the refinement descends, per molecule ([M]).  The tests
    hold the device refinement's energy to the host float64 refiner's (the
    trajectories differ; the minimum basin is the same)."""
    x = coords.to(torch.float32)
    am = atom_mask.to(torch.float32)
    bi, ai = bond_idx.to(torch.int64), ang_idx.to(torch.int64)

    def term(idx, target, k):
        g = [idx[..., e, None].expand(*idx.shape[:2], 3) for e in (0, 1)]
        d = x.gather(1, g[0]) - x.gather(1, g[1])
        dist = torch.sqrt(torch.sum(d * d, dim=-1)) + 1e-9
        # padded (0, 0) rows: dist 1e-9 would count; mask them by a
        # displacement of exactly zero
        real = (torch.sum(torch.abs(d), dim=-1) > 0).to(x.dtype)
        return torch.sum(k * (dist - target.to(torch.float32)) ** 2 * real, dim=1)

    e = term(bi, bond_len, BOND_K) + term(ai, ang_len, ANGLE_K)
    nb_mask = _nb_exclusion_mask(am, bi, ai)
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1)) + 1e-9
    pen = torch.clamp_min(NB_FLOOR - dist, 0.0)
    # the full matrix counts each unordered pair twice
    return e + 0.5 * 0.3 * torch.sum(pen * pen * nb_mask, dim=(1, 2))


def pad_counts(n: int, *, minimum: int = 8) -> int:
    """Bucket a count to bound the distinct shapes: the next power of two
    (at least ``minimum``) below 128, then multiples of 64."""
    b = minimum
    while b < n and b < 128:
        b *= 2
    if b >= n:
        return b
    return -(-n // 64) * 64
