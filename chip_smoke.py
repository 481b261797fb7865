#!/usr/bin/env python3
"""Smoke run of mmdti_tpu_torch on one CUDA card (H100): the serving slice,
the train step, fit-and-predict through MolTrain/MolPredict, the
classification tasks, cross-validation, resume and the fit profiler,
fine-tuning from pretrained checkpoints with layers frozen, the MOF
model family on crystals of up to 512 atoms, conformer generation on
the card beside the native host chemistry, the target scalers through
fit, predict and serve, encoder remat, data parallelism (a
one-rank NCCL group, two gloo ranks on the card, a one-replica serving
mesh) and tensor parallelism (two gloo ranks on the card as one model
row, two serving shards on the card).  The pair distances and edge
types are built on the card from coordinates (device_pair_feats 'auto')
unless a check names the host's arrays.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the Hopper kernels from mmdti_tpu_torch/csrc with nvcc, and the
   host chemistry library (csrc/mmchem.cpp) with g++ beside them;
3. each kernel against its plain PyTorch version on the card, fp32 (TF32
   off) and bf16, at the flagship shapes, with padded keys: the attention
   forwards without and with dropout (0.1, same seed; the keep fraction is
   printed beside 0.9), the three backwards (dropout 0 and 0.1, with and
   without the logits cotangent for pair-bias; bf16 pair-bias and masked
   attention run the tensor-core route, whose forward also returns the row
   stats and whose backward is held both to its own plain version and to
   the recompute oracle, repeated calls bit-equal, with profiler device
   times: masked beside SDPA's forward and forward + autograd backward,
   pair-bias beside the row kernels it replaced at the same bf16 inputs and
   SDPA with the bias as a float mask, a partial yardstick), the fused
   Gaussian + gbf_proj forward and backward (fp32 on the FMA route; bf16 on
   the tensor-core route at N=64, 280 and 65, both activations, H=64 and
   96; device times beside the FMA kernels on the same bf16 inputs, the
   function unfused in bf16 PyTorch and the special-function floor;
   repeated backwards bit-equal), and the LayerNorm forward
   and backward ([2048, 512] and [8960, 512], x and y in fp32 and bf16,
   eps 1e-5 and 1e-12; each backward one launch, repeated backwards
   bit-equal, also after a call at T=24; device and CUDA-event times beside
   the earlier kernels' for bf16 x and y); then at phase mof's shapes,
   B=16 and N=528, bf16: pair-bias forward and backward (dropout 0.1, with
   and without the logits cotangent), gbf forward and backward, and
   LayerNorm at [8448, 512].  Each line has the max
   error beside its tolerance, the kernel's time, the plain version's, the
   PyTorch library call's where one computes the same function (SDPA for
   the masked forward), and the bound: the least time the card could take
   for the same bytes and operations (CUDA events, median of 25 launches).
   Device times come from a torch.profiler window of n calls that must
   hold n times each kernel's launches of one call;
4. serve: an experiment dir written with the port's own writers
   (config.yaml from MolTrain's config, model_0.ckpt and model_1.ckpt: the
   flagship's weights from seeds 0 and 1, model_folds 2) served through
   MolServe(load_model=...) on the card: (a) requests of 1, 8 and 20
   SMILES (cache warm) on the eager server (use_graphs off) and the
   graph-replayed one (one CUDA graph per shape bucket), alternated over
   2 rounds of 10 each: p50 each way, the first answers, device ms a
   forward and the port kernels one replay launches (profiler; exactly
   gbf 1, pair-bias 15 and masked 8 a forward), the launchers' counts
   (each capture's 2 warm-ups and capture, the eager forwards, nothing for
   a replay; every gbf and attention launch on the tensor-core route),
   graph outputs against eager ones (bit-equal, or as close as two eager
   calls) and the kernel path against the plain path (2e-2); (b)
   serve_folds="all" (K=2) against the mean of the two single-fold
   servers (2e-2), its p50 and device ms beside fold 0's; (b2) the
   default server (device pair features) against one with
   device_pair_feats="host" (2e-2), p50 alternated; (c)
   warmup_buckets of the default 7 x 3 x 3 grid: seconds, graphs, memory;
   then the largest buckets (B 32/64 x N 224/280 x L 384/512) into the
   same pool: memory again, and (a)'s requests against the eager server
   (as close as two eager calls); (d) the HTTP front with the dynamic
   batcher (window 5 ms): 16 client threads x 20 requests of 1-8 SMILES
   (seeded), requests/s, molecules/s, p50/p95, batches, every reply
   against a lone predict (within half the least gap between two distinct
   molecules' lone predictions, at most 2e-2, so a swapped row fails); a cold
   96-atom bucket recorded while 8 clients keep warm batches in flight
   (captures, pulls held off by a capture); and one 429 with
   max_pending=2;
5. train: the flagship model (bf16 compute, bf16 pair logits) on a batch of
   32 molecules featurized and collated on the host (N=L=64), regression
   (MSE + InfoNCE + ct_regress): (a) one step's loss and gradients, dropout
   off, on the kernel path against the plain path, at L=64 and at the top
   SMILES bucket L=512, every gbf and attention launch on the tensor-core
   route; (b)
   30 steps with
   dropout on, each loss finite and the last below the first; (c) step time
   p50, mols/s and launches per step (exactly gbf 1/1, pair-bias 15/15,
   masked 8/8 forward/backward, all on the tensor-core route), a
   torch.profiler summary of 3 steps (device time, the gbf, pair-bias and
   masked kernels' shares) and the launches of one clip + Adam update;
   (d) one step at the top atom bucket N=280 with its routes (all on the
   tensor cores), peak memory, device time and the kernels' shares;
   (e) one step at N=64, L=512: masked launches per route, device time, the
   masked kernels' share of it and peak memory; (f) the N=L=64 step with
   the LayerNorm kernels off (MMDTI_PALLAS_LN=0) and on (=1), alternated
   over 2 rounds of 10 steps each way: step p50, launches and device ms per
   step, the LayerNorm kernels' ms per step; on, exactly 49 forward and 49
   backward LayerNorm launches a step; and, after (a), the loss of the
   batch with device pair features against the host's arrays on the
   plain fp32 path (1e-4); (g) the flagship with kernel='numerical'
   (NumericalEmbed) at N=L=64: kernel vs plain path as (a), and one
   step's launches (no gbf, pair-bias 15/15, masked 8/8);
6. graphs: K=4 flagship train steps (bf16, B=32, N=L=64, dropout on)
   recorded into one CUDA graph (train/steps.py TrainPrograms.feed over a
   resident batch) and replayed: (a) against the same 4 steps run eagerly
   from the same parameters, moments, counts and generator state, with the
   LayerNorm kernels off and on: parameters, moments, counts and metrics
   must match as closely as two eager runs match each other (bit-equal
   when those do); (b) one replay's launches of each port kernel from the
   profiler, exactly K x its launches a step (gbf 1/1, pair-bias 15/15,
   masked 8/8, LayerNorm 49/49 when on), the routes read at capture, and
   no launcher counter moving during a replay; (c) step p50 (CUDA events),
   device ms and kernels a step, graph and eager alternated over 2 rounds
   of 12 steps each way, LayerNorm kernels off and on, peak memory, and one
   graph step at N=280; (d) MolTrain.fit with the defaults (the resident
   feed engaged, steps_per_call=4) on the set of phase 7, MMDTI_PALLAS_LN=1:
   epoch seconds and history, the launcher counts exactly one train graph's
   and two sweep graphs' warm-up and capture, the resident bytes as the
   fit held them (coordinates) and in host pair mode; (e) MolPredict through the
   resident sweep against the per-batch path (1e-6);
7. fit, with MMDTI_PALLAS_LN=1 for this phase (restored after it, as in
   5 (f)): the 400-molecule
   synthetic regression set (seed 0), scaffold-split (seed 0), then
   MolTrain.fit(train, val) on the eager path (device_feed=False,
   steps_per_call=1) at the flagship width and depth (bf16, B=32,
   3 epochs, dropout, InfoNCE, CT, sample weights, FDS) and
   MolPredict.predict(test); prints the featurization and per-epoch
   seconds, the gbf routes (every launch on the tensor cores), the
   LayerNorm launch counts (forward and backward, checked against the 49
   LayerNorms of a forward), the artifacts, the
   reloaded predictions against the fit's own, the kernel path against the
   plain path on the same checkpoint, the graph-replayed fit of phase 6
   against this one (2e-2), and the test RMSE (a record);
8. tasks, with MMDTI_PALLAS_LN=1 (restored after): (a) for classification,
   multiclass and multilabel_classification (focal, the default loss), the
   400-molecule synthetic set of the task (seed 0), scaffold-split (seed
   0; the three splits hold the same molecules, featurized once into
   conformer caches that every fit and predict reads), MolTrain.fit with
   the defaults (the feed engaged, steps_per_call=4, CUDA graphs) at the
   flagship width and depth (bf16, B=32, 3 epochs, InfoNCE, CT_Single or
   CT_Multi) and MolPredict.predict(test): the artifacts (threshold.dat
   0.5; multiclass_cnt 3 in config.yaml), the predict columns
   (probabilities in [0, 1], multiclass rows summing to 1 within 1e-5,
   labels the probabilities cut at the threshold or their argmax), the
   launch counts of the fit and of the predict, each counted from 0
   (exactly one train graph's and one sweep graph's warm-ups and capture;
   every gbf and attention launch on "mma"), the kernel path against the
   plain path on the same checkpoint (2e-2) and the test metric (a
   record); (b) 4 flagship multilabel_classification steps with
   loss_key="ghm" replayed from one CUDA graph against 4 eager steps from
   the same state, held as phase 6 (a) holds them, GHM bin counts and flag
   included;
9. cv, with MMDTI_PALLAS_LN=1 (restored after), on phase 7's
   400-molecule set: (a) MolTrain(kfold=3, split="scaffold").fit with the
   defaults (the feed, 4 steps a CUDA graph) at the flagship width and
   depth (bf16, B=32, 2 epochs, the target scaler): the artifacts
   (model_folds 3), the out-of-fold predictions covering every row once,
   no scaffold in two folds, per-fold seconds, the launcher counts exactly
   the graphs recorded (a fold reuses the last fold's train graph and
   validation sweep when its shapes agree; every gbf and attention launch
   on "mma"), the reused second fold bit-equal to a fit of that fold
   alone, MolPredict.predict(test) against the mean of the three
   single-fold predictions (1e-5) with one sweep graph for the three
   folds, MolServe(serve_folds="all") against it and the plain path
   against it (2e-2); (b) fit(train, val) for 3 epochs twice
   uninterrupted, and stopped after epoch 2 then resumed
   (checkpoint_interval=1): the last history row, the weights and the
   predictions of the resumed fit as close to the uninterrupted one as
   the two uninterrupted fits are to each other, the train state's bytes,
   its save seconds (async and sync) and load seconds; (c) a fit with
   profile_dir writes a trace holding every port kernel's name, and a fit
   with debug_nans and a NaN target raises FloatingPointError;
10. pretrained, with MMDTI_PALLAS_LN=1 (restored after), on phase 7's
   400-molecule set and phase cv's conformer caches: (a) flagship-width
   synthetic checkpoints written from seeds with torch and the standard
   library (a unicore Uni-Mol file: ``unimat.`` fp32 tensors of the 15
   layers, gbf and gbf_proj, the pretraining heads, ``args``,
   ``optimizer_history``, ``extra_state``, the dictionary beside it; a
   ChemBERTa dir: config.json, bf16 model.safetensors with ``roberta.``
   and ``lm_head.`` tensors, the BPE fixture's tokenizer files), their
   bytes, the seconds to read and to convert each and the converters'
   counts (every mappable tensor loaded, nothing missing or mismatched);
   (b) MolTrain.fit(train, val) from them with the defaults for 2 epochs:
   the initial weights bit-equal to the files widened to fp32, the
   launchers counting exactly one train graph's and one sweep graph's
   warm-ups and capture, one replay's port kernels (profiler) and its
   device ms a step; (c) the same fit with ChemBERTa, the embedding, gbf,
   gbf_proj, the embedding LayerNorm and Uni-Mol layers 0-7 frozen: a
   step launches the backward of pair-bias 7 times (15 unfrozen), masked
   2 (8), gbf 0 (1) and LayerNorm at the sites autograd reaches (hooks
   count them), every forward as before; the frozen tensors of
   model_0.ckpt bit-equal to the files, every trainable one moved; step
   device ms and epoch seconds beside the unfrozen fit's; (d) MolPredict
   and MolServe(load_model=...) on that dir (the BPE tokenizer from
   chemberta_dir): serve against predict (2e-3), the kernel path against
   the plain path (2e-2), graph replays against eager forwards (as close
   as two eager calls);
11. mof, with MMDTI_PALLAS_LN=1 (restored after): 96 synthetic crystals
   of 150-700 atoms written as CIF files from seed 0 (the reader crops
   past 512), gases of the reader's list, pressure and temperature;
   MolTrain(data_type="mof").fit at the flagship width and depth (bf16,
   B=16, 2 epochs, device pair features by 'auto') and MolPredict:
   featurization seconds, the pad N (528), resident bytes in device and
   host pair mode, the fit's and the predict's launches exactly one train
   graph's and one sweep graph's (masked attention 0), peak memory, a
   step's launches and device ms eager and replayed, K replayed steps
   against K eager ones (bit for bit), kernel vs plain path on a
   batch of 4 crystals (2e-2 loss, gradients 0.1 of max), and device
   against host pair features on 2 crystals, plain fp32 path (1e-4);
12. conformers: 256 drug-sized molecules built from seed 0 (48-200 atoms
   with hydrogens, 64 in each atom bucket 64, 128, 192, 256): (a) the
   native library's build seconds, its refinement against numpy _refine
   (1e-4) and its ms a molecule by bucket; (b) all 256 through the device
   provider (device_refine_min_atoms=0; cold, with the graphs' recording,
   and warm) and the host one: seconds and molecules/s each way, distances
   within 0.15 A of the host's float64 refinement and energies at most
   1.10 x its, repeat calls bit-equal, a molecule alone against its group
   of 64 (1e-5), graph replay against eager (as close as two eager runs),
   one group's kernels and device ms eager and replayed (profiler); (c)
   the cost a molecule by bucket, host native against the device, a lone
   molecule and groups of 64; (d) 2,000 more molecules (seed 2)
   featurized by the device provider: seconds, the graphs recorded (every
   group at most 64 molecules), peak device memory and the graphs' pool;
   MolTrain.fit with coord_provider 'auto'
   (the card: device) on 200 of the 256, synthetic targets, flagship, 2
   epochs, MMDTI_PALLAS_LN=1: featurization seconds against the host
   provider, pad N, the launch counts (every backward exactly one train
   graph's), and the same fit with device_feed=False (the host branch
   through the prefetched feed): its epoch seconds; (e) cold MolServe
   requests of 8 unseen molecules, feature cache off, the device provider
   against the host one alternated over 5 rounds: p50 each, answers within
   2e-2, and a cold featurization beside a 1 s sleep kernel on the default
   stream (the forward in flight) that returns before the sleep ends;
13. scalers: the target_normalize modes minmax, maxabs, quantile,
   power_trans (Box-Cox on targets moved above 0, Yeo-Johnson on
   centred ones) and log1p, each through a 1-epoch flagship fit of phase
   fit's data with the defaults and MMDTI_PALLAS_LN=1, and quantile
   through a multilabel_regression fit over two NaN-masked columns:
   MolPredict from the dir equal to the fit's predictions, MolServe over
   the dir within 2e-3 of MolPredict on the scaled outputs, the round trip
   within 1e-9 of the targets, target_scaler.ss read back to the same
   numbers, all eight kernels launched (attention and gbf on "mma");
14. remat (models/unimol.py, train/nnmodel.py), run right after phase 6
   (early in the process, where the profiler's windows of a replay hold
   every kernel), at B=32, N=280, flagship,
   bf16, dropout on, MMDTI_PALLAS_LN=1: (a) one eager step with remat off
   and on, loss, gradients and generator state bit-equal, the launches of
   each (pair-bias forward 15 -> 30, LayerNorm forward 49 -> 79); (b) 4
   steps replayed from one graph with remat against 4 eager ones, bit for
   bit; (c) the peak allocated by one eager step off and on, here and at
   the MOF step (B=16, N=528), beside train/nnmodel.py's predicted peaks,
   and the bytes the forward saves (saved-tensor hooks); (d) device ms
   and launches of a replayed step off and on; (e) the auto rule's
   decision and predicted peaks at B=32-256, N=64 and 280, and MOF;
15. dp, data parallelism (parallel/mesh.py), with MMDTI_PALLAS_LN=1: (a)
   phase 7's fit with the defaults (the feed, 2 steps a CUDA graph,
   dropout on) without a group and in a one-rank NCCL group
   (tcp://127.0.0.1, world size 1): the collectives one train graph
   records (5 a step), one replay's device ms a step each way and the
   kernels the group adds, weights (model_0.ckpt's bytes), history,
   cv_pred and MolPredict's predictions bit-equal; (b) two ranks over
   gloo on the one card (NCCL refuses two ranks on one GPU), this script
   started twice with --dp-rank, eager steps, the flagship fit without
   dropout for 2 epochs against the same fit in one process (2e-2, the
   kernel-vs-plain tolerance: bf16 GEMMs over 16 rows a rank), the ranks
   bit-equal to each other, each rank's launches of all eight kernels
   (every gbf and attention launch on "mma"), no train graph recorded,
   only rank 0 writing the experiment dir (an audit hook on each rank),
   then dropout on: each rank's generator (its own stream) draws the
   pair-bias kernel's mask for rows that are the same on both ranks, and
   the masks and outputs differ across ranks; (c) MolServe(mesh_shape=
   (1, 1)) bit-equal to MolServe() on phase serve's dir for requests of
   1, 8 and 20 SMILES, and mesh_shape=(2, 1) refused, naming the one card;
16. tp, tensor parallelism (parallel/mesh.py's model axis), with
   MMDTI_PALLAS_LN=1 for its step: (a) two gloo ranks on the one card as
   one model row, mesh (1, 2), this script started twice with --tp-rank:
   the flagship train step (B=32, N=L=64, bf16, every dropout on) on
   each rank's shard against the one-process step on the same weights
   and seed (loss 2e-2, each gradient, gathered whole, 0.1 of its max),
   each rank's launches of all eight kernels at its shard's heads
   (pair-bias 32, masked 4 and 8, gbf 32 on "mma"), its model-group
   collectives and its peak memory beside the one-process step's; (b)
   MolServe(mesh_shape=(1, 2)) on phase serve's dir with both shards on
   cuda:0 (make_mesh given the card twice): graph replay bit-equal to the
   eager forward, within 2e-3 of the one-shard server, p50 at 1, 8 and
   20 SMILES graph, eager and one shard, alternated.  Phase 3 holds gbf
   at a tensor-parallel rank's H = 16, 32 and 48 and the attention
   kernels at a head offset (keep masks entry by entry) to their plain
   versions;
17. the seconds each phase took, one JSON line with every kernel's
   summary (each task's, phase cv's, phase pretrained's, phase mof's,
   phase conformers', phase scalers', phase remat's, phase dp's and
   phase tp's launches beside the main path's), then {"ok": true, ...}.

Imports nothing of JAX.  Without CUDA, or without the package beside this
file, it prints no result and exits 2.  With ``--dp-rank R --dp-port P
--dp-spec S`` it is one rank of phase dp (b), with ``--tp-rank R
--tp-port P --tp-spec S`` one rank of phase tp (a), as those phases start
them.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the SMILES of the repo's test fixtures (tests/conftest.py)
SMILES_20 = [
    "CCO", "CC(=O)O", "c1ccccc1", "Cc1ccccc1", "CC(C)O", "CCCC", "CCN",
    "c1ccncc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "C1CCCCC1", "O=C1CCCCC1", "CCOC(=O)C", "CCS", "NCCO", "OCC(O)CO",
    "Clc1ccccc1", "Brc1ccccc1", "FC(F)(F)c1ccccc1", "N#Cc1ccccc1",
]
REQUESTS = (1, 8, 20)
REPEATS = 10
SERVE_ROUNDS = 2   # phase serve: rounds of REPEATS requests each way, eager and graph alternated
SERVE_DIR = os.path.join(REPO, "build", "chip_smoke_serve")   # the experiment dir phase serve writes
HTTP_CLIENTS, HTTP_REQUESTS = 16, 20   # phase serve (d): client threads x requests of 1-8 SMILES
HTTP_WINDOW_MS = 5.0
COLD_SMILES = "C" * 30   # 94 atoms with hydrogens: the 96-atom bucket, cold until (d) sends it
TOL = {  # (atol, rtol) per precision; bf16 as tests/test_pallas.py:69-73
    "fp32": {"out": (1e-4, 0.0), "logits": (1e-4, 0.0)},
    "bf16": {"out": (2e-2, 0.0), "logits": (5e-2, 1e-2)},
}
# gradients: the forward's output bound, scaled by the largest magnitude of
# the plain gradient (each is a sum over a whole row or column of scores)
GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2}
LOGITS_TOL = 2e-2  # kernel vs plain path, flagship logits (bf16 compute)
# train step, kernel vs plain path, bf16: largest |dg| / max|g| over the
# parameters (phase_train).  The plain path rounds the probabilities to bf16
# before PV and the kernels do not, so the paths differ by bf16 resolution
# (~4e-3) per layer, compounded through the 23 attention layers of the
# backward; a wrong gradient differs by order 1
TRAIN_GRAD_TOL = 1e-1
TRAIN_LOSS_TOL = 2e-2
# device against host pair features on the plain fp32 path: the distances
# differ in their last bits (tests/test_pair_feats.py holds them to 1e-5)
PAIR_MODE_TOL = 1e-4
DROPOUT = 0.1
TRAIN_STEPS = 30
# H100 SXM datasheet peaks: HBM bytes/s; dense FLOP/s by
# operand type (fp32 runs outside the tensor cores, TF32 being off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
BYTES = {"bf16": 2, "fp32": 4}

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "gbf_proj": ("mmdti_tpu_torch/csrc/gbf_proj.cu", "mmdti_tpu/ops/pallas_gbf.py:117"),
    "gbf_proj_bwd": ("mmdti_tpu_torch/csrc/gbf_proj.cu", "mmdti_tpu/ops/pallas_gbf.py:141"),
    "pair_bias_attention": ("mmdti_tpu_torch/csrc/pair_bias_attention.cu",
                            "mmdti_tpu/ops/pallas_attention.py:166"),
    "pair_bias_attention_bwd": ("mmdti_tpu_torch/csrc/pair_bias_attention.cu",
                                "mmdti_tpu/ops/pallas_attention.py:192"),
    "masked_attention": ("mmdti_tpu_torch/csrc/masked_attention.cu",
                         "mmdti_tpu/ops/pallas_attention.py:590"),
    "masked_attention_bwd": ("mmdti_tpu_torch/csrc/masked_attention.cu",
                             "mmdti_tpu/ops/pallas_attention.py:619"),
    "layer_norm": ("mmdti_tpu_torch/csrc/layer_norm.cu", "mmdti_tpu/ops/pallas_ln.py:110"),
    "layer_norm_bwd": ("mmdti_tpu_torch/csrc/layer_norm.cu", "mmdti_tpu/ops/pallas_ln.py:123"),
}
TRAIN_KERNELS = tuple(KERNELS)[:6]   # launched by phase 5; the LayerNorms by phase 6
# LayerNorm (atol, rtol): fp32 as tests/test_pallas_ln.py:45-52; a bf16
# output may round one bf16 step (2^-8 of its value) either side of the plain one
LN_FWD_TOL = {"fp32": (2e-5, 0.0), "bf16": (2e-2, 1e-2)}
# the earlier LayerNorm kernels (one warp a row, a two-launch backward), bf16
# x and y, E=512, eps 1e-5: (device ms, CUDA-event ms) as PERF.md §6 records
# them (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
LN_EARLIER = {("layer_norm", 2048): (0.0041, 0.0425), ("layer_norm", 8960): (0.0128, 0.0468),
              ("layer_norm_bwd", 2048): (0.0134, 0.0798),
              ("layer_norm_bwd", 8960): (0.0203, 0.0797)}
LN_EARLIER_FWD_BWD = {2048: 0.0174, 8960: 0.0335}
LN_OTHER_T = 24    # the backward runs at this T between two calls that must agree bit for bit
LN_ROUNDS, LN_STEPS = 2, 10   # phase train (f): rounds of steps each way, LayerNorm kernels off/on
LN_SITES = 49   # LayerNorms of a flagship forward that take the kernels (E % 128 == 0)
LN_KERNEL_NAMES = ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel")
FIT_MOLECULES, FIT_EPOCHS = 400, 3
TASK_FITS = ("classification", "multiclass", "multilabel_classification")
TASK_EPOCHS = 3
GRAPH_K = 4   # steps a train graph holds: the fit's default steps_per_call
# phase cv: folds and epochs of the CV fit; epochs of the resume fits and the
# epoch the interrupted one stops after; the ensemble against the mean of
# its folds' predictions (fp32 means of the same fp32 outputs, inverse-scaled)
CV_FOLDS, CV_EPOCHS = 3, 2
RESUME_EPOCHS, RESUME_STOP = 3, 2
CV_ENSEMBLE_TOL = 1e-5
# phase graphs (c): rounds, and replays of a K-step graph a round (3 x 4 =
# 12 steps each way, 10 rounded up to whole replays)
GRAPH_ROUNDS, GRAPH_REPLAYS = 2, 3
PREDICT_SWEEP_TOL = 1e-6   # the sweep against the per-batch path, as tests/test_torch_feed.py
# a substring of the one device kernel each launcher launches once a call
# on the bf16 flagship's routes, for counting a graph replay's launches
KERNEL_MARKERS = {"gbf_proj": "gbf_mma_fwd_kernel", "gbf_proj_bwd": "gbf_mma_bwd_kernel",
                  "pair_bias_attention": "pair_mma_fwd_kernel",
                  "pair_bias_attention_bwd": "pair_mma_bwd_kernel",
                  "masked_attention": "masked_mma_fwd_kernel",
                  "masked_attention_bwd": "masked_mma_bwd_dq_kernel",
                  "layer_norm": "layer_norm_fwd_kernel", "layer_norm_bwd": "layer_norm_bwd_kernel"}
SDPA_PAIR_IS = ("SDPA with the bias as a float attn_mask: a partial yardstick, it writes no "
                "logits and takes no logits cotangent")
# per-case numbers that the main case also carries into the kernels line;
# the case's "route" (the attention's dtype route) goes there as
# "dtype_route", since that line's "route" names the language (cuda)
GBF_UNFUSED_IS = ("the same function unfused in bf16 PyTorch (G materialized, torch.matmul): a "
                  "partial yardstick, not one library call")
SUMMARY_EXTRAS = ("device_ms", "fwd_bwd_device_ms", "rows_device_ms", "rows_fwd_bwd_device_ms",
                  "sdpa_device_ms", "sdpa_fwd_bwd_device_ms", "library_device_ms", "fma_device_ms",
                  "unfused_device_ms", "unfused_fwd_bwd_device_ms")


class Failed(RuntimeError):
    pass


def _counters():
    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg
    from mmdti_tpu_torch.ops import hopper_ln as hl

    return {"gbf_proj": hg.gbf_pair_bias_cuda, "gbf_proj_bwd": hg.gbf_pair_bias_bwd_cuda,
            "pair_bias_attention": ha.pair_bias_attention_cuda,
            "pair_bias_attention_bwd": ha.pair_bias_attention_bwd_cuda,
            "masked_attention": ha.masked_attention_cuda,
            "masked_attention_bwd": ha.masked_attention_bwd_cuda,
            "layer_norm": hl.layer_norm_cuda, "layer_norm_bwd": hl.layer_norm_bwd_cuda}


def _reset_counts():
    for c in _counters().values():
        c.launches = 0
        for route in getattr(c, "routes", {}):
            c.routes[route] = 0


def _read_counts():
    return {k: c.launches for k, c in _counters().items()}


def _read_routes():
    """Launches per route of the attention launchers: "mma" (bf16, tensor
    cores) and "rows" (fp32)."""
    return {k: dict(c.routes) for k, c in _counters().items() if hasattr(c, "routes")}


def _time_ms(fn, iters=25, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_us(fn, n=200):
    """Host microseconds to issue one call: n calls back to back with no
    synchronisation between them (the card keeps up with these kernels)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / n * 1e6


def _kernel_events(fn, n):
    """{kernel name: (launches, device us)} of n calls of fn in one
    torch.profiler window.  The tracer loses kernels at a window's end now
    and then, and in a long process every time (scripts/profiler_windows.py,
    PERF.md): so spin kernels of torch.cuda._sleep stand before and after
    the calls, the window stays open 20 ms after they finish, and the spin
    kernels are left out of what it returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(n):
            fn()
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key}


REJECTED_WINDOWS = []   # profiler windows _call_kernels threw away, printed by phase 3


def _call_kernels(fn, n=20, tries=5):
    """{kernel name: (launches, device us)} of one call of fn.  One
    profiled call gives each kernel name's launches; a window of n calls
    must hold exactly n times as many of each, or it (and the one call) lost
    or kept events and is thrown away and taken again, at most `tries`
    times, then the reading fails.  The device us are the window's over n
    (the host's issue time left out)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        per_call = {k: c for k, (c, _) in _kernel_events(fn, 1).items()}
        window = _kernel_events(fn, n)
        counts = {k: c for k, (c, _) in window.items()}
        if per_call and counts == {k: c * n for k, c in per_call.items()}:
            return {k: (c, window[k][1] / n) for k, c in per_call.items()}
        REJECTED_WINDOWS.append({"per_call": per_call, f"window_of_{n}": counts})
    raise Failed(f"profiler windows lost or gained kernels {tries} times: "
                 f"{REJECTED_WINDOWS[-tries:]}")


def _device_ms(fn, n=20, tries=5):
    """Device ms per call: the kernels' own time (_call_kernels)."""
    return sum(us for _, us in _call_kernels(fn, n, tries).values()) / 1e3


def _bound(nbytes, flops, prec):
    """(ms, what bounds it): the larger of bytes over HBM rate and FLOPs
    over the peak rate of the precision."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[prec] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _err(got, want, atol, rtol):
    """(max abs error over finite entries, ok) with matching -inf patterns."""
    import torch

    got, want = got.float(), want.float()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return float("inf"), False
    if not torch.isfinite(got[~torch.isneginf(got)]).all():
        return float("nan"), False
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    ok = bool((diff <= atol + rtol * want[fin].abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def _grad_errs(names, got, want, prec):
    errs = {}
    for n, g, w in zip(names, got, want):
        tol = GRAD_TOL[prec] * max(1.0, float(w.float().abs().max()))
        e, ok = _err(g, w, tol, 0.0)
        errs[n] = (e, tol, ok)
    return errs


def _pair_stats_errs(logits, stats, want_s):
    """The bf16 pair-bias forward's row stats: the guarded max against the
    plain version's (abs 1e-3), and 1/rowsum against the plain sum over the
    kernel's own stored logits (rel 1e-3)."""
    import torch

    e, ok = _err(stats[..., 0], want_s[..., 0], 1e-3, 0.0)
    inv = 1.0 / torch.exp(logits.float() - stats[..., :1]).sum(dim=-1).clamp_min(1e-30)
    rel = float(((stats[..., 1] - inv).abs() / inv).max())
    return {"stats_max": (e, 1e-3, ok), "stats_inv_rel": (rel, 1e-3, rel <= 1e-3)}


class _PairRows:
    """The pair-bias row kernels, the route bf16 took before the tensor-core
    kernels, launched through their C entry points at the same bf16 inputs
    for device times beside the "mma" route (not counted as launches)."""

    def __init__(self, q, k, v, bias, logits, g_out, g_logits, H, seed, rate):
        import torch

        from mmdti_tpu_torch.ops import _build
        from mmdti_tpu_torch.ops import hopper_attention as ha

        B, N, E = q.shape
        self.lib = _build.load("pair_bias_attention")
        self.inputs, self.bias, self.logits = (q, k, v), bias, logits
        self.cots = (g_out, g_logits)
        self.drop = ha._dropout_args(seed, rate, q.device, H)
        self.tail = (B, N, H, E // H, 1, 1, torch.cuda.current_stream(q.device).cuda_stream)
        self.out, self.new_logits = torch.empty_like(q), torch.empty_like(bias)
        self.grads = [torch.empty_like(t) for t in (q, k, v, bias)]
        self.ws = torch.empty((B, H, N, 3), dtype=torch.float32, device=q.device)

    def fwd(self):
        rc = self.lib.mmdti_pair_bias_attention_fwd(
            *(t.data_ptr() for t in (*self.inputs, self.bias, self.out, self.new_logits)),
            *self.drop, *self.tail)
        if rc:
            raise Failed(f"pair-bias row forward failed with cudaError_t {rc}")

    def bwd(self, logits=None):
        rc = self.lib.mmdti_pair_bias_attention_bwd(
            *(t.data_ptr() for t in self.inputs), (self.logits if logits is None
                                                   else logits).data_ptr(),
            *(None if t is None else t.data_ptr() for t in self.cots),
            *(t.data_ptr() for t in (*self.grads, self.ws)), *self.drop, *self.tail)
        if rc:
            raise Failed(f"pair-bias row backward failed with cudaError_t {rc}")

    def fwd_bwd(self):
        self.fwd()
        self.bwd(self.new_logits)


class _PairSdpa:
    """SDPA with the pair bias as a float attn_mask on the same inputs."""

    def __init__(self, q, k, v, bias, g_out, rate):
        B, N, E = q.shape
        H = bias.shape[1]
        self.leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        self.heads = [t.view(B, N, H, E // H).transpose(1, 2) for t in self.leaves[:3]]
        self.g = g_out.view(B, N, H, E // H).transpose(1, 2)
        self.rate = rate

    def fwd(self):
        import torch.nn.functional as F

        return F.scaled_dot_product_attention(*self.heads, attn_mask=self.leaves[3],
                                              dropout_p=self.rate)

    def fwd_bwd(self):
        import torch

        return torch.autograd.grad(self.fwd(), self.leaves, self.g)


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)
    return out


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_build():
    """nvcc builds the CUDA libraries, g++ the host chemistry library
    (csrc/mmchem.cpp), all at once; returns {"native_s", "native_path"}."""
    import concurrent.futures

    from mmdti_tpu_torch.ops import _build

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(_timed, _build.build_host_library, "mmchem")
        paths, secs = _timed(_build.build_all)
        native_path, native_s = native.result()
    print(f"build: {len(paths)} libraries in {secs:.1f} s ({_build.BUILD_DIR})", flush=True)
    for name in paths:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            regs = [ln.strip() for ln in f if "registers" in ln]
        print(f"build: {name}: {len(regs)} kernel variants, e.g. {regs[:1]}", flush=True)
    print(f"build: {os.path.basename(native_path)} (g++ {' '.join(_build.HOST_CXX_FLAGS)}) "
          f"in {native_s:.2f} s, beside the nvcc builds", flush=True)
    return {"native_s": native_s, "native_path": native_path}


def _padded_lengths(gen, B, N):
    import torch

    return torch.randint(max(2, N // 2), N + 1, (B,), generator=gen)


class _Recorder:
    """Prints one line per case and keeps, per kernel, the largest error and
    the numbers of its main case (B=32 at the N=L=64 train shape, bf16,
    dropout on where the kernel takes it)."""

    def __init__(self):
        self.summary, self.failures = {}, []

    def __call__(self, kernel, case, prec, errs, ms, plain_ms, library_ms, bound, main,
                 extra=None):
        line = {"kernel": kernel, "case": case, "precision": prec, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound[0],
                "bound_by": bound[1], **(extra or {})}
        for what, (err, tol, ok) in errs.items():
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
            if not ok:
                self.failures.append(f"{kernel} {case} {prec} {what}: err {err} tol {tol}")
        print("kernel: " + json.dumps(line), flush=True)
        s = self.summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], *(e for e, _, _ in errs.values()))
        if main:
            s.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
                     bound_by=bound[1], **{k: v for k, v in line.items() if k in SUMMARY_EXTRAS})
            if "route" in line:
                s["dtype_route"] = line["route"]


def _pair_bias_cases(dev, gen, seed, record, B=32, H=64, D=8, Ns=(64, 280),
                     precisions=("fp32", "bf16"), rates=(0.0, DROPOUT)):
    """Pair-bias attention forward and backward against their plain
    versions, by default at the flagship's B=32, H=64, D=8, N=64 and 280,
    in fp32 and bf16, dropout 0 and 0.1.
    bf16 runs the tensor-core route (its forward also returns the row
    stats, its backward is one launch from out and the stats); fp32 the row
    kernels.  Beside the bf16 route's device times: the row kernels at the
    same bf16 inputs (the route it replaced) and SDPA with the bias as a
    float attn_mask, a partial yardstick only (it writes no logits and takes
    no logits cotangent)."""
    import torch

    from mmdti_tpu_torch.ops import dropout as drop
    from mmdti_tpu_torch.ops import hopper_attention as ha

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for N in Ns:
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        q, k, v, g_out = (randn(B, N, H * D) for _ in range(4))
        bias = randn(B, H, N, N).masked_fill(pad[:, None, None, :], float("-inf"))
        g_logits = randn(B, H, N, N)
        kf = float(drop.keep_mask(int(seed), DROPOUT, B, H, N, N, device=dev).float().mean())
        for prec in precisions:
            dt = dtypes[prec]
            s, p = BYTES[prec], BYTES[prec]
            mma = prec == "bf16"
            args = [t.to(dt).contiguous() for t in (q, k, v, bias)]
            go = g_out.to(dt)
            fwd_bound = _bound(4 * B * N * H * D * s + 2 * B * H * N * N * p,
                               4 * B * H * N * N * D, prec)
            case = f"B={B} N={N} H={H} D={D}"
            for rate in rates:
                sd = seed if rate else None

                def fwd():
                    return ha.pair_bias_attention_cuda(*args, H, sd, rate)

                def plain_fwd():
                    return ha.pair_bias_attention_plain(*args, H, dt, sd, rate)

                out, logits, stats = fwd()
                want_o, want_l, want_s = plain_fwd()
                torch.cuda.synchronize()
                errs = {}
                for what, got, want in (("out", out, want_o), ("logits", logits, want_l)):
                    atol, rtol = TOL[prec][what]
                    e, ok = _err(got, want, atol, rtol)
                    errs[what] = (e, atol if not rtol else [atol, rtol], ok)
                if mma:
                    errs.update(_pair_stats_errs(logits, stats, want_s))
                ms = _time_ms(fwd)
                pms = _time_ms(plain_fwd, iters=10)
                extra = {"route": ha.pair_bias_route(dt, dt)}
                if rate:
                    extra.update(keep_fraction=kf, keep_expected=1 - DROPOUT)
                if mma:
                    rows = _PairRows(*args, logits, go, g_logits.to(dt), H, sd, rate)
                    sdpa = _PairSdpa(*args, go, rate)
                    with torch.no_grad():
                        extra.update(device_ms=_device_ms(fwd), rows_device_ms=_device_ms(rows.fwd),
                                     sdpa_device_ms=_device_ms(sdpa.fwd))
                    extra["sdpa_is"] = SDPA_PAIR_IS
                record("pair_bias_attention", f"{case} dropout={rate}", prec, errs, ms, pms, None,
                       fwd_bound, N == 64 and B == 32 and mma and rate > 0, extra)

                for gl in (g_logits.to(dt), None):
                    n_pair = 3 if gl is not None else 2
                    bwd_bound = _bound(7 * B * N * H * D * s + n_pair * B * H * N * N * p,
                                       8 * B * H * N * N * D, prec)
                    # the backward from the plain forward's logits (and out and stats)
                    rest = (go, gl, H, sd, rate)

                    def bwd():
                        return ha.pair_bias_attention_bwd_cuda(*args[:3], want_l, want_o, want_s,
                                                               *rest)

                    def plain_bwd():
                        if mma:
                            return ha.pair_bias_attention_stats_bwd_plain(
                                *args[:3], want_l, want_o, want_s, *rest)
                        return ha.pair_bias_attention_bwd_plain(*args[:3], want_l, *rest)

                    def ours_fwd_bwd():
                        o, lg, st = fwd()
                        return ha.pair_bias_attention_bwd_cuda(*args[:3], lg, o, st, *rest)

                    got = bwd()
                    again = bwd()
                    oracle = ha.pair_bias_attention_bwd_plain(*args[:3], want_l, *rest)
                    torch.cuda.synchronize()
                    names = ("dq", "dk", "dv", "dbias")
                    errs = _grad_errs(names, got, oracle, prec)
                    if mma:
                        errs.update({f"{n}_vs_stats_plain": e for n, e in _grad_errs(
                            names, got, plain_bwd(), prec).items()})
                    bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
                    if not bit_equal:
                        record.failures.append(f"pair_bias_attention_bwd {case} {prec}: "
                                               f"repeated calls differ")
                    ms = _time_ms(bwd)
                    pms = _time_ms(plain_bwd, iters=10)
                    extra = {"route": ha.pair_bias_route(dt, dt), "repeat_bit_equal": bit_equal}
                    if mma:
                        rows = _PairRows(*args, want_l, go, gl, H, sd, rate)
                        extra.update(device_ms=_device_ms(bwd),
                                     fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                                     rows_device_ms=_device_ms(rows.bwd),
                                     rows_fwd_bwd_device_ms=_device_ms(rows.fwd_bwd),
                                     sdpa_fwd_bwd_device_ms=_device_ms(
                                         _PairSdpa(*args, go, rate).fwd_bwd),
                                     sdpa_is=SDPA_PAIR_IS)
                    record("pair_bias_attention_bwd",
                           f"{case} dropout={rate} g_logits={gl is not None}", prec, errs, ms,
                           pms, None, bwd_bound,
                           N == 64 and B == 32 and mma and rate > 0 and gl is not None, extra)


class _GbfFma:
    """The FMA-unit gbf kernels, the route bf16 took before the tensor-core
    kernels, launched through their C entry points with bf16 compute on the
    same inputs for device times beside the "mma" route (not counted as
    launches); the timed cases also hold their results to the plain versions."""

    def __init__(self, u, means, std, w1, b1, w2, b2, pad, g, act, pair_dtype):
        import torch

        from mmdti_tpu_torch.ops import _build
        from mmdti_tpu_torch.ops import hopper_gbf as hg

        B, N, _ = u.shape
        K, H = means.shape[0], w2.shape[0]
        dev = u.device
        self.lib = _build.load("gbf_proj")
        self.out = torch.empty((B, H, N, N), dtype=pair_dtype, device=dev)
        self.du = torch.empty_like(u)
        self.K, self.H, self.sizes = K, H, (K * K, H * K, K, H, K, K)
        self.grads = torch.empty(sum(self.sizes), dtype=torch.float32, device=dev)
        self.max_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        self.partials = torch.empty(self.max_blocks * sum(self.sizes), dtype=torch.float32,
                                    device=dev)
        self.ins = [t.data_ptr() for t in (u, means, std, w1, b1, w2)]
        self.b2, self.pad, self.g = b2.data_ptr(), pad.data_ptr(), g.data_ptr()
        self.shape = (B, N, K, K, H, 1)
        self.tail = (int(pair_dtype == torch.bfloat16), hg.ACTIVATIONS[act], hg.SQRT_2PI,
                     torch.cuda.current_stream(dev).cuda_stream)

    def fwd(self):
        rc = self.lib.mmdti_gbf_proj_fwd(*self.ins, self.b2, self.pad, self.out.data_ptr(),
                                         *self.shape, *self.tail)
        if rc:
            raise Failed(f"gbf FMA forward failed with cudaError_t {rc}")

    def grad_tuple(self):
        """The last backward's gradients in gbf_pair_bias_bwd_plain's order."""
        import torch

        dw1, dw2, db1, db2, dmeans, dstd = torch.split(self.grads, self.sizes)
        return self.du, dmeans, dstd, dw1.view(self.K, self.K), db1, dw2.view(self.H, self.K), db2

    def bwd(self):
        rc = self.lib.mmdti_gbf_proj_bwd(*self.ins, self.pad, self.g, self.du.data_ptr(),
                                         self.grads.data_ptr(), self.partials.data_ptr(),
                                         self.max_blocks, *self.shape, *self.tail)
        if rc:
            raise Failed(f"gbf FMA backward failed with cudaError_t {rc}")


class _GbfUnfused:
    """The gbf function unfused in PyTorch: G [B,N,N,K] materialized and
    rounded to bf16, the two layers as bf16 torch.matmul, the padding merge
    and the permute to [B,H,N,N]; forward, and forward + autograd backward."""

    def __init__(self, u, means, std, w1, b1, w2, b2, pad, g, act, pair_dtype):
        import torch

        bf = torch.bfloat16
        self.leaves = [t.detach().clone().requires_grad_()
                       for t in (u, means, std, w1.to(bf), b1.to(bf), w2.to(bf), b2.to(bf))]
        self.pad, self.g, self.act, self.pair = pad[:, None, None, :], g, act, pair_dtype

    def fwd(self):
        import torch

        from mmdti_tpu_torch.ops import hopper_gbf as hg

        u, means, std, w1, b1, w2, b2 = self.leaves
        gk = hg.gaussian_pdf(u[..., None], means, std).to(torch.bfloat16)
        h = hg._act(self.act, torch.matmul(gk, w1.t()) + b1)
        o = (torch.matmul(h, w2.t()) + b2).permute(0, 3, 1, 2)
        return o.masked_fill(self.pad, float("-inf")).to(self.pair).contiguous()

    def fwd_bwd(self):
        import torch

        return torch.autograd.grad(self.fwd(), self.leaves, self.g)


def _sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def _gbf_cases(dev, gen, record, B=32, K=128, cases=None):
    """The fused Gaussian + gbf_proj forward and backward against their plain
    versions at B=32, K=Kh=128, padded keys.  fp32 runs the FMA route; bf16
    the tensor-core route at N=64, 280 and 65 (no 16-byte alignment), both
    activations, H=64 and, at N=64, 96.  Weights and biases are drawn at
    0.1 and stds from U[0.5, 3), as tests/test_torch_gpu.py draws them, so
    that the part of the output the two GEMMs make (printed as
    gemm_part_rms / _max) is several times the bf16 tolerance, which is
    absolute: a wrong Gaussian, activation or GEMM shows on most elements,
    while |out| stays below 1, where one bf16 step of the output is well
    inside that tolerance.  Beside the main bf16 cases' device times: the
    FMA kernels on the same bf16 inputs (also held to the plain versions),
    the function unfused in bf16 PyTorch (a partial yardstick) and the
    special-function floor (K ex2 and, for the tanh gelu, Kh tanh a pair at
    16 a clock an SM; in the case line only, since it is computed, not
    measured)."""
    import torch

    from mmdti_tpu_torch.ops import hopper_gbf as hg

    sfu_per_s = 16 * torch.cuda.get_device_properties(dev).multi_processor_count * _sm_clock_hz()
    if cases is None:   # (N, H, activation, precision)
        cases = [(N, 64, "gelu_tanh", "fp32") for N in (64, 280)]
        cases += [(N, 64, act, "bf16") for N in (64, 280, 65) for act in ("gelu_tanh", "gelu")]
        cases += [(64, 96, "gelu_tanh", "bf16")]
        # a tensor-parallel rank's heads
        cases += [(N, H, act, "bf16") for H in TP_GBF_HEADS for N in (64, 280)
                  for act in ("gelu_tanh", "gelu")]
    params = {}
    for N, H, act, prec in cases:
        dt = torch.float32 if prec == "fp32" else torch.bfloat16
        if H not in params:
            params[H] = (torch.rand(K, generator=gen).mul(3).to(dev),
                         torch.rand(K, generator=gen).mul(2.5).add(0.5).to(dev),
                         torch.randn(K, K, generator=gen).mul(0.1).to(dev),
                         torch.randn(K, generator=gen).mul(0.1).to(dev),
                         torch.randn(H, K, generator=gen).mul(0.1).to(dev),
                         torch.randn(H, generator=gen).mul(0.1).to(dev))
        means, stds, w1, b1, w2, b2 = params[H]
        std = stds.abs() + 1e-5
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
        g = torch.randn(B, H, N, N, generator=gen).to(dev).to(dt)
        P = B * N * N
        route = hg.gbf_route(dt, K, K, H)
        timed = prec == "bf16" and act == "gelu_tanh" and N != 65 and H == 64
        main = N == 64 and B == 32 and timed
        # a tensor-parallel rank's widths: the FMA kernels' device times beside
        fma_timed = timed or (prec == "bf16" and act == "gelu_tanh" and H in TP_GBF_HEADS)
        case = f"B={B} N={N} K={K} H={H} {act} padded keys"
        sfu = P * (2 * K if act == "gelu_tanh" else K) / sfu_per_s * 1e3

        args = (u, means, stds, w1, b1, w2, b2, pad)
        kw = dict(activation=act, pair_dtype=dt, compute_dtype=dt)

        def fwd():
            return hg.gbf_pair_bias_fused(*args, **kw)

        def plain_fwd():
            return hg.gbf_pair_bias_plain(*args, **kw)

        got, want = fwd(), plain_fwd()
        torch.cuda.synchronize()
        atol, rtol = TOL[prec]["out"]
        e, ok = _err(got, want, atol, rtol)
        errs = {"out": (e, atol, ok)}
        fin = torch.isfinite(want)
        gemm_part = (want.float() - b2[None, :, None, None])[fin]
        extra = {"route": route, "device_ms": _device_ms(fwd),
                 "gemm_part_rms": float(gemm_part.square().mean().sqrt()),
                 "gemm_part_max": float(gemm_part.abs().max())}
        if extra["gemm_part_rms"] < 2 * atol:
            record.failures.append(f"gbf_proj {case} {prec}: the GEMM part of the output "
                                   f"(rms {extra['gemm_part_rms']}) is within twice the "
                                   f"tolerance {atol}: the check cannot tell a wrong kernel")
        if fma_timed:
            fma = _GbfFma(u, means, std, w1, b1, w2, b2, pad, g, act, dt)
            fma.fwd()
            torch.cuda.synchronize()
            e_fma, ok_fma = _err(fma.out, want, atol, rtol)
            errs["fma_out"] = (e_fma, atol, ok_fma)
            # at a tensor-parallel rank's widths timed with CUDA events (fewer
            # profiler windows in the process)
            extra.update(sfu_floor_ms=sfu, **({"fma_device_ms": _device_ms(fma.fwd)} if timed
                                              else {"fma_ms": _time_ms(fma.fwd)}))
        if timed:
            unfused = _GbfUnfused(u, means, std, w1, b1, w2, b2, pad, g, act, dt)
            with torch.no_grad():
                extra.update(unfused_device_ms=_device_ms(unfused.fwd, n=5))
            extra.update(unfused_is=GBF_UNFUSED_IS)
        record("gbf_proj", case, prec, errs, _time_ms(fwd),
               _time_ms(plain_fwd, iters=10), None,
               _bound(P * (4 + H * BYTES[prec]), 2 * P * (K * K + K * H), prec), main, extra)

        bargs = (u, means, std, w1, b1, w2, g, pad, act, dt)

        def bwd():
            return hg.gbf_pair_bias_bwd_cuda(*bargs)

        def plain_bwd():
            return hg.gbf_pair_bias_bwd_plain(*bargs)

        got, again, want = bwd(), bwd(), plain_bwd()
        torch.cuda.synchronize()
        errs = _grad_errs(("du", "dmeans", "dstd", "dw1", "db1", "dw2", "db2"), got, want, prec)
        bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        if not bit_equal:
            record.failures.append(f"gbf_proj_bwd {case} {prec}: repeated calls differ")
        extra = {"route": route, "repeat_bit_equal": bit_equal, "device_ms": _device_ms(bwd)}
        if fma_timed:
            fma.bwd()
            torch.cuda.synchronize()
            errs.update(_grad_errs(("fma_du", "fma_dmeans", "fma_dstd", "fma_dw1", "fma_db1",
                                    "fma_dw2", "fma_db2"), fma.grad_tuple(), want, prec))
            extra.update(sfu_floor_ms=sfu, **({"fma_device_ms": _device_ms(fma.bwd)} if timed
                                              else {"fma_ms": _time_ms(fma.bwd)}))
        if timed:
            extra.update(unfused_fwd_bwd_device_ms=_device_ms(unfused.fwd_bwd, n=5),
                         unfused_is=GBF_UNFUSED_IS)
        record("gbf_proj_bwd", case, prec, errs, _time_ms(bwd), _time_ms(plain_bwd, iters=10),
               None, _bound(P * (8 + H * BYTES[prec]), 2 * P * (3 * K * K + 2 * K * H), prec),
               main, extra)


def _extract_keep(run, B, H, Nq, Nk, D):
    """The keep mask [B,H,Nq,Nk] an attention kernel drew, entry by entry:
    with q = k = 0 and a zero bias every probability is 1/Nk, so with v
    the unit vector e_d at key c*D + d (zero elsewhere) the output's column
    d is keep[..., c*D + d] * scale / Nk.  ``run(v)`` returns the forward's
    out [B,Nq,H*D] for v [B,Nk,H*D]; one call per D keys."""
    import torch

    keep = torch.zeros(B, H, Nq, Nk, dtype=torch.bool)
    eye = torch.eye(D)
    for c in range(0, Nk, D):
        v = torch.zeros(B, Nk, H, D)
        n = min(D, Nk - c)
        v[:, c:c + n] = eye[:n][None, :, None, :]
        out = run(v.view(B, Nk, H * D)).float().view(B, Nq, H, D).cpu()
        keep[..., c:c + n] = out.permute(0, 2, 1, 3)[..., :n] > 0.5 / Nk
    return keep


def _head_offset_cases(dev, gen, seed, record):
    """The attention kernels on a tensor-parallel rank's heads: the second
    half of a layer's heads (h0 = H, H_total = 2H) at B=8, N=64, dropout
    0.1, bf16 (tensor cores) and fp32 (row kernels): pair-bias at 32 of 64
    heads (D=8), masked at ChemBERTa's 4 of 8 (D=64) and the cross-modal
    layer's 8 of 16 (D=32).  Forward and backward against their plain
    versions at the same offset, and the keep mask each forward drew,
    entry by entry (_extract_keep), against ops/dropout.py's at the offset
    (and unequal to the mask of the first heads)."""
    import torch

    from mmdti_tpu_torch.ops import dropout as drop
    from mmdti_tpu_torch.ops import hopper_attention as ha

    B, N = 8, 64
    for kind, H, D in (("pair_bias", 32, 8), ("masked", 4, 64), ("masked", 8, 32)):
        span = (H, 2 * H)
        want_keep = drop.keep_mask(seed, DROPOUT, B, 2 * H, N, N, heads=slice(H, 2 * H),
                                   device=dev).cpu()
        first_keep = drop.keep_mask(seed, DROPOUT, B, 2 * H, N, N, heads=slice(0, H),
                                    device=dev).cpu()
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        q, k, v, g = (torch.randn(B, N, H * D, generator=gen).to(dev) for _ in range(4))
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = [t.to(dt).contiguous() for t in (q, k, v)]
            go = g.to(dt)
            case = f"{kind} B={B} N={N} H={H} of {2 * H} (h0={H}) D={D} dropout={DROPOUT}"
            zeros = torch.zeros(B, N, H * D, dtype=dt, device=dev)
            if kind == "pair_bias":
                bias = torch.randn(B, H, N, N, generator=gen).to(dev).masked_fill(
                    pad[:, None, None, :], float("-inf")).to(dt)
                gl = torch.randn(B, H, N, N, generator=gen).to(dev).to(dt)
                out, logits, stats = ha.pair_bias_attention_cuda(*args, bias, H, seed, DROPOUT,
                                                                 span)
                w_out, w_logits, w_stats = ha.pair_bias_attention_plain(*args, bias, H, dt, seed,
                                                                        DROPOUT, span)
                rest = (go, gl, H, seed, DROPOUT, span)
                grads = ha.pair_bias_attention_bwd_cuda(*args, w_logits, w_out, w_stats, *rest)
                oracle = ha.pair_bias_attention_bwd_plain(*args, w_logits, *rest)
                names = ("dq", "dk", "dv", "dbias")
                zero_bias = torch.zeros(B, H, N, N, dtype=dt, device=dev)

                def run(vv):
                    return ha.pair_bias_attention_cuda(zeros, zeros, vv.to(dev, dt), zero_bias,
                                                       H, seed, DROPOUT, span)[0]
            else:
                mask = pad.float() * torch.finfo(torch.float32).min
                out, stats = ha.masked_attention_cuda(*args, mask, H, seed, DROPOUT, span)
                w_out, w_stats = ha.masked_attention_plain(*args, mask, H, seed, DROPOUT, span)
                grads = ha.masked_attention_bwd_cuda(*args, mask, w_out, w_stats, go, H, seed,
                                                     DROPOUT, span)
                oracle = ha.masked_attention_bwd_plain(*args, mask, go, H, seed, DROPOUT, span)
                names = ("dq", "dk", "dv")
                zero_mask = torch.zeros(B, N, dtype=torch.float32, device=dev)

                def run(vv):
                    return ha.masked_attention_cuda(zeros, zeros, vv.to(dev, dt), zero_mask, H,
                                                    seed, DROPOUT, span)[0]
            torch.cuda.synchronize()
            atol, rtol = TOL[prec]["out"]
            e, ok = _err(out, w_out, atol, rtol)
            errs = {"out": (e, atol, ok), **_grad_errs(names, grads, oracle, prec)}
            got_keep = _extract_keep(run, B, H, N, N, D)
            mismatched = int((got_keep != want_keep).sum())
            errs["keep_mask_mismatches"] = (mismatched, 0, mismatched == 0)
            same_as_first = bool(torch.equal(got_keep, first_keep))
            if same_as_first:
                record.failures.append(f"{kind} {case} {prec}: the mask at h0={H} is the first "
                                       f"heads' mask")
            record(f"{kind}_attention_head_offset", case, prec, errs, None, None, None,
                   (None, None), False, {"route": ha.masked_route(dt),
                                         "keep_entries": got_keep.numel(),
                                         "keep_fraction": float(got_keep.float().mean())})


def phase_kernels(dev):
    """Each kernel vs its plain version; returns per-kernel summaries."""
    import torch
    import torch.nn.functional as F

    from mmdti_tpu_torch.ops import dropout as drop
    from mmdti_tpu_torch.ops import hopper_attention as ha

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(1234)
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    record = _Recorder()
    precisions = (("fp32", torch.float32), ("bf16", torch.bfloat16))

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def keep_fraction(B, H, Nq, Nk):
        return float(drop.keep_mask(int(seed), DROPOUT, B, H, Nq, Nk, device=dev).float().mean())

    _pair_bias_cases(dev, gen, seed, record)
    _gbf_cases(dev, gen, record)
    _head_offset_cases(dev, gen, seed, record)

    # ---- masked attention, B=32: ChemBERTa (H=8, D=64), cross-modal (H=16, D=32)
    # bf16 runs the tensor-core route (its forward also returns the row
    # stats, and its backward starts from out and the stats); fp32 the row
    # kernels.  Both backwards are also held to the recompute oracle.
    cases = [
        ("chemberta", 8, 64, 64, 64, torch.finfo(torch.float32).min),
        ("chemberta", 8, 64, 512, 512, torch.finfo(torch.float32).min),
        ("crossmodal", 16, 32, 64, 64, -10000.0),
        ("crossmodal", 16, 32, 280, 512, -10000.0),
    ]
    B = 32
    for label, Hm, Dm, Nq, Nk, fill in cases:
        lens = _padded_lengths(gen, B, Nk)
        mask = ((torch.arange(Nk)[None, :] >= lens[:, None]).float() * fill).to(dev)
        q, g_out = randn(B, Nq, Hm * Dm), randn(B, Nq, Hm * Dm)
        k, v = randn(B, Nk, Hm * Dm), randn(B, Nk, Hm * Dm)
        kf = keep_fraction(B, Hm, Nq, Nk)
        main_shape = label == "chemberta" and Nq == 64
        for prec, dt in precisions:
            s = BYTES[prec]
            mma = prec == "bf16"
            args = [t.to(dt).contiguous() for t in (q, k, v)] + [mask]
            go = g_out.to(dt)
            leaves = [t.detach().clone().requires_grad_() for t in args[:3]]
            heads = [t.view(B, -1, Hm, Dm).transpose(1, 2) for t in leaves]
            go_heads = go.view(B, Nq, Hm, Dm).transpose(1, 2)
            sdpa_mask = mask.to(dt)[:, None, None, :]
            tokens = 2 * B * Nq * Hm * Dm + 2 * B * Nk * Hm * Dm
            # backward bytes: the function's own, q, g_out, dq and k, v, dk, dv
            # and the mask (not the out and row stats the mma route reads)
            bwd_bytes = (2 * tokens - B * Nq * Hm * Dm) * s + 4 * B * Nk
            case = f"{label} B={B} Nq={Nq} Nk={Nk} H={Hm} D={Dm}"
            for rate in (0.0, DROPOUT):
                sd = seed if rate else None

                def fwd():
                    return ha.masked_attention_cuda(*args, Hm, sd, rate)

                def plain_fwd():
                    return ha.masked_attention_plain(*args, Hm, sd, rate)

                def sdpa():
                    return F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask,
                                                          dropout_p=rate)

                def sdpa_fwd_bwd():
                    return torch.autograd.grad(sdpa(), leaves, go_heads)

                got, stats = fwd()
                want, want_stats = plain_fwd()
                torch.cuda.synchronize()
                atol, rtol = TOL[prec]["out"]
                e, ok = _err(got, want, atol, rtol)
                errs = {"out": (e, atol, ok)}
                if mma:   # the row stats: guarded max (abs) and 1/rowsum (rel)
                    e, ok = _err(stats[..., 0], want_stats[..., 0], 1e-3, 0.0)
                    errs["stats_max"] = (e, 1e-3, ok)
                    rel = float(((stats[..., 1] - want_stats[..., 1]).abs()
                                 / want_stats[..., 1]).max())
                    errs["stats_inv_rel"] = (rel, 1e-3, rel <= 1e-3)
                ms = _time_ms(fwd)
                pms = _time_ms(plain_fwd, iters=10)
                with torch.no_grad():
                    lms = _time_ms(sdpa)
                extra = {"route": ha.masked_route(dt)}
                if rate:
                    extra.update(keep_fraction=kf, keep_expected=1 - DROPOUT)
                if mma:
                    with torch.no_grad():
                        extra.update(device_ms=_device_ms(fwd), library_device_ms=_device_ms(sdpa))
                record("masked_attention", f"{case} dropout={rate}", prec, errs, ms, pms, lms,
                       _bound(tokens * s + 4 * B * Nk, 4 * B * Hm * Nq * Nk * Dm, prec),
                       main_shape and mma and rate > 0, extra)

                # the backward from the plain forward's out and stats
                bargs = (*args, want, want_stats, go, Hm, sd, rate)

                def bwd():
                    return ha.masked_attention_bwd_cuda(*bargs)

                def plain_bwd():
                    if mma:
                        return ha.masked_attention_stats_bwd_plain(*bargs)
                    return ha.masked_attention_bwd_plain(*args, go, Hm, sd, rate)

                def ours_fwd_bwd():
                    o, st = fwd()
                    return ha.masked_attention_bwd_cuda(*args, o, st, go, Hm, sd, rate)

                got = bwd()
                again = bwd()
                oracle = ha.masked_attention_bwd_plain(*args, go, Hm, sd, rate)
                torch.cuda.synchronize()
                errs = _grad_errs(("dq", "dk", "dv"), got, oracle, prec)
                if mma:
                    errs.update({f"{n}_vs_stats_plain": e for n, e in _grad_errs(
                        ("dq", "dk", "dv"), got, plain_bwd(), prec).items()})
                bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
                if not bit_equal:
                    record.failures.append(f"masked_attention_bwd {case} {prec}: repeated "
                                           f"calls differ")
                ms = _time_ms(bwd)
                pms = _time_ms(plain_bwd, iters=10)
                lms = _time_ms(sdpa_fwd_bwd)
                extra = {"route": ha.masked_route(dt), "repeat_bit_equal": bit_equal,
                         "fwd_bwd_ms": _time_ms(ours_fwd_bwd),
                         "library_is": "SDPA forward + autograd backward"}
                if mma:
                    extra.update(device_ms=_device_ms(bwd),
                                 fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                                 library_device_ms=_device_ms(sdpa_fwd_bwd))
                record("masked_attention_bwd", f"{case} dropout={rate}", prec, errs, ms, pms,
                       lms, _bound(bwd_bytes, 10 * B * Hm * Nq * Nk * Dm, prec),
                       main_shape and mma and rate > 0, extra)
    _layer_norm_cases(dev, gen, record)
    # phase mof's shapes: B=16 crystals at N=528 (512 atoms, BOS, EOS, padded
    # to 16), bf16 as the fit runs them; LayerNorm over its 16 x 528 rows
    _pair_bias_cases(dev, gen, seed, record, B=MOF_BATCH, Ns=(MOF_PAD,), precisions=("bf16",),
                     rates=(DROPOUT,))
    _gbf_cases(dev, gen, record, B=MOF_BATCH, cases=[(MOF_PAD, 64, "gelu_tanh", "bf16")])
    _layer_norm_cases(dev, gen, record, Ts=(MOF_BATCH * MOF_PAD,),
                      dts=(("bf16", torch.bfloat16),), epss=(1e-5,))
    print("kernels: " + json.dumps({"profiler_windows_rejected": len(REJECTED_WINDOWS),
                                     "rejected": REJECTED_WINDOWS}), flush=True)
    if record.failures:
        raise Failed("kernel mismatch: " + "; ".join(record.failures))
    return record.summary


def _layer_norm_cases(dev, gen, record, Ts=(2048, 8960), dts=None, epss=(1e-5, 1e-12)):
    """LayerNorm forward and backward against their plain versions (by
    default at T=2048 and 8960, x and y in fp32 and bf16, eps 1e-5 and
    1e-12); the
    library yardstick is F.layer_norm in x's dtype (its variance is the
    two-pass one), forward alone and forward plus backward.  Every backward
    must be one launch, and repeat bit for bit, also after a call at
    another T; the main cases (bf16 x and y, eps 1e-5, both T) carry the
    earlier kernels' times (LN_EARLIER)."""
    import torch
    import torch.nn.functional as F

    from mmdti_tpu_torch.ops import hopper_ln as hl

    dts = dts or (("fp32", torch.float32), ("bf16", torch.bfloat16))
    E = 512
    for T in Ts:      # B=32 at N=64 and at the top atom bucket N=280; B=16 at MOF's N=528
        x0 = torch.randn(T, E, generator=gen).to(dev)
        gy0 = torch.randn(T, E, generator=gen).to(dev)
        w = (torch.rand(E, generator=gen) + 0.5).to(dev)
        b = (torch.randn(E, generator=gen) * 0.1).to(dev)
        for xp, xd in dts:
            x = x0.to(xd)
            for yp, yd in dts:
                gy = gy0.to(yd)
                coarse = "bf16" if "bf16" in (xp, yp) else "fp32"
                for eps in epss:
                    case = f"T={T} E={E} x={xp} y={yp} eps={eps}"
                    main = T == 2048 and xp == yp == "bf16" and eps == 1e-5
                    timed = xp == yp == "bf16" and eps == 1e-5 and ("layer_norm", T) in LN_EARLIER
                    y = hl.layer_norm_cuda(x, w, b, eps, yd)
                    want = hl.layer_norm_plain(x, w, b, eps, yd)
                    torch.cuda.synchronize()
                    atol, rtol = LN_FWD_TOL[yp]
                    e, ok = _err(y, want, atol, rtol)
                    ms = _time_ms(lambda: hl.layer_norm_cuda(x, w, b, eps, yd))
                    pms = _time_ms(lambda: hl.layer_norm_plain(x, w, b, eps, yd), iters=10)
                    wl, bl = w.to(xd), b.to(xd)
                    lms = _time_ms(lambda: F.layer_norm(x, (E,), wl, bl, eps))
                    sx, sy = BYTES[xp], BYTES[yp]
                    extra = {}
                    if eps == 1e-5:
                        extra = {
                            "device_ms": _device_ms(lambda: hl.layer_norm_cuda(x, w, b, eps, yd)),
                            "plain_device_ms": _device_ms(
                                lambda: hl.layer_norm_plain(x, w, b, eps, yd)),
                            "library_device_ms": _device_ms(
                                lambda: F.layer_norm(x, (E,), wl, bl, eps))}
                    if timed:
                        extra["earlier_device_ms"], extra["earlier_ms"] = LN_EARLIER[
                            ("layer_norm", T)]
                        extra["host_us"] = _host_us(lambda: hl.layer_norm_cuda(x, w, b, eps, yd))
                        extra["library_host_us"] = _host_us(
                            lambda: F.layer_norm(x, (E,), wl, bl, eps))
                    record("layer_norm", case, f"x {xp} y {yp}", {"y": (e, [atol, rtol], ok)}, ms,
                           pms, lms,
                           _bound(T * E * (sx + sy) + 2 * E * 4, 8 * T * E, "fp32"), main,
                           extra)

                    n0 = hl.layer_norm_bwd_cuda.launches
                    got = hl.layer_norm_bwd_cuda(x, w, gy, eps)
                    launches_per_call = hl.layer_norm_bwd_cuda.launches - n0
                    again = hl.layer_norm_bwd_cuda(x, w, gy, eps)
                    other = hl.layer_norm_bwd_cuda(x[:LN_OTHER_T], w, gy[:LN_OTHER_T], eps)
                    after_other = hl.layer_norm_bwd_cuda(x, w, gy, eps)
                    ref = hl.layer_norm_bwd_plain(x, w, gy, eps)
                    other_ref = hl.layer_norm_bwd_plain(x[:LN_OTHER_T], w, gy[:LN_OTHER_T], eps)
                    torch.cuda.synchronize()
                    errs = {}
                    for name, g, r, go, ro in zip(("dx", "dscale", "dbias"), got, ref, other,
                                                  other_ref):
                        gtol = LN_FWD_TOL[coarse][0] * max(1.0, float(r.float().abs().max()))
                        e, ok = _err(g, r, gtol, 0.0)
                        errs[name] = (e, gtol, ok)
                        otol = LN_FWD_TOL[coarse][0] * max(1.0, float(ro.float().abs().max()))
                        e, ok = _err(go, ro, otol, 0.0)
                        errs[f"{name}_T{LN_OTHER_T}"] = (e, otol, ok)
                    bit_equal = all(torch.equal(g, a) for g, a in zip(got, again))
                    bit_equal_after_other_t = all(torch.equal(g, a)
                                                  for g, a in zip(got, after_other))
                    if not (bit_equal and bit_equal_after_other_t):
                        record.failures.append(
                            f"layer_norm_bwd {case}: repeated calls differ (at once "
                            f"{bit_equal}, after T={LN_OTHER_T} {bit_equal_after_other_t})")
                    if launches_per_call != 1:
                        record.failures.append(f"layer_norm_bwd {case}: {launches_per_call} "
                                               "launches a call")
                    ms = _time_ms(lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps))
                    pms = _time_ms(lambda: hl.layer_norm_bwd_plain(x, w, gy, eps), iters=10)
                    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, wl, bl))
                    gyx = gy.to(xd)
                    lms = _time_ms(lambda: torch.autograd.grad(
                        F.layer_norm(xr, (E,), wr, br, eps), (xr, wr, br), gyx))

                    def ours_fwd_bwd():
                        hl.layer_norm_cuda(x, w, b, eps, yd)
                        hl.layer_norm_bwd_cuda(x, w, gy, eps)

                    extra = {"repeat_bit_equal": bit_equal,
                             f"repeat_bit_equal_after_T{LN_OTHER_T}": bit_equal_after_other_t,
                             "launches_per_call": launches_per_call,
                             "fwd_bwd_ms": _time_ms(ours_fwd_bwd),
                             "library_is": "F.layer_norm forward + autograd backward"}
                    if eps == 1e-5:
                        kernels = {k: c for k, (c, _) in _call_kernels(
                            lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps), n=5).items()}
                        extra.update(
                            kernels_per_call=kernels,
                            device_ms=_device_ms(lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps)),
                            fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                            plain_device_ms=_device_ms(
                                lambda: hl.layer_norm_bwd_plain(x, w, gy, eps)),
                            library_device_ms=_device_ms(lambda: torch.autograd.grad(
                                F.layer_norm(xr, (E,), wr, br, eps), (xr, wr, br), gyx)))
                        if list(kernels.values()) != [1] or "reduce" in "".join(kernels):
                            record.failures.append(
                                f"layer_norm_bwd {case}: kernels of one call {kernels}")
                    if timed:
                        extra["earlier_device_ms"], extra["earlier_ms"] = LN_EARLIER[
                            ("layer_norm_bwd", T)]
                        extra["earlier_fwd_bwd_device_ms"] = LN_EARLIER_FWD_BWD[T]
                        extra["host_us"] = _host_us(lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps))
                        extra["fwd_bwd_host_us"] = _host_us(ours_fwd_bwd)
                        extra["library_fwd_bwd_host_us"] = _host_us(lambda: torch.autograd.grad(
                            F.layer_norm(xr, (E,), wr, br, eps), (xr, wr, br), gyx))
                    record("layer_norm_bwd", case, f"x {xp} y {yp}", errs, ms, pms, lms,
                           _bound(T * E * (2 * sx + sy) + 3 * E * 4, 14 * T * E, "fp32"), main,
                           extra)


def _write_serve_dir(path, seeds):
    """An experiment dir as MolTrain.fit writes it, through the port's own
    writers: config.yaml (MolTrain's config for a flagship bf16 regression,
    model_folds = len(seeds)) and model_{fold}.ckpt, fold f holding the
    flagship's weights drawn from seeds[f].  Returns (config, state dicts)."""
    import shutil

    import torch

    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.configs.config import save_yaml
    from mmdti_tpu_torch.models.convert import state_dict_to_flax_params
    from mmdti_tpu_torch.train.checkpointing import save_checkpoint

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    cfg = MolTrain(task="regression", metrics="mse", target_cols=["y"], compute_dtype="bfloat16",
                   use_scaler=False, save_path=path, device="cpu").config
    cfg.update(target_cols="y", num_classes=1, model_folds=len(seeds))
    save_yaml(cfg, os.path.join(path, "config.yaml"))
    state_dicts = []
    for fold, seed in enumerate(seeds):
        model = _flagship(True).reset_parameters_like_flax(torch.Generator().manual_seed(seed))
        state_dicts.append(model.state_dict())
        save_checkpoint(path, fold, state_dict_to_flax_params(state_dicts[-1]))
    return cfg, state_dicts


def _post(url, payload, timeout=300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start_http(srv):
    """(url, the server's thread) of an HTTP front started in a thread."""
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_port}", t


def _stop_http(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=60)
    if thread.is_alive():
        raise Failed("serve: the HTTP front did not stop")


def _timed_predicts(server, requests, times):
    """REPEATS predicts of each request size, host clock; appends ms to
    times[n]."""
    for n, smi in requests.items():
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            server.predict(smi)
            times[n].append((time.perf_counter() - t0) * 1e3)


def _alternated_p50(servers, requests, rounds=SERVE_ROUNDS):
    """p50 ms per server and request size over `rounds` rounds, the
    servers' order reversed each round (a, b, b, a); also each round's."""
    times = {name: {n: [] for n in requests} for name in servers}
    by_round = {name: [] for name in servers}
    names = list(servers)
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            start = {n: len(v) for n, v in times[name].items()}
            _timed_predicts(servers[name], requests, times[name])
            by_round[name].append({str(n): statistics.median(v[start[n]:])
                                   for n, v in times[name].items()})
    return ({name: {str(n): statistics.median(v) for n, v in t.items()}
             for name, t in times.items()}, by_round)


def _check_launches(counts, per_forward, forwards, what):
    for k, per in per_forward.items():
        if counts[k] != per * forwards:
            raise Failed(f"{what} {k}: {counts[k]} launches, expected {per} x {forwards}")


class _GateLog:
    """A lock that logs (thread, "acquired" | "released", time)."""

    def __init__(self, lock):
        self.lock, self.log = lock, []

    def locked(self):
        return self.lock.locked()

    def __enter__(self):
        import threading

        self.lock.acquire()
        self.log.append((threading.get_ident(), "acquired", time.perf_counter()))
        return self

    def __exit__(self, *exc):
        import threading

        self.log.append((threading.get_ident(), "released", time.perf_counter()))
        self.lock.release()

    def first(self, thread, what, after=0.0):
        return min(t for i, w, t in self.log if i == thread and w == what and t >= after)


def _capture_beside_pulls(srv, warm, cold):
    """A capture and the pull of an in-flight batch, made to meet both
    ways on one server, the pull gate logged: (1) a pull asked for while a
    capture records takes the gate only after the capture gives it back;
    (2) a capture asked for while a pull waits on the device (a spin
    kernel queued behind the batch) takes it only after the pull.  Returns
    what it saw; raises on a wrong row or an order that did not hold."""
    import threading

    import numpy as np
    import torch

    want = srv.predict(warm)["predict"]
    # the conformer refinement's graphs record under the same gate
    gate = srv._pull_gate = srv.conformer.capture_gate = _GateLog(srv._pull_gate)
    me = threading.get_ident()

    def wait_locked():
        deadline = time.monotonic() + 120
        while not gate.locked() and time.monotonic() < deadline:
            time.sleep(0.0002)
        return time.perf_counter()

    try:
        # (1) a capture in thread t holds the gate; then this thread pulls
        chunks, feats = srv._dispatch_forward(warm)
        out = {}
        t = threading.Thread(target=lambda: out.update(got=srv.predict(cold[0])["predict"]))
        start1 = time.perf_counter()     # thread ids are reused: read each log from its start
        t.start()
        asked = wait_locked()
        got1 = srv._finalize_forward(chunks, feats, asked)["predict"]
        t.join(timeout=300)
        cap_released = gate.first(t.ident, "released", start1)
        pull_acquired = gate.first(me, "acquired", asked)
        # (2) a pull in thread p holds the gate on a busy device; then a capture
        # a copy from pageable memory waits for the stream, so the spin
        # goes after the batch's launch: its pull then waits ~0.1 s on it
        chunks, feats = srv._dispatch_forward(warm)
        torch.cuda._sleep(int(2e8))
        res = {}
        p = threading.Thread(target=lambda: res.update(
            got=srv._finalize_forward(chunks, feats, 0.0)["predict"]))
        start2 = time.perf_counter()
        p.start()
        asked2 = wait_locked()
        got_cold2 = srv.predict(cold[1])["predict"]
        p.join(timeout=120)
        pull_released = gate.first(p.ident, "released", start2)
        cap_acquired = gate.first(me, "acquired", asked2)
    finally:
        srv._pull_gate = srv.conformer.capture_gate = gate.lock
    seen = {
        "pull_asked_during_capture": asked < cap_released,
        "pull_took_gate_after_capture": pull_acquired >= cap_released,
        "pull_waited_ms": (pull_acquired - asked) * 1e3,
        "capture_asked_during_pull": asked2 < pull_released,
        "capture_took_gate_after_pull": cap_acquired >= pull_released,
        "capture_waited_ms": (cap_acquired - asked2) * 1e3,
        "rows_right": bool(np.array_equal(got1, want) and np.array_equal(res.get("got"), want)
                           and "got" in out and np.isfinite(got_cold2).all()),
    }
    if not all(v for k, v in seen.items() if not k.endswith("_ms")):
        raise Failed(f"serve: capture beside a pull: {seen}")
    return seen


def phase_serve(dev, card):
    """MolServe on the card over an experiment dir of the flagship (two
    seeded folds): (a) eager against graph-replayed, (b) the two-fold
    ensemble, (c) warmup_buckets of the default grid, (d) the HTTP front
    with the dynamic batcher.  Returns the launch counts of the eager
    forwards of (a)."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.api.serve_api import DEFAULT_BATCH_BUCKETS
    from mmdti_tpu_torch.ops.hopper_ln import ln_kernels_on
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    t_phase = time.perf_counter()
    cfg, state_dicts = _write_serve_dir(SERVE_DIR, seeds=(0, 1))
    graph = MolServe(SERVE_DIR, device=dev)
    eager = MolServe(SERVE_DIR, device=dev)
    plain = MolServe(SERVE_DIR, device=dev, use_kernels=False)
    eager.use_graphs = plain.use_graphs = False   # the eager comparison path
    model = graph.model
    n_params = sum(p.numel() for p in model.parameters())
    ucfg = model.unimol_cfg
    attn = _attention_launches(ucfg.encoder_layers, model.bert.cfg.num_hidden_layers
                               + 2 * model.cross_modal_module.text_attention.cfg.num_layers,
                               backward=False)
    # the LayerNorm kernels where their setting is on for the card (on
    # unless MMDTI_PALLAS_LN=0)
    per_fwd = {**{k: attn.get(k, 0) for k in KERNELS},
               "layer_norm": _ln_sites(model) if ln_kernels_on(dev) else 0}
    one_replay = {k: per_fwd[k] for k in KERNEL_MARKERS}
    requests = {n: SMILES_20[:n] for n in REQUESTS}
    print(f"serve: flagship {n_params} params a fold, layers={ucfg.encoder_layers} "
          f"E={ucfg.embed_dim} H={ucfg.attention_heads}, compute bf16, pair {ucfg.pair_dtype}; "
          f"dir {os.path.relpath(SERVE_DIR, REPO)} (2 folds, {time.perf_counter() - t_phase:.1f} s "
          f"to write and load); {card}", flush=True)

    # (a) first answers: featurize, then eager launches / each bucket's capture
    cold_ms = {"eager": {}, "graph": {}}
    _reset_counts()
    for n, smi in requests.items():
        t0 = time.perf_counter()
        eager.predict(smi)
        cold_ms["eager"][str(n)] = (time.perf_counter() - t0) * 1e3
    _check_launches(_read_counts(), per_fwd, len(REQUESTS), "serve eager (cold)")
    _reset_counts()
    for n, smi in requests.items():
        t0 = time.perf_counter()
        graph.predict(smi)
        cold_ms["graph"][str(n)] = (time.perf_counter() - t0) * 1e3
    capture_counts, capture_routes = _read_counts(), _read_routes()
    n_graphs = len(graph.graphs)
    _check_launches(capture_counts, per_fwd, (GRAPH_WARMUP + 1) * n_graphs, "serve capture")
    _check_mma_routes(capture_routes, {k: n * (GRAPH_WARMUP + 1) * n_graphs
                                       for k, n in attn.items()}, "serve capture")

    # (a) p50, eager and graph alternated: the launchers count only the
    # eager forwards (a replay goes through no launcher)
    _reset_counts()
    p50, p50_rounds = _alternated_p50({"eager": eager, "graph": graph}, requests)
    launches, routes = _read_counts(), _read_routes()
    forwards = SERVE_ROUNDS * REPEATS * len(REQUESTS)
    _check_launches(launches, per_fwd, forwards, "serve eager (timed)")
    _check_mma_routes(routes, {k: n * forwards for k, n in attn.items()}, "serve eager")

    # (a) outputs: graph against eager, as close as two eager calls
    out_check = {}
    for n, smi in requests.items():
        e1, e2 = eager.predict(smi)["predict"], eager.predict(smi)["predict"]
        g = graph.predict(smi)["predict"]
        if g.shape != (n, 1) or not np.isfinite(g).all():
            raise Failed(f"serve predict({n}) gave {g!r}")
        out_check[str(n)] = {"bit_equal": bool(np.array_equal(g, e1)),
                             "graph_vs_eager_max_abs": float(np.abs(g - e1).max()),
                             "eager_vs_eager_max_abs": float(np.abs(e2 - e1).max())}
    bad = {n: c for n, c in out_check.items()
           if c["graph_vs_eager_max_abs"] > c["eager_vs_eager_max_abs"]}
    if bad:
        raise Failed(f"serve: graph-replayed outputs differ from eager ones: {bad}")

    # (a) one forward's device time and the port kernels one replay launches
    smi20 = requests[20]
    before = _read_counts()
    g_launch, g_ms, g_kernels = _replay_launches(lambda: graph.predict(smi20))
    moved = {k: n - before[k] for k, n in _read_counts().items() if n != before[k]}
    e_launch, e_ms, e_kernels = _replay_launches(lambda: eager.predict(smi20))
    if g_launch != one_replay or moved:
        raise Failed(f"serve: one replay launched {g_launch} (expected {one_replay}); "
                     f"launchers moved {moved}")

    # kernel path against plain path, same weights, same collated batch
    arrays, n = eager._collate(eager._featurize(smi20))
    feats = eager._place_feats(arrays)
    with torch.inference_mode():
        got = eager.model(**feats, outputs="logits")["logits"][:n]
        want = plain.model(**feats, outputs="logits")["logits"][:n]
    diff = float((got - want).abs().max())
    pred_diff = float(np.abs(graph.predict(smi20)["predict"]
                             - plain.predict(smi20)["predict"]).max())
    print("serve: (a) " + json.dumps({
        "p50_ms": p50, "p50_ms_by_round": p50_rounds, "rounds": SERVE_ROUNDS,
        "repeats": REPEATS, "cold_first_request_ms": cold_ms,
        "device_ms_per_forward_20_smiles": {"eager": e_ms, "graph": g_ms},
        "device_kernels_per_forward": {"eager": e_kernels, "graph": g_kernels},
        "one_replay_port_kernels": g_launch, "one_eager_forward_port_kernels": e_launch,
        "graphs_recorded": n_graphs, "capture_launches": capture_counts,
        "eager_launches_timed": launches, "eager_forwards_timed": forwards,
        "attention_routes": routes, "graph_vs_eager": out_check,
        "logits_max_abs_diff_vs_plain": diff, "predict_max_abs_diff_vs_plain": pred_diff,
        "logits_tol": LOGITS_TOL, "card": card,
    }), flush=True)
    if not (diff <= LOGITS_TOL and pred_diff <= LOGITS_TOL):
        raise Failed(f"kernel path differs from plain path: logits {diff}, predict {pred_diff}")
    del plain

    # (b) the two-fold ensemble against the mean of its folds
    ens = MolServe(SERVE_DIR, device=dev, serve_folds="all")
    fold1 = MolServe.from_state_dict(cfg, state_dicts[1], device=dev)
    ens_diff, fold_gap = {}, {}
    for n, smi in requests.items():
        f0, f1 = graph.predict(smi)["predict"], fold1.predict(smi)["predict"]
        ens_diff[str(n)] = float(np.abs(ens.predict(smi)["predict"] - (f0 + f1) / 2).max())
        fold_gap[str(n)] = float(np.abs(f0 - f1).max())
    ens_p50, ens_rounds = _alternated_p50({"fold0": graph, "ensemble": ens}, requests)
    ens_launch, ens_ms, _ = _replay_launches(lambda: ens.predict(smi20))
    print("serve: (b) " + json.dumps({
        "serve_folds": ens.serve_folds, "ensemble_vs_fold_mean_max_abs": ens_diff,
        "fold0_vs_fold1_max_abs": fold_gap, "tol": LOGITS_TOL, "p50_ms": ens_p50,
        "p50_ms_by_round": ens_rounds,
        "device_ms_per_request_20_smiles": {"fold0": g_ms, "ensemble": ens_ms},
        "one_replay_port_kernels": ens_launch, "card": card,
    }), flush=True)
    if max(ens_diff.values()) > LOGITS_TOL:
        raise Failed(f"serve: the ensemble differs from the mean of its folds: {ens_diff}")
    if ens_launch != {k: 2 * v for k, v in one_replay.items()}:
        raise Failed(f"serve: one ensemble replay launched {ens_launch}")
    del ens, fold1

    # (b2) the pair arrays built on the device (the default here) against
    # the host's, both graph-replayed
    host = MolServe(SERVE_DIR, device=dev, device_pair_feats="host")
    mode_diff = {str(n): float(np.abs(graph.predict(smi)["predict"]
                                      - host.predict(smi)["predict"]).max())
                 for n, smi in requests.items()}
    mode_p50, mode_rounds = _alternated_p50({"device": graph, "host": host}, requests)
    print("serve: (b2) " + json.dumps({
        "pair_modes": {"default": graph.pair_mode, "other": host.pair_mode},
        "device_vs_host_max_abs": mode_diff, "tol": LOGITS_TOL, "p50_ms": mode_p50,
        "p50_ms_by_round": mode_rounds, "card": card}), flush=True)
    if graph.pair_mode != "device" or host.pair_mode != "host":
        raise Failed(f"serve: pair modes {graph.pair_mode} (auto) and {host.pair_mode} (host)")
    if max(mode_diff.values()) > LOGITS_TOL:
        raise Failed(f"serve: device pair features answer apart from host ones: {mode_diff}")
    del host

    # (c) warmup_buckets over the default grid on a fresh server, which (d)
    # then serves warm
    grid = MolServe(SERVE_DIR, device=dev)
    torch.cuda.synchronize()
    alloc0, reserved0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grid.warmup_buckets(DEFAULT_BATCH_BUCKETS)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    expect = len(DEFAULT_BATCH_BUCKETS) * 3 * 3
    grid_mem = {"peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "allocated_gb_after": torch.cuda.memory_allocated(dev) / 1e9,
                "reserved_gb_after": torch.cuda.memory_reserved(dev) / 1e9}
    grid_graphs = len(grid.graphs)
    # the largest buckets into the same pool: the pool grows to the largest
    # forward's working set, not by one working set a graph
    big = {"batch_buckets": list(DEFAULT_BATCH_BUCKETS[-2:]),
           "atom_buckets": list(grid.collator.atom_buckets[-2:]),
           "smiles_buckets": list(grid.collator.smiles_buckets[-2:])}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grid.warmup_buckets(big["batch_buckets"], big["atom_buckets"], big["smiles_buckets"])
    torch.cuda.synchronize()
    big.update(seconds=time.perf_counter() - t0, graphs_recorded=len(grid.graphs) - grid_graphs,
               peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               allocated_gb_after=torch.cuda.memory_allocated(dev) / 1e9,
               reserved_gb_after=torch.cuda.memory_reserved(dev) / 1e9)
    # every graph shares one pool: (a)'s buckets, recorded early, still
    # answer as the eager server does after the later captures (the largest
    # last) reused the pool's blocks
    shared = {}
    for n, smi in requests.items():
        e1, e2 = eager.predict(smi)["predict"], eager.predict(smi)["predict"]
        g = grid.predict(smi)["predict"]
        shared[str(n)] = {"bit_equal": bool(np.array_equal(g, e1)),
                          "graph_vs_eager_max_abs": float(np.abs(g - e1).max()),
                          "eager_vs_eager_max_abs": float(np.abs(e2 - e1).max())}
    print("serve: (c) " + json.dumps({
        "warmup_buckets_s": grid_s, "graphs_recorded": grid_graphs,
        "graphs_expected": expect, "batch_buckets": list(DEFAULT_BATCH_BUCKETS),
        "atom_buckets": list(grid.collator.atom_buckets[:3]),
        "smiles_buckets": list(grid.collator.smiles_buckets[:3]),
        "allocated_gb_before": alloc0 / 1e9, "reserved_gb_before": reserved0 / 1e9,
        **grid_mem, "largest_buckets": big, "graphs_in_one_pool": len(grid.graphs),
        "shared_pool_graph_vs_eager": shared, "card": card,
    }), flush=True)
    if grid_graphs != expect or big["graphs_recorded"] != 8:
        raise Failed(f"serve: warmup_buckets recorded {grid_graphs} graphs (not {expect}) "
                     f"and {big['graphs_recorded']} of the largest (not 8)")
    bad = {n: c for n, c in shared.items()
           if c["graph_vs_eager_max_abs"] > c["eager_vs_eager_max_abs"]}
    if bad:
        raise Failed(f"serve: a graph in the shared pool differs from eager: {bad}")
    del graph, eager

    _serve_http_checks(grid, card)
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _serve_http_checks(graph, card):
    """(d) the HTTP front with the dynamic batcher over a fold-0 graph
    server whose default bucket grid is recorded: concurrent clients, a
    cold bucket under load, 429."""
    import gc
    import threading

    import numpy as np

    lone = {s: graph.predict([s])["predict"][0] for s in SMILES_20}

    def reply_gap(smiles, body):
        got = np.asarray(body["predict"])
        return float(np.abs(got - np.stack([lone[s] for s in smiles])).max())

    def reply_tol():
        """Half the least gap between two distinct molecules' lone
        predictions, at most LOGITS_TOL: a reply carrying another rider's
        row lies outside it."""
        rows = list(lone.values())
        gap = min(float(np.abs(a - b).max()) for i, a in enumerate(rows) for b in rows[i + 1:])
        return min(LOGITS_TOL, gap / 2), gap

    # concurrent clients of 1-8 SMILES each
    srv = graph.make_server(port=0, dynamic_batch_window_ms=HTTP_WINDOW_MS)
    url, thread = _start_http(srv)
    results, timing, lock = [], [], threading.Lock()
    graphs0 = len(graph.graphs)

    def client(i):
        rng = np.random.RandomState(i)
        for k in range(HTTP_REQUESTS):
            smi = [SMILES_20[j] for j in rng.randint(0, len(SMILES_20), rng.randint(1, 9))]
            t0 = time.perf_counter()
            code, body = _post(url + "/predict", {"smiles": smi})
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                results.append((smi, code, body, ms))
                timing.append((i, k, t0 - t_start, ms))

    # the interpreter's collections in the clients' window, to tell a
    # collector pause from a stall elsewhere in the tail
    pauses = []

    def on_gc(phase, info):
        if phase == "start":
            pauses.append([time.perf_counter(), None, info["generation"]])
        elif pauses and pauses[-1][1] is None:
            pauses[-1][1] = time.perf_counter()

    clients = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
    # one request first: the client library's first call imports and sets
    # up what every later one reuses
    if _post(url + "/predict", {"smiles": SMILES_20[:1]})[0] != 200:
        raise Failed("serve http: the first request failed")
    gc.callbacks.append(on_gc)
    try:
        t_start = t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    batches = srv.batcher.batches_run
    _stop_http(srv, thread)
    if any(t.is_alive() for t in clients) or len(results) != HTTP_CLIENTS * HTTP_REQUESTS:
        raise Failed(f"serve http: {len(results)} of {HTTP_CLIENTS * HTTP_REQUESTS} answered")
    codes = sorted({c for _, c, _, _ in results})
    if codes != [200]:
        raise Failed(f"serve http: status codes {codes}")
    gaps = [reply_gap(smi, body) for smi, _, body, _ in results]
    lat = sorted(ms for *_, ms in results)
    mols = sum(len(smi) for smi, *_ in results)
    http = {"clients": HTTP_CLIENTS, "requests_each": HTTP_REQUESTS,
            "window_ms": HTTP_WINDOW_MS, "wall_s": wall, "requests_per_s": len(results) / wall,
            "molecules_per_s": mols / wall, "molecules": mols,
            "p50_ms": statistics.median(lat), "p95_ms": lat[int(0.95 * len(lat))],
            "batches_run": batches, "graphs_recorded_under_load": len(graph.graphs) - graphs0,
            "reply_vs_lone_predict_max_abs": max(gaps),
            "replies_bit_equal_to_lone": sum(g == 0.0 for g in gaps)}
    # where the tail lies: each client's first request against the rest
    first = sorted(ms for _, k, _, ms in timing if k == 0)
    rest = sorted(ms for _, k, _, ms in timing if k > 0)
    gc_ms = [(b - a) * 1e3 for a, b, _ in pauses if b is not None]
    http["tail"] = {
        "first_request_ms_by_client_min_median_max": [first[0], statistics.median(first),
                                                      first[-1]],
        "later_requests_p50_ms": statistics.median(rest),
        "later_requests_p95_ms": rest[int(0.95 * len(rest))],
        "slowest_client_request_start_s_ms": sorted(timing, key=lambda r: -r[3])[:12],
        "gc_collections": len(gc_ms), "gc_gen2": sum(g == 2 for *_, g in pauses),
        "gc_pause_ms_sum": sum(gc_ms), "gc_pause_ms_max": max(gc_ms, default=0.0)}
    http["tol"], http["least_gap_between_molecules"] = reply_tol()
    if max(gaps) > http["tol"]:
        raise Failed(f"serve http: a reply differs from a lone predict by {max(gaps)} "
                     f"(tol {http['tol']})")

    # captures and pulls made to meet, both orders (bucket B=2 and 4 at 96 atoms)
    lone[COLD_SMILES] = graph.predict([COLD_SMILES])["predict"][0]
    beside = _capture_beside_pulls(graph, SMILES_20[:2], ([COLD_SMILES] * 2, [COLD_SMILES] * 3))

    # cold buckets (96 atoms, B >= 8) recorded while 8 clients keep warm
    # batches in flight (window 1 ms: batches back to back)
    spans = {"captures": [], "pulls": []}
    record, pull = graph._record, graph._pull_batched

    def timed(fn, key):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spans[key].append((t, time.perf_counter()))
        return run

    graph._record, graph._pull_batched = timed(record, "captures"), timed(pull, "pulls")
    srv = graph.make_server(port=0, dynamic_batch_window_ms=1.0)
    url, thread = _start_http(srv)
    stop, warm, cold = threading.Event(), [], []
    graphs0 = len(graph.graphs)

    def warm_client(i):
        rng = np.random.RandomState(100 + i)
        while not stop.is_set():
            smi = [SMILES_20[j] for j in rng.randint(0, len(SMILES_20), rng.randint(1, 9))]
            code, body = _post(url + "/predict", {"smiles": smi})
            warm.append((smi, code, body))

    def cold_client():
        for k in (5, 9, 17):
            code, body = _post(url + "/predict", {"smiles": [COLD_SMILES] * k})
            cold.append(([COLD_SMILES] * k, code, body))

    try:
        warms = [threading.Thread(target=warm_client, args=(i,)) for i in range(8)]
        for t in warms:
            t.start()
        time.sleep(0.5)
        cold_thread = threading.Thread(target=cold_client)
        cold_thread.start()
        cold_thread.join(timeout=300)
        time.sleep(0.2)
        stop.set()
        for t in warms:
            t.join(timeout=300)
    finally:
        stop.set()
        _stop_http(srv, thread)
        del graph._record, graph._pull_batched
    recorded = len(graph.graphs) - graphs0
    caps, pulls = spans["captures"], spans["pulls"]
    answered = warm + cold
    codes = sorted({c for _, c, _ in answered})
    cold_case = {"captures": len(caps), "graphs_recorded": recorded, "pulls": len(pulls),
                 "pulls_in_progress_at_a_capture_start": sum(
                     any(p0 < c0 < p1 for c0, _ in caps) for p0, p1 in pulls),
                 "pulls_started_during_a_capture": sum(
                     any(c0 < p0 < c1 for c0, c1 in caps) for p0, _ in pulls),
                 "warm_requests": len(warm), "cold_requests": len(cold), "codes": codes,
                 "reply_vs_lone_predict_max_abs": max(reply_gap(s, b) for s, _, b in answered
                                                      if b.get("predict") is not None)}
    cold_case["tol"], cold_case["least_gap_between_molecules"] = reply_tol()
    if codes != [200] or len(cold) != 3 or not spans["captures"]:
        raise Failed(f"serve http cold bucket: {cold_case}")
    if cold_case["reply_vs_lone_predict_max_abs"] > cold_case["tol"]:
        raise Failed(f"serve http cold bucket: a reply differs from a lone predict: {cold_case}")

    # 429: max_pending=2 riders held in a stalled dispatch, a third is shed
    gate = threading.Event()
    dispatch = graph._dispatch_forward

    def stalled(smiles):
        gate.wait(60)
        return dispatch(smiles)

    graph._dispatch_forward = stalled
    srv = graph.make_server(port=0, dynamic_batch_window_ms=1.0)
    srv.batcher.max_pending = 2
    url, thread = _start_http(srv)
    riders = []
    try:
        held = [threading.Thread(target=lambda: riders.append(
            _post(url + "/predict", {"smiles": ["CCO"]})[0])) for _ in range(2)]
        for t in held:
            t.start()
        deadline = time.monotonic() + 30
        while srv.batcher._inflight < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        shed, _ = _post(url + "/predict", {"smiles": ["CCN"]})
        gate.set()
        for t in held:
            t.join(timeout=120)
    finally:
        gate.set()
        del graph._dispatch_forward
        _stop_http(srv, thread)
    print("serve: (d) " + json.dumps({**http, "capture_beside_pulls": beside,
                                      "cold_bucket_under_load": cold_case,
                                      "overload": {"max_pending": 2, "shed_status": shed,
                                                   "held_riders_status": sorted(riders)},
                                      "card": card}), flush=True)
    if shed != 429 or sorted(riders) != [200, 200]:
        raise Failed(f"serve http overload: shed {shed}, held riders {riders}")


def _flagship(use_kernels, output_dim=1, model_group=None):
    """The flagship model (bf16 compute, bf16 pair logits) on the CPU, with
    the built-in dictionary and tokenizer's vocabularies; with a sharding
    ``model_group`` one model rank's shard of it."""
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    return build_model(output_dim, len(d), d.pad(), SmilesTokenizer().vocab_size,
                       compute_dtype="bfloat16", use_kernels=use_kernels,
                       unimol_overrides={"pair_dtype": "bfloat16"}, model_group=model_group)


def _train_batch(dev, atom_pad, smiles_pad, B=32, pair_feats="device"):
    """B molecules of SMILES_20 featurized (host conformers) and collated to
    N=atom_pad atoms and L=smiles_pad tokens, on the device: coordinates
    for the model to build the pair arrays from (``pair_feats`` "device",
    the card's default) or the host's [B,N,N] arrays ("host")."""
    import numpy as np
    import torch

    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.data.batching import BatchCollator

    smiles = (SMILES_20 * (B // len(SMILES_20) + 1))[:B]
    conf = ConformerGen()
    feats = conf.transform(smiles)
    for f, s in zip(feats, smiles):
        f["smile"] = s
    coll = BatchCollator(SmilesTokenizer(), pad_idx=conf.dictionary.pad(), pad_mode="fixed",
                         atom_pad=atom_pad, smiles_pad=smiles_pad, pair_feats=pair_feats)
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def _profile_steps(step, args, n=3):
    """torch.profiler over n train steps: device time per step, kernels per
    step, the share of the port's own kernels, the top kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    ours = ("attention_rows_kernel", "attention_bwd_rows_kernel", "attention_bwd_cols_kernel",
            "gbf_proj_kernel", "gbf_proj_bwd_kernel", "gbf_bwd_reduce_kernel", "gbf_mma_",
            "masked_mma_", "pair_mma_", *LN_KERNEL_NAMES)

    def device_us(*names):
        return sum(e.self_device_time_total for e in kernels if any(o in e.key for o in names))

    own_us, masked_us, pair_us = device_us(*ours), device_us("masked_mma_"), device_us("pair_mma_")
    gbf_us = device_us("gbf_")
    ln_launches = sum(e.count for e in kernels if any(o in e.key for o in LN_KERNEL_NAMES))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "steps": n,
        "device_ms_per_step": total_us / n / 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / n,
        "port_kernels_ms_per_step": own_us / n / 1e3,
        "masked_mma_kernels_ms_per_step": masked_us / n / 1e3,
        "pair_mma_kernels_ms_per_step": pair_us / n / 1e3,
        "gbf_kernels_ms_per_step": gbf_us / n / 1e3,
        "ln_kernels_ms_per_step": device_us(*LN_KERNEL_NAMES) / n / 1e3,
        "ln_kernel_launches_per_step": ln_launches / n,
        "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / n / 1e3,
                         "calls_per_step": e.count / n} for e in top],
    }


def _profile_optimizer(opt):
    """Kernel launches and wall time of one clip + Adam update, taken with
    zero gradients (the momentum still moves the parameters, as a step
    would)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    grads = {n: torch.zeros_like(p) for n, p in opt.params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.apply(grads)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.apply(grads)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"parameter_tensors": len(opt.params), "kernel_launches": launches,
            "wall_ms": host_ms}


def phase_train(dev):
    """The flagship train step on the card; returns the launch counts of
    the 30-step run."""
    import torch

    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_loss, build_train_step

    model = _flagship(True)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    plain = _flagship(False)
    plain.load_state_dict(model.state_dict())
    model.to(dev)
    plain.to(dev)
    B = 32
    feats = _train_batch(dev, 64, 64, B)
    labels = torch.randn(B, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    weights = torch.ones(B, 1, device=dev)
    ucfg = model.unimol_cfg
    n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
    print(f"train: flagship layers={ucfg.encoder_layers} E={ucfg.embed_dim} "
          f"H={ucfg.attention_heads} K={ucfg.gaussian_kernels}, bf16 compute, pair "
          f"{ucfg.pair_dtype}, batch B={B} N={feats['src_tokens'].shape[1]} "
          f"L={feats['input_ids'].shape[1]}, regression MSE + 0.1 InfoNCE + 0.1 ct_regress",
          flush=True)

    # (a) one step's loss and gradients, dropout off, kernel vs plain path,
    # at N=L=64 and at the top SMILES bucket L=512 (N=64)
    train_loss = build_train_loss(zoo.mse_loss, "regression")
    feats512 = _train_batch(dev, 64, 512, B)
    attn = _attention_launches(ucfg.encoder_layers, n_masked)
    _compare_paths(model, plain, train_loss, feats, labels, weights, attn)
    _compare_paths(model, plain, train_loss, feats512, labels, weights, attn)
    del plain
    _pair_modes_check(dev, model, train_loss, labels, weights)

    # (b) 30 steps, dropout on, one fixed batch; (c) their times and launches
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, TRAIN_STEPS, warmup_ratio=0.1,
                    max_norm=1.0)
    step = build_train_step(model, opt, zoo.mse_loss, "regression")
    gen = torch.Generator(device=dev).manual_seed(7)
    _reset_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(feats, labels, weights, gen)["loss"])
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _read_counts()
    routes = _read_routes()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    p50 = statistics.median(step_ms)
    per_step = attn
    print("train: " + json.dumps({
        "steps": TRAIN_STEPS, "dropout": "on", "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "step_ms_p50": p50, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "mols_per_s": B / p50 * 1e3,
        "host_wall_s": wall_s, "launches": launches, "launches_per_step_expected": per_step,
        "attention_routes": routes,
    }), flush=True)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise Failed(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise Failed(f"train: loss did not fall: first {losses[0]}, last {losses[-1]}")
    for k, per in per_step.items():
        if launches[k] != per * TRAIN_STEPS:
            raise Failed(f"train {k}: {launches[k]} launches, expected {per} x {TRAIN_STEPS}")
    _check_mma_routes(routes, {k: n * TRAIN_STEPS for k, n in attn.items()}, "train")
    print("train: profile " + json.dumps(_profile_steps(step, (feats, labels, weights, gen))),
          flush=True)
    print("train: optimizer " + json.dumps(_profile_optimizer(opt)), flush=True)

    # (d) one step at the top atom bucket
    feats280 = _train_batch(dev, 280, 64, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    loss280 = float(step(feats280, labels, weights, gen)["loss"])
    b.record()
    torch.cuda.synchronize()
    routes280 = _read_routes()
    peak280 = torch.cuda.max_memory_allocated(dev)
    print("train: " + json.dumps({
        "step": "top atom bucket", "B": B, "N": 280, "L": 64, "loss": loss280,
        "step_ms": a.elapsed_time(b), "max_memory_allocated_bytes": peak280,
        "routes": routes280,
        "profile": _profile_steps(step, (feats280, labels, weights, gen), n=2),
    }), flush=True)
    if not loss280 == loss280 or abs(loss280) == float("inf"):
        raise Failed(f"train: N=280 step gave loss {loss280}")
    _check_mma_routes(routes280, attn, "train N=280")

    # (e) one step at the top SMILES bucket L=512 (N=64): launches per
    # route, device time and the masked kernels' share of it, peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    loss512 = float(step(feats512, labels, weights, gen)["loss"])
    b.record()
    torch.cuda.synchronize()
    counts512, routes512 = _read_counts(), _read_routes()
    peak512 = torch.cuda.max_memory_allocated(dev)
    prof512 = _profile_steps(step, (feats512, labels, weights, gen), n=2)
    print("train: " + json.dumps({
        "step": "top SMILES bucket", "B": B, "N": 64, "L": 512, "loss": loss512,
        "step_ms": a.elapsed_time(b), "max_memory_allocated_bytes": peak512,
        "masked_launches": {k: counts512[k] for k in ("masked_attention",
                                                      "masked_attention_bwd")},
        "attention_routes": routes512, "profile": prof512,
    }), flush=True)
    if not loss512 == loss512 or abs(loss512) == float("inf"):
        raise Failed(f"train: L=512 step gave loss {loss512}")
    _check_mma_routes(routes512, attn, "train L=512")
    _ln_off_on(model, step, (feats, labels, weights, gen))
    _numerical_check(dev, feats, labels, weights, n_masked)
    return launches


def _pair_modes_check(dev, model, train_loss, labels, weights):
    """Phase train: the loss of one batch (N=L=64, dropout off) with the
    pair arrays built on the device from coordinates (the default on the
    card) against the host's arrays, on the plain fp32 path (1e-4)."""
    import torch

    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    plain = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        compute_dtype="float32", use_kernels=False,
                        unimol_overrides={"pair_dtype": "float32"})
    plain.load_state_dict(model.state_dict())
    plain.to(dev)
    loss = {}
    with torch.no_grad():
        for mode in ("device", "host"):
            feats = _train_batch(dev, 64, 64, labels.shape[0], pair_feats=mode)
            loss[mode] = float(train_loss(plain, feats, labels, weights, None)[0])
    diff = abs(loss["device"] - loss["host"])
    print("train: " + json.dumps({"check": "device vs host pair features, plain fp32 path",
                                  "loss": loss, "abs_diff": diff, "tol": PAIR_MODE_TOL}),
          flush=True)
    if not diff <= PAIR_MODE_TOL:
        raise Failed(f"train: device pair features give loss {loss['device']}, host "
                     f"{loss['host']}")


def _numerical_check(dev, feats, labels, weights, n_masked):
    """Phase train (g): the flagship width with the numerical pair kernel
    (NumericalEmbed, an unfused gbf_proj, then the pair-bias kernels) at
    N=L=64: one step's loss and gradients on the kernel path against the
    plain path, and one train step's launches (no gbf kernel)."""
    import torch

    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_loss, build_train_step

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)

    def build(use_kernels):
        return build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                           compute_dtype="bfloat16", use_kernels=use_kernels,
                           unimol_overrides={"pair_dtype": "bfloat16", "kernel": "numerical"})

    model = build(True).reset_parameters_like_flax(torch.Generator().manual_seed(5)).to(dev)
    plain = build(False)
    plain.load_state_dict(model.state_dict())
    plain.to(dev)
    per_step = {**_attention_launches(model.unimol_cfg.encoder_layers, n_masked),
                "gbf_proj": 0, "gbf_proj_bwd": 0}
    _compare_paths(model, plain, build_train_loss(zoo.mse_loss, "regression"), feats, labels,
                   weights, per_step, what="numerical")
    del plain
    step = build_train_step(model, FusedAdam(dict(model.named_parameters()), 1e-4, 10),
                            zoo.mse_loss, "regression")
    _reset_counts()
    loss = float(step(feats, labels, weights, torch.Generator(device=dev).manual_seed(3))["loss"])
    counts = _read_counts()
    _, ms, kernels = _replay_launches(
        lambda: step(feats, labels, weights, torch.Generator(device=dev).manual_seed(3)))
    print("numerical: " + json.dumps({
        "kernel": "numerical", "B": feats["src_tokens"].shape[0],
        "N": feats["src_tokens"].shape[1], "step_loss": loss, "launches": counts,
        "launches_expected": per_step, "step_device_ms": ms, "step_device_kernels": kernels}),
        flush=True)
    if not loss == loss or any(counts[k] != n for k, n in per_step.items()):
        raise Failed(f"numerical: step loss {loss}, launches {counts}, expected {per_step}")


def _ln_off_on(model, step, args):
    """Phase train (f): the flagship step (N=L=64, dropout on) with the
    LayerNorm kernels off (MMDTI_PALLAS_LN=0) and on (=1), the same
    model, weights and batch, alternated over LN_ROUNDS rounds of LN_STEPS
    steps each way; MMDTI_PALLAS_LN is restored afterwards.  With the
    kernels on, every LayerNorm site launches its kernels once a step each
    way; off, none does."""
    import torch

    from mmdti_tpu_torch.models.layers import FusedLN

    sites = sum(1 for m in model.modules()
                if isinstance(m, FusedLN) and m.use_kernels and m.weight.numel() % 128 == 0)
    ways = {"off": "0", "on": "1"}
    runs = {w: {"step_ms": [], "round_p50_ms": [], "ln_launches": [], "profiles": []}
            for w in ways}
    previous = os.environ.get("MMDTI_PALLAS_LN")
    try:
        for _ in range(LN_ROUNDS):
            for way, env in ways.items():
                os.environ["MMDTI_PALLAS_LN"] = env
                torch.cuda.synchronize()
                _reset_counts()
                events = []
                for _ in range(LN_STEPS):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    a.record()
                    step(*args)
                    b.record()
                    events.append((a, b))
                torch.cuda.synchronize()
                counts = _read_counts()
                ms = [a.elapsed_time(b) for a, b in events]
                run = runs[way]
                run["step_ms"] += ms
                run["round_p50_ms"].append(statistics.median(ms))
                run["ln_launches"].append({k: counts[k] / LN_STEPS
                                           for k in ("layer_norm", "layer_norm_bwd")})
                run["profiles"].append(_profile_steps(step, args))
    finally:
        if previous is None:
            os.environ.pop("MMDTI_PALLAS_LN", None)
        else:
            os.environ["MMDTI_PALLAS_LN"] = previous

    summary = {}
    for way, run in runs.items():
        profs = run["profiles"]
        summary[way] = {
            "step_ms_p50": statistics.median(run["step_ms"]),
            "round_p50_ms": run["round_p50_ms"],
            "ln_launches_per_step": run["ln_launches"],
            "kernel_launches_per_step": [p["kernel_launches_per_step"] for p in profs],
            "device_ms_per_step": [p["device_ms_per_step"] for p in profs],
            "ln_kernels_ms_per_step": [p["ln_kernels_ms_per_step"] for p in profs],
            "ln_kernel_launches_per_step": [p["ln_kernel_launches_per_step"] for p in profs],
        }
    print("train: " + json.dumps({
        "step": "LayerNorm kernels off against on", "N": 64, "L": 64, "dropout": "on",
        "rounds": LN_ROUNDS, "steps_each_way_a_round": LN_STEPS, "ln_sites": sites,
        **summary,
        "on_minus_off": {
            "step_ms_p50": summary["on"]["step_ms_p50"] - summary["off"]["step_ms_p50"],
            "device_ms_per_step": statistics.fmean(summary["on"]["device_ms_per_step"])
            - statistics.fmean(summary["off"]["device_ms_per_step"]),
            "kernel_launches_per_step": statistics.fmean(summary["on"]["kernel_launches_per_step"])
            - statistics.fmean(summary["off"]["kernel_launches_per_step"])},
    }), flush=True)
    if sites != LN_SITES:
        raise Failed(f"train: {sites} LayerNorm sites take the kernels, expected {LN_SITES}")
    for way, per in (("off", 0), ("on", sites)):
        for got in runs[way]["ln_launches"]:
            if got != {"layer_norm": per, "layer_norm_bwd": per}:
                raise Failed(f"train LayerNorm kernels {way}: {got} launches a step, "
                             f"expected {per} each way")


def _check_mma_routes(routes, expected, what):
    """Every attention and gbf launch of a bf16 run went to the tensor-core
    route: expected maps a launcher to its number of launches."""
    for k, n in expected.items():
        if routes[k]["mma"] != n or sum(routes[k].values()) != n:
            raise Failed(f"{what} {k}: routes {routes[k]}, expected {n} on mma")


def _attention_launches(n_pair, n_masked, backward=True):
    """Launches per launcher of one forward (and backward) of the kernels
    with a tensor-core route: gbf 1, pair-bias n_pair, masked n_masked."""
    per = {"gbf_proj": 1, "pair_bias_attention": n_pair, "masked_attention": n_masked}
    if backward:
        per.update(gbf_proj_bwd=1, pair_bias_attention_bwd=n_pair,
                   masked_attention_bwd=n_masked)
    return per


def _compare_paths(model, plain, train_loss, feats, labels, weights, attn, what="train"):
    """One step's loss and gradients, dropout off, on the kernel path
    against the plain path; the kernel path's attention launches (attn:
    launcher -> count) must all take the tensor-core route."""
    import torch

    def loss_and_grads(m):
        total, _ = train_loss(m, feats, labels, weights, None)
        names, params = zip(*m.named_parameters())
        return float(total.detach()), dict(zip(names, torch.autograd.grad(total, params)))

    _reset_counts()
    lk, gk = loss_and_grads(model)
    routes = _read_routes()
    lp, gp = loss_and_grads(plain)
    # each parameter's largest difference over its gradient's max, floored
    # at 1e-3 of the whole gradient's max: a gradient that is zero in exact
    # arithmetic (the attention key biases') holds only rounding noise
    floor = 1e-3 * max(float(g.float().abs().max()) for g in gp.values())
    rel = {}
    for name, g in gp.items():
        if not torch.isfinite(gk[name]).all():
            raise Failed(f"train: kernel-path gradient of {name} is not finite")
        scale = max(float(g.float().abs().max()), floor)
        rel[name] = float((gk[name].float() - g.float()).abs().max()) / scale
    worst = max(rel, key=rel.get)
    shape = {"B": feats["src_tokens"].shape[0], "N": feats["src_tokens"].shape[1],
             "L": feats["input_ids"].shape[1] if "input_ids" in feats else 0}
    print(f"{what}: " + json.dumps({
        "check": "kernel vs plain path, dropout off", **shape, "loss_kernel": lk,
        "loss_plain": lp, "loss_abs_diff": abs(lk - lp), "loss_tol": TRAIN_LOSS_TOL,
        "max_rel_grad_diff": rel[worst], "worst_param": worst,
        "median_rel_grad_diff": statistics.median(rel.values()), "grad_tol": TRAIN_GRAD_TOL,
        "attention_routes": routes,
    }), flush=True)
    if not (abs(lk - lp) <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_TOL):
        raise Failed(f"{what} {shape}: kernel path differs from plain path: loss {lk} vs {lp}, "
                     f"{worst} grad rel diff {rel[worst]}")
    _check_mma_routes(routes, attn, f"{what} {shape} check")


def _graph_resident(dev, atom_pad, smiles_pad, B=32):
    """A Resident dataset of the B molecules of _train_batch (N=atom_pad,
    L=smiles_pad), labels drawn from seed 1, unit sample weights."""
    import torch

    from mmdti_tpu_torch.train.steps import Resident

    labels = torch.randn(B, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    return Resident(_train_batch(dev, atom_pad, smiles_pad, B), labels,
                    torch.ones(B, 1, device=dev))


@contextlib.contextmanager
def _ln_kernels_on():
    """MMDTI_PALLAS_LN=1 inside the block, restored after it."""
    previous = os.environ.get("MMDTI_PALLAS_LN")
    os.environ["MMDTI_PALLAS_LN"] = "1"
    try:
        yield
    finally:
        if previous is None:
            os.environ.pop("MMDTI_PALLAS_LN")
        else:
            os.environ["MMDTI_PALLAS_LN"] = previous


def _set_ln(way):
    os.environ["MMDTI_PALLAS_LN"] = "0" if way == "off" else "1"


def _replay_launches(fn, n=3, tries=5):
    """({launcher: launches} of the port's kernels in one call of fn, device
    ms of a call, device kernels of a call).  The launches come from a
    profiler window of one call (KERNEL_MARKERS), confirmed by a window of
    n calls that holds n times as many of each port kernel; else from the
    difference of windows of 2 and 1 calls, confirmed by that of n + 1 and
    1 (which cancels kernels a tracer drops at every window's start); else
    all are taken again (`tries` times, then the reading fails).  Only the port
    kernels are held to that: the tracer drops the last few of a replayed
    graph's kernels from every window (PyTorch's small gathers and fills
    at the end of the last step), so the device ms and kernel count come
    from the n-call window over n, short by those few."""
    import torch

    def ports(events):
        return {k: sum(c for name, (c, _) in events.items() if m in name)
                for k, m in KERNEL_MARKERS.items()}

    def less(a, b):
        return {k: a[k] - b[k] for k in a}

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        one = ports(_kernel_events(fn, 1))
        window = _kernel_events(fn, n)
        if any(one.values()) and ports(window) == {k: c * n for k, c in one.items()}:
            return (one, sum(us for _, us in window.values()) / n / 1e3,
                    sum(c for c, _ in window.values()) / n)
        # a tracer that drops the same kernels at every window's start
        # (seen on a card that lost a replay's first gbf and LayerNorm
        # forwards in each window): those cancel between a window of k + 1
        # calls and one of 1, which must still hold k times one call's
        base = ports(_kernel_events(fn, 1))
        one_more = less(ports(_kernel_events(fn, 2)), base)
        n_more = less(ports(_kernel_events(fn, n + 1)), base)
        if any(one_more.values()) and n_more == {k: c * n for k, c in one_more.items()}:
            return (one_more, sum(us for _, us in window.values()) / n / 1e3,
                    sum(c for c, _ in window.values()) / n)
        REJECTED_WINDOWS.append({"port_kernels_one_call": one,
                                 f"port_kernels_window_of_{n}": ports(window),
                                 "port_kernels_one_more_call": one_more,
                                 f"port_kernels_{n}_more_calls": n_more})
    raise Failed(f"graph replay windows disagreed {tries} times: {REJECTED_WINDOWS[-tries:]}")


def phase_graphs(dev):
    """K train steps replayed from one CUDA graph (TrainPrograms.feed over
    a resident batch), at the flagship width and depth, bf16, B=32,
    N=L=64, dropout on: (a) graph against eager, LayerNorm kernels off and
    on; (b) the port kernels' launches in one replay; (c) step times,
    graph and eager alternated, and one graph step at N=280; (d) MolTrain.fit
    with the defaults (the feed engaged, steps_per_call=4); (e) MolPredict
    through the sweep against the per-batch path.  Returns what phase fit
    compares with."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP, TrainPrograms

    B, K = 32, GRAPH_K
    model = _flagship(True)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    model.to(dev)
    res = _graph_resident(dev, 64, 64, B)
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(np.stack([rng.permutation(B) for _ in range(K)])).to(dev)
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, 1000, warmup_ratio=0.1, max_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(7)
    progs = TrainPrograms(model, opt, zoo.mse_loss, "regression", gen)
    n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
    attn = _attention_launches(model.unimol_cfg.encoder_layers, n_masked)
    sites = _ln_sites(model)

    def state():
        return [t.clone() for t in (*opt.graph_state, progs.metric_sums)], gen.get_state()

    def restore(saved):
        tensors, gen_state = saved
        with torch.no_grad():
            for t, v in zip((*opt.graph_state, progs.metric_sums), tensors):
                t.copy_(v)
        gen.set_state(gen_state)

    def eager():
        return torch.stack([progs.single(*res.take(idx[k])) for k in range(K)])

    def graph():
        return progs.feed(res, idx)

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    previous = os.environ.get("MMDTI_PALLAS_LN")
    checks, timing = {}, {"off": [], "on": []}
    try:
        # (a) graph against eager from one state, and (b) one replay's launches
        for way in ("off", "on"):
            _set_ln(way)
            s0 = state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            m_e1 = eager()
            after_e1 = state()
            torch.cuda.synchronize()
            peak_eager = torch.cuda.max_memory_allocated(dev)
            restore(s0)
            m_e2 = eager()
            after_e2 = state()
            restore(s0)
            _reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m_g = graph()                      # records the graph, then replays it
            torch.cuda.synchronize()
            first_call_s = time.perf_counter() - t0
            peak_graph = torch.cuda.max_memory_allocated(dev)
            after_g = state()
            capture_counts, capture_routes = _read_counts(), _read_routes()
            ee = gap([*after_e1[0], m_e1], [*after_e2[0], m_e2])
            ge = gap([*after_g[0], m_g], [*after_e1[0], m_e1])
            gen_equal = (torch.equal(after_g[1], after_e1[1])
                         and torch.equal(after_e2[1], after_e1[1]))
            per_step = {**attn, "layer_norm": sites if way == "on" else 0,
                        "layer_norm_bwd": sites if way == "on" else 0}
            replay, replay_ms, replay_kernels = _replay_launches(graph)
            counts_after = _read_counts()
            checks[way] = {
                "eager_vs_eager_max_abs": ee, "graph_vs_eager_max_abs": ge,
                "generator_state_equal": gen_equal,
                "replay_launches": replay,
                "replay_launches_expected": {k: K * n for k, n in per_step.items()},
                "replay_device_ms_per_step": replay_ms / K,
                "replay_kernels_per_step": replay_kernels / K,
                "counters_moved_in_replay": {k: counts_after[k] - capture_counts[k]
                                             for k in counts_after},
                "capture_routes": {k: capture_routes[k]
                                   for k in ("gbf_proj", "pair_bias_attention",
                                             "masked_attention")},
                "first_call_s_warmup_capture_replay": first_call_s,
                "peak_bytes_eager_4_steps": peak_eager,
                "peak_bytes_capture_and_replay": peak_graph,
                # the capture empties the allocator's cache first: this is
                # what stays reserved with the graph's pool
                "reserved_bytes_after_capture": torch.cuda.memory_reserved(dev),
            }
            print(f"graphs: (a)+(b) LayerNorm kernels {way}: " + json.dumps(checks[way]),
                  flush=True)
            if not gen_equal or ge > ee:
                raise Failed(f"graphs {way}: {K} replayed steps differ from {K} eager steps "
                             f"by {ge} (two eager runs: {ee}); generator equal {gen_equal}")
            if replay != {k: K * n for k, n in per_step.items()}:
                raise Failed(f"graphs {way}: one replay launched {replay}, expected {K} x "
                             f"{per_step}")
            if any(counts_after[k] != capture_counts[k] for k in counts_after):
                raise Failed(f"graphs {way}: a replay went through the launchers")
            _check_mma_routes(capture_routes, {k: (GRAPH_WARMUP + 1) * K * n
                                               for k, n in attn.items()}, f"graphs {way}")

        # (c) step times, graph and eager alternated
        for rnd in range(GRAPH_ROUNDS):
            for way in ("off", "on"):
                _set_ln(way)
                row = {"round": rnd}
                for kind in ("eager", "graph"):
                    events = []
                    for _ in range(GRAPH_REPLAYS if kind == "graph" else GRAPH_REPLAYS * K):
                        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        a.record()
                        graph() if kind == "graph" else progs.single(*res.take(idx[0]))
                        b.record()
                        events.append((a, b))
                    torch.cuda.synchronize()
                    per = K if kind == "graph" else 1
                    row[f"{kind}_step_ms_p50"] = statistics.median(
                        a.elapsed_time(b) / per for a, b in events)
                prof = _profile_steps(lambda: progs.single(*res.take(idx[0])), (), n=3)
                row["eager_device_ms_per_step"] = prof["device_ms_per_step"]
                row["eager_kernels_per_step"] = prof["kernel_launches_per_step"]
                _, g_ms, g_kernels = _replay_launches(graph)
                row["graph_device_ms_per_step"] = g_ms / K
                row["graph_kernels_per_step"] = g_kernels / K
                timing[way].append(row)
        summary = {way: {
            "eager_step_ms_p50": statistics.median(r["eager_step_ms_p50"] for r in rows),
            "graph_step_ms_p50": statistics.median(r["graph_step_ms_p50"] for r in rows),
            "rounds": rows} for way, rows in timing.items()}
        print("graphs: (c) " + json.dumps({
            "B": B, "N": 64, "L": 64, "K": K, "dropout": "on",
            "steps_each_way_a_round": GRAPH_REPLAYS * K, **summary}), flush=True)

        # (c) one graph step at the top atom bucket, LayerNorm kernels off
        _set_ln("off")
        res280 = _graph_resident(dev, 280, 64, B)
        one = torch.arange(B, device=dev).view(1, B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        progs.feed(res280, one)
        torch.cuda.synchronize()
        peak_graph280 = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        progs.single(*res280.take(one[0]))
        torch.cuda.synchronize()
        peak_eager280 = torch.cuda.max_memory_allocated(dev)
        _, ms280, kernels280 = _replay_launches(lambda: progs.feed(res280, one))
        print("graphs: (c) " + json.dumps({
            "step": "top atom bucket, K=1 graph", "B": B, "N": 280, "L": 64,
            "graph_step_ms": _time_ms(lambda: progs.feed(res280, one), iters=5, warmup=1),
            "eager_step_ms": _time_ms(lambda: progs.single(*res280.take(one[0])), iters=5,
                                      warmup=1),
            "graph_device_ms": ms280, "graph_kernels": kernels280,
            "peak_bytes_capture_and_replay": peak_graph280, "peak_bytes_eager": peak_eager280,
            "profiler_windows_rejected_so_far": len(REJECTED_WINDOWS),
        }), flush=True)
    finally:
        if previous is None:
            os.environ.pop("MMDTI_PALLAS_LN", None)
        else:
            os.environ["MMDTI_PALLAS_LN"] = previous
    del progs, opt, model, res, res280
    torch.cuda.empty_cache()

    # (d) the fit with the defaults: the feed engaged, steps_per_call=4
    paths, sizes = _fit_data()
    work = os.path.dirname(paths["train"])
    exp = os.path.join(work, "exp_graph")
    fit = _run_fit(paths, exp)
    counts, history = fit["counts"], fit["history"]
    steps = sizes["train"] // 32
    k_feed = _snap_to_divisor(4, steps)
    # one train graph (warm-up and capture) and one sweep graph each for
    # validation and the FDS pass: the launchers count only those
    want = {"layer_norm_bwd": (GRAPH_WARMUP + 1) * k_feed * LN_SITES,
            "gbf_proj_bwd": (GRAPH_WARMUP + 1) * k_feed,
            "gbf_proj": (GRAPH_WARMUP + 1) * (k_feed + 2)}
    resident = _resident_bytes(fit["clf"])
    print("graphs: (d) " + json.dumps({
        "dispatch": "defaults: device_feed auto (engaged), steps_per_call 4",
        "pair_feats": fit["clf"].model.collator.pair_feats, "resident_bytes": resident,
        "steps_per_epoch": steps, "steps_per_replay": k_feed, "epochs": len(history),
        "fit_wall_s": fit["fit_s"], "epoch_wall_s": [r["seconds"] for r in history],
        "epoch_val_s": [r["val_seconds"] for r in history], "history": history,
        "launcher_counts": {k: counts[k] for k in want}, "launcher_counts_expected": want,
    }), flush=True)
    if any(counts[k] != n for k, n in want.items()):
        raise Failed(f"graphs fit: the launchers counted {counts}, expected {want}: the fit "
                     "did not run its steps and sweeps as graph replays")

    # (e) bulk predict: the sweep against the per-batch path
    with _ln_kernels_on():
        swept = MolPredict(load_model=exp)
        test_pred = swept.predict(paths["test"])
        per_batch = MolPredict(load_model=exp)
        per_batch.config["device_feed"] = False
        test_per_batch = per_batch.predict(paths["test"])
    diff = float(np.abs(test_pred - test_per_batch).max())
    print("graphs: (e) " + json.dumps({
        "rows": int(test_pred.shape[0]),
        "sweep_graphs": sum(len(sw.graphs) for _, sw in swept.trainer._sweeps.values()),
        "sweep_vs_per_batch_max_abs": diff, "tol": PREDICT_SWEEP_TOL}), flush=True)
    if not swept.trainer._sweeps or per_batch.trainer._sweeps:
        raise Failed("graphs predict: the sweep did not run where the feed engages, or ran "
                     "where it was off")
    if not diff <= PREDICT_SWEEP_TOL:
        raise Failed(f"graphs predict: the sweep differs from the per-batch path by {diff}")
    return {"paths": paths, "sizes": sizes, "cv_pred": np.asarray(fit["clf"].cv_pred),
            "test_pred": np.asarray(test_pred), "history": history}


def _fit_data():
    """The 400-molecule synthetic regression set (seed 0), scaffold-split
    (seed 0), written under build/; returns ({split: csv path}, {split:
    rows}).  Prints the host featurization time of all of it."""
    import shutil

    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.data.reader import read_csv, write_csv
    from mmdti_tpu_torch.finetune import make_synthetic_dataset
    from mmdti_tpu_torch.splits import random_scaffold_split

    work = os.path.join(REPO, "build", "chip_smoke_fit")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data = os.path.join(work, "synthetic.csv")
    make_synthetic_dataset(data, n=FIT_MOLECULES, seed=0)
    paths = {}
    for name, table in zip(("train", "val", "test"), random_scaffold_split(data, 0)):
        paths[name] = os.path.join(work, f"{name}.csv")
        write_csv(table, paths[name])
    sizes = {k: len(read_csv(p)["smiles"]) for k, p in paths.items()}
    t0 = time.perf_counter()
    ConformerGen().transform(list(read_csv(data)["smiles"]))
    featurize_s = time.perf_counter() - t0
    print(f"fit: {FIT_MOLECULES} molecules, split {sizes}; host featurization of all of them "
          f"{featurize_s:.2f} s (the fit and each predict featurize their sets again)",
          flush=True)
    return paths, sizes


def _run_fit(paths, exp, epochs=FIT_EPOCHS, **dispatch):
    """MolTrain.fit(train, val) at the flagship width and depth (bf16, B=32,
    ``epochs`` epochs, dropout, InfoNCE, CT, sample weights, FDS) with
    MMDTI_PALLAS_LN=1 (restored after); ``dispatch`` sets device_feed and
    steps_per_call (the defaults otherwise) or other MolTrain options.  Returns the model, fit
    seconds, the launch counts and routes of the fit, and its history."""
    import torch

    from mmdti_tpu_torch import MolTrain

    with _ln_kernels_on():
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(task="regression", epochs=epochs, learning_rate=1e-4, batch_size=32,
                       early_stopping=20, metrics="mse", smiles_col="smiles", save_path=exp,
                       target_cols=["measured"], using_infonce=True, using_ct=True,
                       raw_data=paths["train"], seed=42, use_weight=True, fds=True, fds_num=30,
                       fds_raw_path=paths["train"], fds_col_data="measured",
                       target_anomaly_check="filter", device="cuda", **dispatch)
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    with open(os.path.join(exp, "history_0.json")) as f:
        history = json.load(f)
    return {"clf": clf, "fit_s": fit_s, "counts": _read_counts(), "routes": _read_routes(),
            "history": history}


def _resident_bytes(clf):
    """The bytes of a fit's resident train and validation arrays: as the
    fit held them (device pair mode: coordinates) and with the same rows
    collated in host pair mode (the [N,N] arrays), put on the card to be
    counted and freed."""
    import numpy as np
    import torch

    from mmdti_tpu_torch.data.batching import BatchCollator, MolDataset

    trainer, nn, c = clf.trainer, clf.model, clf.model.collator
    host = BatchCollator(c.tokenizer, pad_idx=c.pad_idx, pad_mode=c.pad_mode,
                         atom_pad=c.atom_pad, smiles_pad=c.smiles_pad, pair_feats="host")
    out = {"fit": {slot: trainer._slots[slot].nbytes for slot in ("train", "val")}, "host": {}}
    for slot, feats, target in (("train", nn.features_train, nn.data_train["target"]),
                                ("val", nn.features_test, nn.data_test["target"])):
        res, _ = trainer.dataset_to_device(MolDataset(feats, np.asarray(target)), host)
        out["host"][slot] = res.nbytes
        del res
    torch.cuda.empty_cache()
    out["host_over_fit"] = sum(out["host"].values()) / sum(out["fit"].values())
    return out


def _ln_sites(model):
    from mmdti_tpu_torch.models.layers import FusedLN

    return sum(1 for m in model.modules()
               if isinstance(m, FusedLN) and m.use_kernels and m.weight.numel() % 128 == 0)


def phase_fit(dev, graph_fit):
    """MolTrain.fit -> MolPredict at the flagship width and depth with the
    LayerNorm kernels engaged, on the eager path (device_feed=False,
    steps_per_call=1: every step and evaluation issued from the host, so
    the launch counters count them all); its predictions against the
    graph-replayed fit of phase graphs.  Returns the launch counts of the
    phase."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict
    from mmdti_tpu_torch.data.reader import read_csv

    paths, sizes, work = graph_fit["paths"], graph_fit["sizes"], os.path.dirname(
        graph_fit["paths"]["train"])
    exp = os.path.join(work, "exp")
    fit = _run_fit(paths, exp, device_feed=False, steps_per_call=1)
    clf, fit_counts, fit_routes, history = fit["clf"], fit["counts"], fit["routes"], fit["history"]
    with _ln_kernels_on():
        test_pred = MolPredict(load_model=exp).predict(paths["test"],
                                                      save_path=os.path.join(work, "out"))
        launches = _read_counts()
        val_pred = MolPredict(load_model=exp).predict(paths["val"])
        plain = MolPredict(load_model=exp)
        plain.config["use_pallas"] = False
        val_plain = plain.predict(paths["val"])
    torch.cuda.synchronize()

    model = clf.model.model
    ucfg = model.unimol_cfg
    per_forward = _ln_sites(model)
    steps = sizes["train"] // 32
    epochs_run = len(history)
    train_steps = steps * epochs_run
    truth = np.asarray(read_csv(paths["test"])["measured"], np.float64)
    rmse = float(np.sqrt(np.mean((truth - test_pred.reshape(-1)) ** 2)))
    reload_diff = float(np.abs(val_pred - clf.cv_pred).max())
    plain_diff = float(np.abs(val_pred - val_plain).max())
    graph_diff = float(np.abs(graph_fit["cv_pred"] - clf.cv_pred).max())
    graph_test_diff = float(np.abs(graph_fit["test_pred"] - test_pred).max())
    print("fit: " + json.dumps({
        "model": {"layers": ucfg.encoder_layers, "E": ucfg.embed_dim, "H": ucfg.attention_heads,
                  "compute": "bf16", "pair": ucfg.pair_dtype, "batch": 32},
        "dispatch": "eager: device_feed=False, steps_per_call=1",
        "epochs": epochs_run, "steps_per_epoch": steps, "fit_wall_s": fit["fit_s"],
        "epoch_wall_s": [row["seconds"] for row in history],
        "epoch_val_s": [row["val_seconds"] for row in history],
        "val_mse": [row["val_mse"] for row in history],
        "layer_norms_per_forward": per_forward,
        "fit_launches": {k: fit_counts[k] for k in ("layer_norm", "layer_norm_bwd")},
        "fit_ln_backward_per_step": fit_counts["layer_norm_bwd"] / train_steps,
        "fit_ln_forward_per_step_incl_eval": fit_counts["layer_norm"] / train_steps,
        "fit_gbf_routes": {k: fit_routes[k] for k in ("gbf_proj", "gbf_proj_bwd")},
        "artifacts": sorted(os.listdir(exp)),
        "predict_files": sorted(os.listdir(os.path.join(work, "out"))),
        "reload_vs_fit_max_abs_diff": reload_diff,
        "kernel_vs_plain_max_abs_diff": plain_diff, "plain_tol": LOGITS_TOL,
        "graph_fit_vs_eager_fit_val_max_abs_diff": graph_diff,
        "graph_fit_vs_eager_fit_test_max_abs_diff": graph_test_diff,
        "graph_fit_tol": LOGITS_TOL,
        "history_equal_to_graph_fit": _without_times(history) == _without_times(
            graph_fit["history"]),
        "test_rmse_seed0": rmse,
    }), flush=True)
    if reload_diff != 0.0:
        raise Failed(f"fit: MolPredict's reload differs from the fit's predictions by "
                     f"{reload_diff}")
    if not plain_diff <= LOGITS_TOL:
        raise Failed(f"fit: kernel path differs from plain path by {plain_diff}")
    if not (graph_diff <= LOGITS_TOL and graph_test_diff <= LOGITS_TOL):
        raise Failed(f"fit: the graph-replayed fit differs from the eager fit by {graph_diff} "
                     f"(val), {graph_test_diff} (test)")
    if not np.isfinite(test_pred).all() or not np.isfinite(rmse):
        raise Failed(f"fit: test predictions not finite (rmse {rmse})")
    want_bwd = per_forward * train_steps
    if per_forward != LN_SITES or fit_counts["layer_norm_bwd"] != want_bwd:
        raise Failed(f"fit layer_norm_bwd: {fit_counts['layer_norm_bwd']} launches, expected "
                     f"{LN_SITES} x {train_steps} ({per_forward} sites)")
    if fit_counts["layer_norm"] % per_forward or fit_counts["layer_norm"] <= want_bwd:
        raise Failed(f"fit layer_norm: {fit_counts['layer_norm']} launches")
    if fit_counts["gbf_proj"] <= train_steps:   # one a train step, more for evaluation
        raise Failed(f"fit gbf_proj: {fit_counts['gbf_proj']} launches in {train_steps} steps")
    _check_mma_routes(fit_routes, {"gbf_proj": fit_counts["gbf_proj"],
                                   "gbf_proj_bwd": train_steps}, "fit")
    return launches


def _task_fit(task, paths, caches, work):
    """MolTrain.fit(train, val) -> MolPredict.predict(test) for ``task`` at
    the flagship width and depth with the defaults (the resident feed, 4
    steps a dispatch, CUDA graphs), bf16, B=32, TASK_EPOCHS epochs, InfoNCE
    and CT, MMDTI_PALLAS_LN=1; the launcher counts of the fit and of the
    predict, each from 0."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.api.predict_api import load_threshold
    from mmdti_tpu_torch.configs.config import load_yaml
    from mmdti_tpu_torch.data.reader import read_csv
    from mmdti_tpu_torch.finetune import MULTILABEL_COLS, _score_task

    exp, out = os.path.join(work, f"exp_{task}"), os.path.join(work, f"out_{task}")
    target_cols = MULTILABEL_COLS if task == "multilabel_classification" else ["measured"]
    with _ln_kernels_on():
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(task=task, epochs=TASK_EPOCHS, learning_rate=1e-4, batch_size=32,
                       early_stopping=20, metrics="log_loss" if task == "multiclass" else "auc",
                       smiles_col="smiles", save_path=exp, target_cols=target_cols,
                       using_infonce=True, using_ct=True, raw_data=paths["train"], seed=42,
                       cache_dir_train=caches["train"], cache_dir_test=caches["val"],
                       device="cuda")
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts, fit_routes = _read_counts(), _read_routes()
        _reset_counts()
        pred = MolPredict(load_model=exp, cache_dir=caches["test"]).predict(paths["test"],
                                                                          save_path=out)
        pred_counts, pred_routes = _read_counts(), _read_routes()
        val_kernel = MolPredict(load_model=exp, cache_dir=caches["val"]).predict(paths["val"])
        plain = MolPredict(load_model=exp, cache_dir=caches["val"])
        plain.config["use_pallas"] = False
        val_plain = plain.predict(paths["val"])
    with open(os.path.join(exp, "history_0.json")) as f:
        history = json.load(f)
    test = read_csv(paths["test"])
    truth = np.stack([np.asarray(test[c], np.float64) for c in target_cols], axis=1)
    if task == "classification":
        truth = truth.reshape(-1)
    csv = read_csv(os.path.join(out, "test.predict.0.csv"))
    config = load_yaml(os.path.join(exp, "config.yaml"))
    threshold = (None if task == "multiclass"
                 else np.asarray(load_threshold(os.path.join(exp, "threshold.dat"))).tolist())
    return {"clf": clf, "fit_s": fit_s, "history": history, "pred": np.asarray(pred),
            "fit_counts": fit_counts, "fit_routes": fit_routes, "pred_counts": pred_counts,
            "pred_routes": pred_routes, "csv": csv, "threshold": threshold,
            "multiclass_cnt": config.get("multiclass_cnt"), "artifacts": sorted(os.listdir(exp)),
            "kernel_vs_plain": float(np.abs(np.asarray(val_kernel) - val_plain).max()),
            "test_metric": _score_task(task, truth, np.asarray(pred), 0)}


def _graph_launches(per_forward, k, sweeps):
    """Launcher counts of a default fit: one train graph of k steps and
    ``sweeps`` sweep graphs (one forward each), warmed up and captured;
    the replays launch through no launcher."""
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    runs = GRAPH_WARMUP + 1
    want = {}
    for name, n in per_forward.items():
        want[name] = runs * (k + sweeps) * n
        want[name + "_bwd"] = runs * k * n
    return want


def _ghm_graph_check(dev):
    """K flagship multilabel_classification steps with loss_key="ghm"
    (GHMCState: EMA bin counts carried on the device), replayed from one
    CUDA graph, against K eager steps from the same state, run twice:
    parameters, moments, counts, metrics, the bin counts and flag, and the
    generator must match as closely as the two eager runs match each
    other."""
    import numpy as np
    import torch

    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP, Resident, TrainPrograms

    B, K = 32, GRAPH_K
    model = _flagship(True, output_dim=3)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    model.to(dev)
    labels = torch.randint(0, 2, (B, 3), generator=torch.Generator().manual_seed(1)).float()
    res = Resident(_train_batch(dev, 64, 64, B), labels.to(dev), torch.ones(B, 1, device=dev))
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(np.stack([rng.permutation(B) for _ in range(K)])).to(dev)
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, 1000, warmup_ratio=0.1, max_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(7)
    ghm = zoo.GHMCState(dev)
    progs = TrainPrograms(model, opt, ghm, "multilabel_classification", gen)
    tensors = (*opt.graph_state, progs.metric_sums, *ghm.graph_state)

    def state():
        return [t.clone() for t in tensors], gen.get_state()

    def restore(saved):
        with torch.no_grad():
            for t, v in zip(tensors, saved[0]):
                t.copy_(v)
        gen.set_state(saved[1])

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    s0 = state()
    m_e1 = torch.stack([progs.single(*res.take(idx[k])) for k in range(K)])
    after_e1 = state()
    restore(s0)
    m_e2 = torch.stack([progs.single(*res.take(idx[k])) for k in range(K)])
    after_e2 = state()
    restore(s0)
    _reset_counts()
    m_g = progs.feed(res, idx)
    torch.cuda.synchronize()
    after_g = state()
    routes = _read_routes()
    ee = gap([*after_e1[0], m_e1], [*after_e2[0], m_e2])
    ge = gap([*after_g[0], m_g], [*after_e1[0], m_e1])
    bins_gap = gap(after_g[0][-2:], after_e1[0][-2:])
    gen_equal = torch.equal(after_g[1], after_e1[1]) and torch.equal(after_e2[1], after_e1[1])
    result = {"check": "GHM-C steps, graph vs eager", "B": B, "N": 64, "L": 64, "K": K,
              "eager_vs_eager_max_abs": ee, "graph_vs_eager_max_abs": ge,
              "bin_state_graph_vs_eager_max_abs": bins_gap,
              "bin_count_after": after_g[0][-2].tolist(), "flag_after": float(after_g[0][-1]),
              "generator_state_equal": gen_equal, "m_loss_per_step": m_g[:, 1].tolist(),
              "capture_routes": {k: routes[k] for k in ("gbf_proj", "pair_bias_attention",
                                                       "masked_attention")}}
    print("tasks: (b) " + json.dumps(result), flush=True)
    if not gen_equal or ge > ee or bins_gap > ee:
        raise Failed(f"tasks ghm: {K} replayed GHM steps differ from {K} eager steps by {ge} "
                     f"(bins {bins_gap}; two eager runs: {ee}); generator equal {gen_equal}")
    if float(after_g[0][-1]) != 1.0 or not torch.isfinite(m_g).all():
        raise Failed(f"tasks ghm: flag {float(after_g[0][-1])}, metrics {m_g.tolist()}")
    n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
    attn = _attention_launches(model.unimol_cfg.encoder_layers, n_masked)
    _check_mma_routes(routes, {k: (GRAPH_WARMUP + 1) * K * n for k, n in attn.items()},
                      "tasks ghm")
    del progs, opt, model, res
    torch.cuda.empty_cache()


def phase_tasks(dev):
    """The classification tasks on the main path: (a) for classification,
    multiclass and multilabel_classification (focal), the synthetic set of
    the task (seed 0), scaffold-split (seed 0), MolTrain.fit with the
    defaults (feed and graphs) at the flagship width and depth and
    MolPredict.predict(test); the molecules are featurized once and the
    three fits read the same conformer caches.  (b) GHM-C steps replayed
    from one CUDA graph against eager steps.  Returns the launch counts of
    each task's fit and predict."""
    import shutil

    import numpy as np
    import torch

    from mmdti_tpu_torch.data.reader import read_csv, write_csv
    from mmdti_tpu_torch.finetune import MULTILABEL_COLS, make_synthetic_dataset
    from mmdti_tpu_torch.splits import random_scaffold_split
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor

    work = os.path.join(REPO, "build", "chip_smoke_tasks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    caches = {k: os.path.join(work, f"{k}.features.pkl") for k in ("train", "val", "test")}
    launches, split_smiles = {}, None
    for task in TASK_FITS:
        tdir = os.path.join(work, task)
        os.makedirs(tdir)
        data = os.path.join(tdir, "synthetic.csv")
        make_synthetic_dataset(data, n=FIT_MOLECULES, seed=0, task=task)
        paths = {}
        for name, table in zip(("train", "val", "test"), random_scaffold_split(data, 0)):
            paths[name] = os.path.join(tdir, f"{name}.csv")
            write_csv(table, paths[name])
        smiles = {k: list(read_csv(p)["smiles"]) for k, p in paths.items()}
        if split_smiles is not None and smiles != split_smiles:
            raise Failed(f"tasks {task}: the scaffold split differs from the first task's, so "
                         "the shared conformer caches do not apply")
        split_smiles = smiles
        r = _task_fit(task, paths, caches, tdir)
        model = r["clf"].model.model
        n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
        per_forward = {"gbf_proj": 1, "pair_bias_attention": model.unimol_cfg.encoder_layers,
                       "masked_attention": n_masked, "layer_norm": _ln_sites(model)}
        steps = len(smiles["train"]) // 32
        k_feed = _snap_to_divisor(GRAPH_K, steps)
        want_fit = _graph_launches(per_forward, k_feed, sweeps=1)
        want_pred = _graph_launches(per_forward, 0, sweeps=1)
        csv = r["csv"]
        if task == "multiclass":
            prob_cols = [f"prob_{i}" for i in range(r["multiclass_cnt"] or 0)]
            label_cols = ["predict_measured"]
        else:
            cols = MULTILABEL_COLS if task == "multilabel_classification" else ["measured"]
            prob_cols = [f"prob_{c}" for c in cols]
            label_cols = [f"predict_{c}" for c in cols]
        probs = np.stack([np.asarray(csv[c], np.float64) for c in prob_cols], axis=1)
        row_sum_err = (float(np.abs(probs.sum(axis=1) - 1).max()) if task == "multiclass"
                       else None)
        labels = np.stack([np.asarray(csv[c]) for c in label_cols], axis=1)
        hist = r["history"]
        print(f"tasks: (a) {task} " + json.dumps({
            "model": {"layers": model.unimol_cfg.encoder_layers, "E": model.unimol_cfg.embed_dim,
                      "H": model.unimol_cfg.attention_heads, "compute": "bf16",
                      "output_dim": model.output_dim, "batch": 32},
            "dispatch": "defaults: device_feed auto (engaged), steps_per_call 4",
            "split": {k: len(v) for k, v in smiles.items()}, "epochs": len(hist),
            "steps_per_epoch": steps, "steps_per_replay": k_feed, "fit_wall_s": r["fit_s"],
            "epoch_wall_s": [row["seconds"] for row in hist],
            "history": [{k: v for k, v in row.items() if k.startswith(("val_", "train_loss"))}
                        for row in hist],
            "artifacts": r["artifacts"], "threshold_dat": r["threshold"],
            "multiclass_cnt": r["multiclass_cnt"], "predict_columns": list(csv),
            "prob_min": float(probs.min()), "prob_max": float(probs.max()),
            "multiclass_row_sum_max_abs_err": row_sum_err,
            "label_values": sorted(set(np.asarray(labels).ravel().tolist())),
            "fit_launches": r["fit_counts"], "fit_launches_expected": want_fit,
            "predict_launches": r["pred_counts"], "predict_launches_expected": want_pred,
            "kernel_vs_plain_val_max_abs_diff": r["kernel_vs_plain"], "plain_tol": LOGITS_TOL,
            "test_metric_seed0": r["test_metric"],
            "test_metric_is": "macro one-vs-rest AUC" if task == "multiclass" else (
                "NaN-masked column-mean AUC" if task == "multilabel_classification"
                else "ROC-AUC"),
        }), flush=True)
        if r["fit_counts"] != want_fit:
            raise Failed(f"tasks {task} fit: the launchers counted {r['fit_counts']}, expected "
                         f"{want_fit}: the fit did not run as one train graph and one sweep")
        if r["pred_counts"] != want_pred:
            raise Failed(f"tasks {task} predict: the launchers counted {r['pred_counts']}, "
                         f"expected {want_pred}")
        mma = {k: n for k, n in r["fit_counts"].items() if k in r["fit_routes"]}
        _check_mma_routes(r["fit_routes"], mma, f"tasks {task} fit")
        _check_mma_routes(r["pred_routes"], {k: n for k, n in r["pred_counts"].items()
                                             if k in r["pred_routes"]}, f"tasks {task} predict")
        if not (np.isfinite(probs).all() and probs.min() >= 0.0 and probs.max() <= 1.0):
            raise Failed(f"tasks {task}: probabilities outside [0, 1]")
        if row_sum_err is not None and not row_sum_err <= 1e-5:
            raise Failed(f"tasks {task}: class probabilities sum to 1 within {row_sum_err}")
        if task == "multiclass":
            if r["multiclass_cnt"] != 3 or probs.shape[1] != 3:
                raise Failed(f"tasks multiclass: multiclass_cnt {r['multiclass_cnt']}")
            if not np.array_equal(labels[:, 0], probs.argmax(axis=1)):
                raise Failed("tasks multiclass: predict_measured is not the argmax")
        else:
            if r["threshold"] != 0.5 or "threshold.dat" not in r["artifacts"]:
                raise Failed(f"tasks {task}: threshold.dat holds {r['threshold']}")
            if not np.array_equal(labels, (probs > 0.5).astype(int)):
                raise Failed(f"tasks {task}: the predict columns are not the probabilities "
                             "cut at 0.5")
        if not r["kernel_vs_plain"] <= LOGITS_TOL:
            raise Failed(f"tasks {task}: kernel path differs from plain path by "
                         f"{r['kernel_vs_plain']}")
        if not np.isfinite(r["test_metric"]):
            raise Failed(f"tasks {task}: test metric {r['test_metric']}")
        launches[task] = {k: r["fit_counts"][k] + r["pred_counts"][k] for k in KERNELS}
        del r, model
        torch.cuda.empty_cache()
    _ghm_graph_check(dev)
    return launches


def _cv_kwargs(save_path, **extra):
    """MolTrain at the flagship width and depth with the defaults (the
    resident feed, 4 steps a CUDA graph): bf16, B=32, dropout, InfoNCE, CT,
    the target scaler."""
    return {**dict(task="regression", epochs=CV_EPOCHS, learning_rate=1e-4, batch_size=32,
                   early_stopping=20, metrics="mse", smiles_col="smiles", save_path=save_path,
                   target_cols=["measured"], using_infonce=True, using_ct=True, seed=42,
                   use_scaler=True, device="cuda"), **extra}


def _add_counts(*counts):
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def _max_leaf_gap(a, b):
    """Largest absolute difference between two flax parameter trees."""
    import numpy as np

    def leaves(t):
        return ([x for k in sorted(t) for x in leaves(t[k])] if isinstance(t, dict)
                else [np.asarray(t, np.float64)])

    return max(float(np.abs(x - y).max()) for x, y in zip(leaves(a), leaves(b)))


def _cv_expected_graphs(splits, per_forward):
    """The launcher counts of a CV fit: a fold records a train graph when
    its batches a epoch or its resident train rows differ from the fold
    before it (train/fit_loop.py reuses the last fold's programs and
    resident arrays), and a validation sweep graph when its resident
    validation rows do; each graph's warm-ups and capture launch, the
    replays do not."""
    from mmdti_tpu_torch.train.device_feed import row_bucket
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor

    want, graphs, last_train, last_val = {}, [], None, None
    for tr, va in splits:
        nb = len(tr) // 32
        if (nb, row_bucket(len(tr))) != last_train:
            k = _snap_to_divisor(GRAPH_K, nb)
            graphs.append(("train", k))
            want = _add_counts(want, _graph_launches(per_forward, k, 0))
        if row_bucket(len(va)) != last_val:
            graphs.append(("val_sweep", 1))
            want = _add_counts(want, _graph_launches(per_forward, 0, 1))
        last_train, last_val = (nb, row_bucket(len(tr))), row_bucket(len(va))
    return want, graphs


def _cv_fit_check(work, data, test_csv, caches):
    """(a) MolTrain(kfold=3, split="scaffold").fit on the whole set, its
    artifacts and folds, the launcher counts, the reused fold against a
    fresh fit of it, and the predict side on the test split."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolServe, MolTrain
    from mmdti_tpu_torch.configs.config import load_yaml, save_yaml
    from mmdti_tpu_torch.data.reader import read_csv
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint

    exp = os.path.join(work, "exp_cv")
    with _ln_kernels_on():
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(kfold=CV_FOLDS, split="scaffold", cache_dir_train=caches["all"],
                       **_cv_kwargs(exp)).fit(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, routes = _read_counts(), _read_routes()
    model = clf.model.model
    n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
    per_forward = {"gbf_proj": 1, "pair_bias_attention": model.unimol_cfg.encoder_layers,
                   "masked_attention": n_masked, "layer_norm": _ln_sites(model)}
    splits = clf._cv_splits(CV_FOLDS)
    want, graphs = _cv_expected_graphs(splits, per_forward)
    n = len(clf.data_train["target"])
    covered = np.sort(np.concatenate([va for _, va in splits]))
    groups = np.asarray(clf.data_train["group"])
    fold_of = {}
    spanning = 0
    for f, (_, va) in enumerate(splits):
        for g in set(groups[va].tolist()):
            spanning += g in fold_of
            fold_of[g] = f
    config = load_yaml(os.path.join(exp, "config.yaml"))

    # the second fold (programs reset in place, graphs replayed) against a
    # fit of that fold alone on a fresh trainer
    fresh_exp = os.path.join(work, "exp_cv_fold1_alone")
    with _ln_kernels_on():
        t0 = time.perf_counter()
        fresh = MolTrain(kfold=CV_FOLDS, split="scaffold", cache_dir_train=caches["all"],
                         **_cv_kwargs(fresh_exp))
        fresh._cv_splits = lambda k: [splits[1]]
        fresh.fit(data)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
    reuse_gap = _max_leaf_gap(load_checkpoint(exp, 1)["params"],
                              load_checkpoint(fresh_exp, 0)["params"])
    oof_gap = float(np.abs(clf.cv_pred[splits[1][1]] - fresh.cv_pred[splits[1][1]]).max())

    # the predict side: the ensemble, each fold alone, the plain path, the server
    solo_dirs = []
    for fold in range(CV_FOLDS):
        solo = os.path.join(work, f"exp_cv_solo{fold}")
        shutil.copytree(exp, solo)
        cfg = load_yaml(os.path.join(solo, "config.yaml"))
        cfg["model_folds"] = 1
        save_yaml(cfg, os.path.join(solo, "config.yaml"))
        for f in range(CV_FOLDS):
            if f != fold:
                os.remove(os.path.join(solo, f"model_{f}.ckpt"))
        os.replace(os.path.join(solo, f"model_{fold}.ckpt"), os.path.join(solo, "model_0.ckpt"))
        solo_dirs.append(solo)
    smiles = list(read_csv(test_csv)["smiles"])
    with _ln_kernels_on():
        _reset_counts()
        ens = MolPredict(load_model=exp, cache_dir=caches["test"]).predict(test_csv)
        torch.cuda.synchronize()
        pred_counts, pred_routes = _read_counts(), _read_routes()
        singles = [MolPredict(load_model=d, cache_dir=caches["test"]).predict(test_csv)
                   for d in solo_dirs]
        plain = MolPredict(load_model=exp, cache_dir=caches["test"])
        plain.config["use_pallas"] = False
        plain_pred = plain.predict(test_csv)
        server = MolServe(exp, serve_folds="all")
        served = np.asarray(server.predict(smiles)["predict"])
    mean_gap = float(np.abs(ens - np.mean(np.stack(singles), axis=0)).max())
    serve_gap = float(np.abs(served.reshape(ens.shape) - ens).max())
    plain_gap = float(np.abs(plain_pred - ens).max())
    fold_spread = float(np.abs(singles[0] - singles[1]).max())
    want_pred = _graph_launches(per_forward, 0, sweeps=1)
    result = {
        "model": {"layers": model.unimol_cfg.encoder_layers, "E": model.unimol_cfg.embed_dim,
                  "H": model.unimol_cfg.attention_heads, "compute": "bf16", "batch": 32},
        "dispatch": "defaults: device_feed auto (engaged), steps_per_call 4, MMDTI_PALLAS_LN=1",
        "molecules": n, "folds": CV_FOLDS, "epochs": CV_EPOCHS,
        "fold_sizes": [[len(tr), len(va)] for tr, va in splits],
        "fit_wall_s": fit_s, "fold_wall_s": clf.model.fold_seconds,
        "fold1_alone_wall_s": fresh_s,
        "artifacts": sorted(os.listdir(exp)), "model_folds": config.get("model_folds"),
        "split_method": config.get("split_method"),
        "oof_rows_covered_once": bool(np.array_equal(covered, np.arange(n))),
        "oof_finite": bool(np.isfinite(clf.cv_pred).all()),
        "scaffolds": len(fold_of), "scaffolds_in_two_folds": spanning,
        "programs_built": clf.trainer.programs_built, "graphs_recorded": graphs,
        "fit_launches": counts, "fit_launches_expected": want,
        "reused_fold_vs_fresh_fit_params_max_abs": reuse_gap,
        "reused_fold_vs_fresh_fit_oof_max_abs": oof_gap,
        "predict_launches": pred_counts, "predict_launches_expected": want_pred,
        "ensemble_vs_mean_of_folds_max_abs": mean_gap, "ensemble_tol": CV_ENSEMBLE_TOL,
        "fold_spread_max_abs": fold_spread,
        "serve_all_vs_molpredict_max_abs": serve_gap, "serve_graphs": len(server.graphs),
        "kernel_vs_plain_max_abs": plain_gap, "plain_tol": LOGITS_TOL,
    }
    print("cv: (a) " + json.dumps(result), flush=True)
    if result["model_folds"] != CV_FOLDS or not all(
            f"model_{f}.ckpt" in result["artifacts"] for f in range(CV_FOLDS)) or (
            "target_scaler.ss" not in result["artifacts"]):
        raise Failed(f"cv: artifacts {result['artifacts']}, model_folds {result['model_folds']}")
    if not (result["oof_rows_covered_once"] and result["oof_finite"]):
        raise Failed("cv: the out-of-fold predictions do not cover every row once, finite")
    if spanning:
        raise Failed(f"cv: {spanning} scaffolds span two folds")
    if counts != want:
        raise Failed(f"cv fit: the launchers counted {counts}, expected {want} ({graphs})")
    _check_mma_routes(routes, {k: n for k, n in counts.items() if k in routes}, "cv fit")
    if reuse_gap != 0.0 or oof_gap != 0.0:
        raise Failed(f"cv: the reused second fold differs from a fresh fit of it by {reuse_gap} "
                     f"(weights), {oof_gap} (predictions)")
    if pred_counts != want_pred:
        raise Failed(f"cv predict: the launchers counted {pred_counts}, expected {want_pred}")
    _check_mma_routes(pred_routes, {k: n for k, n in pred_counts.items() if k in pred_routes},
                      "cv predict")
    if not mean_gap <= CV_ENSEMBLE_TOL:
        raise Failed(f"cv: the ensemble differs from the mean of its folds by {mean_gap}")
    if not (serve_gap <= LOGITS_TOL and plain_gap <= LOGITS_TOL):
        raise Failed(f"cv: MolServe(serve_folds='all') differs from MolPredict by {serve_gap}, "
                     f"the plain path by {plain_gap}")
    del server, clf, fresh
    torch.cuda.empty_cache()
    return counts


def _resume_check(work, paths, caches):
    """(b) fit(train, val) for RESUME_EPOCHS epochs twice uninterrupted,
    and stopped after RESUME_STOP then resumed (checkpoint_interval=1):
    the last epoch's history row, the weights and the predictions."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.train.checkpointing import (
        load_checkpoint,
        load_train_state,
        train_state_path,
    )

    kw = dict(epochs=RESUME_EPOCHS, cache_dir_train=caches["train"], cache_dir_test=caches["val"],
              raw_data=paths["train"], use_weight=True, fds=True, fds_num=30,
              fds_raw_path=paths["train"], fds_col_data="measured")
    runs = {}
    with _ln_kernels_on():
        for name, exp, extra in (
                ("whole_1", "exp_whole1", {}), ("whole_2", "exp_whole2", {}),
                ("stopped", "exp_parted", {"stop_after_epoch": RESUME_STOP,
                                           "checkpoint_interval": 1}),
                ("resumed", "exp_parted", {"resume": True, "checkpoint_interval": 1})):
            exp = os.path.join(work, exp)
            t0 = time.perf_counter()
            clf = MolTrain(**_cv_kwargs(exp, **kw, **extra)).fit(paths["train"], paths["val"])
            torch.cuda.synchronize()
            with open(os.path.join(exp, "history_0.json")) as f:
                history = json.load(f)
            runs[name] = {"exp": exp, "s": time.perf_counter() - t0, "history": history,
                          "cv_pred": np.asarray(clf.cv_pred), "saves": clf.trainer.state_saves,
                          "params": load_checkpoint(exp, 0)["params"]}
            del clf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    load_train_state(runs["resumed"]["exp"], 0)
    load_s = time.perf_counter() - t0
    state_bytes = os.path.getsize(train_state_path(runs["resumed"]["exp"], 0))

    def gaps(a, b):
        ra, rb = _without_times([a["history"][-1]])[0], _without_times([b["history"][-1]])[0]
        return {"last_row": max(abs(ra[k] - rb[k]) for k in ra),
                "params": _max_leaf_gap(a["params"], b["params"]),
                "predictions": float(np.abs(a["cv_pred"] - b["cv_pred"]).max())}

    whole = gaps(runs["whole_1"], runs["whole_2"])
    parted = gaps(runs["whole_1"], runs["resumed"])
    result = {
        "epochs": RESUME_EPOCHS, "stop_after_epoch": RESUME_STOP,
        "history_epochs_resumed": [r["epoch"] for r in runs["resumed"]["history"]],
        "uninterrupted_vs_uninterrupted": whole, "uninterrupted_vs_resumed": parted,
        "fit_wall_s": {k: r["s"] for k, r in runs.items()},
        "train_state_bytes": state_bytes,
        "saves_stopped_run": runs["stopped"]["saves"],
        "saves_resumed_run": runs["resumed"]["saves"],
        "train_state_load_s": load_s,
        # against the second uninterrupted fit: the first also wrote the
        # conformer caches every later fit reads
        "resume_overhead_s": runs["stopped"]["s"] + runs["resumed"]["s"] - runs["whole_2"]["s"],
    }
    print("cv: (b) " + json.dumps(result), flush=True)
    if result["history_epochs_resumed"] != list(range(1, RESUME_EPOCHS + 1)):
        raise Failed(f"cv resume: history epochs {result['history_epochs_resumed']}")
    if [(s["epoch"], s["async"]) for s in runs["stopped"]["saves"]] != [(1, True), (2, False)]:
        raise Failed(f"cv resume: the stopped run saved {runs['stopped']['saves']}")
    for k, gap in parted.items():
        if gap > whole[k]:
            raise Failed(f"cv resume: the resumed fit differs from the uninterrupted one by {gap} "
                         f"({k}); two uninterrupted fits differ by {whole[k]}")


def _profile_and_nan_check(work, paths, caches):
    """(c) a fit with profile_dir writes a trace holding the port kernels'
    names; a fit with debug_nans and a NaN target raises
    FloatingPointError."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.data.reader import read_csv, take_rows, write_csv
    from mmdti_tpu_torch.train.profiler import trace_file

    trace_dir = os.path.join(work, "trace")
    with _ln_kernels_on():
        t0 = time.perf_counter()
        MolTrain(**_cv_kwargs(os.path.join(work, "exp_profiled"), epochs=1,
                              cache_dir_train=caches["train"], cache_dir_test=caches["val"],
                              profile_dir=trace_dir, profile_steps=1)).fit(paths["train"],
                                                                          paths["val"])
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    path = trace_file(trace_dir, "fold0")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sum(m in name for name in kernels) > 0 for k, m in KERNEL_MARKERS.items()}

    table = read_csv(paths["train"])
    bad = take_rows(table, list(range(min(96, len(table["smiles"])))))
    measured = np.asarray(bad["measured"], np.float64).copy()
    measured[5] = np.nan
    bad["measured"] = measured
    bad_csv = os.path.join(work, "train_nan.csv")
    write_csv(bad, bad_csv)
    raised = None
    with _ln_kernels_on():
        try:
            MolTrain(**_cv_kwargs(os.path.join(work, "exp_nan"), epochs=1, debug_nans=True,
                                  target_anomaly_check="none", use_scaler=False,
                                  cache_dir_test=caches["val"])).fit(bad_csv, paths["val"])
        except FloatingPointError as e:
            raised = str(e)
    torch.cuda.synchronize()
    result = {"trace": os.path.relpath(path, REPO), "trace_bytes": os.path.getsize(path),
              "trace_kernel_names": len(kernels), "port_kernels_in_trace": found,
              "profiled_fit_wall_s": profiled_s, "debug_nans_raised": raised}
    print("cv: (c) " + json.dumps(result), flush=True)
    if not all(found.values()):
        raise Failed(f"cv profile: the trace lacks port kernels: {found}")
    if raised is None:
        raise Failed("cv debug_nans: a NaN target trained on without FloatingPointError")


def phase_cv(dev, graph_fit):
    """Cross-validation, resume, the profiler and the NaN check on the
    card, on phase fit's 400-molecule set.  Returns the launch counts of
    the CV fit."""
    import torch

    work = os.path.join(REPO, "build", "chip_smoke_cv")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = graph_fit["paths"]
    data = os.path.join(os.path.dirname(paths["train"]), "synthetic.csv")
    caches = {k: os.path.join(work, f"{k}.features.pkl") for k in ("all", "train", "val", "test")}
    t_phase = time.perf_counter()
    counts = _cv_fit_check(work, data, paths["test"], caches)
    _resume_check(work, paths, caches)
    _profile_and_nan_check(work, paths, caches)
    torch.cuda.empty_cache()
    print(f"cv: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# ---- synthetic pretrained checkpoints ------------------------------------------------

BPE_FIXTURE = os.path.join(REPO, "tests", "data", "chemberta_bpe")
BPE_FILES = ("vocab.json", "merges.txt", "tokenizer_config.json", "special_tokens_map.json")
# the pretraining heads a unicore Uni-Mol checkpoint carries beside the
# encoder, and RobertaForMaskedLM's lm_head: no port name, skipped
UNICORE_HEADS = ("lm_head.dense", "lm_head.layer_norm", "pair2coord_proj.linear1",
                 "pair2coord_proj.linear2", "dist_head.dense", "dist_head.out_proj")
SAFETENSORS_DTYPE = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16"}


def write_safetensors(path, tensors):
    """A safetensors file of ``tensors`` (name -> float tensor), written
    with the standard library: the little-endian header length, the JSON
    header (padded to 8 bytes) and the raw little-endian bytes."""
    import struct

    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": SAFETENSORS_DTYPE[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _draws(seed):
    """(normal(shape, std), uniform(shape, lo, hi)) drawing from one seeded
    CPU generator, fp32."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std=0.02, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    return normal, uniform


def write_unicore_checkpoint(path, seed, vocab, embed_dim=512, layers=15, heads=64, ffn=2048,
                             kernels=128):
    """A unicore Uni-Mol checkpoint (torch.save) from ``seed``: ``model``
    with ``unimat.``-prefixed fp32 tensors of the encoder (``layers``
    layers), gbf and gbf_proj for an atom vocabulary of ``vocab``, and the
    pretraining heads; ``args`` (an argparse.Namespace),
    ``optimizer_history`` and ``extra_state``.  Returns the model state
    dict as written."""
    import argparse

    import torch

    normal, uniform = _draws(seed)
    E, sd = embed_dim, {}

    def lin(name, din, dout):
        sd[f"{name}.weight"] = normal((dout, din))
        sd[f"{name}.bias"] = normal((dout,))

    def ln(name, d=E):
        sd[f"{name}.weight"] = normal((d,), 0.1, 1.0)
        sd[f"{name}.bias"] = normal((d,), 0.1)

    sd["embed_tokens.weight"] = normal((vocab, E))
    sd["gbf.means.weight"] = uniform((1, kernels), 0.0, 3.0)
    sd["gbf.stds.weight"] = uniform((1, kernels), 0.5, 3.0)
    sd["gbf.mul.weight"] = normal((vocab * vocab, 1), 0.1, 1.0)
    sd["gbf.bias.weight"] = normal((vocab * vocab, 1), 0.1)
    lin("gbf_proj.linear1", kernels, kernels)
    lin("gbf_proj.linear2", kernels, heads)
    ln("encoder.emb_layer_norm")
    ln("encoder.final_layer_norm")
    for i in range(layers):
        t = f"encoder.layers.{i}"
        lin(f"{t}.self_attn.in_proj", E, 3 * E)
        lin(f"{t}.self_attn.out_proj", E, E)
        ln(f"{t}.self_attn_layer_norm")
        ln(f"{t}.final_layer_norm")
        lin(f"{t}.fc1", E, ffn)
        lin(f"{t}.fc2", ffn, E)
    lin("lm_head.dense", E, E)
    ln("lm_head.layer_norm")
    lin("pair2coord_proj.linear1", heads, heads)
    lin("pair2coord_proj.linear2", heads, 1)
    lin("dist_head.dense", heads, heads)
    lin("dist_head.out_proj", heads, 1)
    torch.save({
        "model": {f"unimat.{k}": v for k, v in sd.items()},
        "args": argparse.Namespace(arch="unimol_base", encoder_layers=layers,
                                   encoder_embed_dim=E, encoder_attention_heads=heads,
                                   encoder_ffn_embed_dim=ffn, seed=seed, lr=[1e-4]),
        "optimizer_history": [{"criterion_name": "UniMolLoss", "optimizer_name": "FP16Optimizer",
                               "lr_scheduler_state": {"best": 0.5}, "num_updates": 1000}],
        "extra_state": {"train_iterator": {"epoch": 3, "iterations_in_epoch": 0},
                        "previous_training_time": 1234.5},
    }, path)
    return sd


def write_chemberta_dir(path, seed, hidden=512, layers=6, heads=8, intermediate=2048,
                        max_positions=515, dtype="bfloat16"):
    """An HF ChemBERTa (RobertaForMaskedLM) dir from ``seed``: config.json
    with these dims, the vocabulary of the BPE fixture and pad 1;
    model.safetensors in ``dtype`` with ``roberta.``-prefixed tensors and
    the lm_head's; the fixture's tokenizer files.  Returns the tensors as
    written."""
    import torch

    normal, _ = _draws(seed)
    with open(os.path.join(BPE_FIXTURE, "vocab.json"), encoding="utf-8") as f:
        vocab = len(json.load(f))
    E, sd = hidden, {}

    def lin(name, din, dout):
        sd[f"{name}.weight"] = normal((dout, din))
        sd[f"{name}.bias"] = normal((dout,))

    def ln(name):
        sd[f"{name}.weight"] = normal((E,), 0.1, 1.0)
        sd[f"{name}.bias"] = normal((E,), 0.1)

    r = "roberta"
    sd[f"{r}.embeddings.word_embeddings.weight"] = normal((vocab, E))
    sd[f"{r}.embeddings.position_embeddings.weight"] = normal((max_positions, E))
    sd[f"{r}.embeddings.token_type_embeddings.weight"] = normal((1, E))
    ln(f"{r}.embeddings.LayerNorm")
    for i in range(layers):
        t = f"{r}.encoder.layer.{i}"
        for part in ("self.query", "self.key", "self.value", "output.dense"):
            lin(f"{t}.attention.{part}", E, E)
        ln(f"{t}.attention.output.LayerNorm")
        lin(f"{t}.intermediate.dense", E, intermediate)
        lin(f"{t}.output.dense", intermediate, E)
        ln(f"{t}.output.LayerNorm")
    lin("lm_head.dense", E, E)
    ln("lm_head.layer_norm")
    sd["lm_head.bias"] = normal((vocab,))
    sd = {k: v.to(getattr(torch, dtype)) for k, v in sd.items()}
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    config = {"architectures": ["RobertaForMaskedLM"], "model_type": "roberta",
              "vocab_size": vocab, "hidden_size": E, "num_hidden_layers": layers,
              "num_attention_heads": heads, "intermediate_size": intermediate,
              "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
              "attention_probs_dropout_prob": 0.1, "max_position_embeddings": max_positions,
              "type_vocab_size": 1, "layer_norm_eps": 1e-12, "pad_token_id": 1,
              "bos_token_id": 0, "eos_token_id": 2, "torch_dtype": dtype}
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=1)
    for name in BPE_FILES:
        shutil.copy(os.path.join(BPE_FIXTURE, name), os.path.join(path, name))
    return sd


def unicore_port_name(key):
    """The port's state-dict name of a unicore Uni-Mol tensor name, or None
    for a pretraining head (the converter's map, restated here)."""
    import re

    if key.startswith(UNICORE_HEADS):
        return None
    if key.startswith("gbf.") and key.count(".") == 2:
        return key[: -len(".weight")]
    key = re.sub(r"^encoder\.layers\.(\d+)\.self_attn\.", r"encoder.layers_\1.", key)
    key = re.sub(r"^encoder\.layers\.(\d+)\.", r"encoder.layers_\1.", key)
    return re.sub(r"layer_norm\.(weight|bias)$", r"layer_norm.ln.\1", key)


def roberta_port_name(key):
    """The port's state-dict name of an HF RoBERTa tensor name, or None for
    the lm_head (the converter's map, restated here)."""
    import re

    if not key.startswith("roberta."):
        return None
    key = "bert." + key[len("roberta."):]
    for old, new in ((r"encoder\.layer\.(\d+)\.attention\.self\.(query|key|value)",
                      r"layer_\1.attn_\2"),
                     (r"encoder\.layer\.(\d+)\.attention\.output\.dense", r"layer_\1.attn_output"),
                     (r"encoder\.layer\.(\d+)\.attention\.output\.LayerNorm",
                      r"layer_\1.attn_LayerNorm"),
                     (r"encoder\.layer\.(\d+)\.intermediate\.dense", r"layer_\1.intermediate"),
                     (r"encoder\.layer\.(\d+)\.output\.dense", r"layer_\1.output"),
                     (r"encoder\.layer\.(\d+)\.output\.LayerNorm", r"layer_\1.output_LayerNorm")):
        key = re.sub(old, new, key)
    return key


# ---- phase pretrained ---------------------------------------------------------------

PRETRAINED_EPOCHS = 2
FROZEN_UNIMOL_LAYERS = 8   # the lower half of the flagship's 15 Uni-Mol layers
PRETRAINED_FREEZE = dict(
    freeze_layers=",".join(["embed_tokens.", "gbf.", "gbf_proj.", "encoder.emb_layer_norm."]
                           + [f"encoder.layers_{i}." for i in range(FROZEN_UNIMOL_LAYERS)]),
    freeze_module="bert")
SERVE_PREDICT_TOL = 2e-3


def _write_pretrained(work):
    """(a) Flagship-width synthetic checkpoints from seeds 0 and 1: a
    unicore Uni-Mol file with the dictionary beside it and a ChemBERTa dir
    in bf16 safetensors; the seconds to read and to convert each into a
    flagship state dict on the host, and the converters' counts.  Returns
    ({unimol_dir, chemberta_dir}, {port name: the file's tensor in fp32})."""
    import torch

    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.models.convert import (
        convert_hf_roberta,
        convert_unimol_checkpoint,
        hf_chemberta_overrides,
    )
    from mmdti_tpu_torch.models.hf_weights import read_hf_state_dict, read_unicore_checkpoint
    from mmdti_tpu_torch.models.mm_model import build_model

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    os.makedirs(os.path.join(work, "unimol"))
    shutil.copy(os.path.join(REPO, "mmdti_tpu_torch", "chem", "mol.dict.txt"),
                os.path.join(work, "unimol"))
    dirs = {"unimol_dir": os.path.join(work, "unimol", "unimol.pt"),
            "chemberta_dir": os.path.join(work, "chemberta")}
    t0 = time.perf_counter()
    unimol = write_unicore_checkpoint(dirs["unimol_dir"], 0, vocab=len(d))
    chemberta = write_chemberta_dir(dirs["chemberta_dir"], 1)
    write_s = time.perf_counter() - t0
    expected = {}
    for key, t in unimol.items():
        name = unicore_port_name(key)
        if name is not None:
            expected[name] = t.reshape(-1) if name in ("gbf.means", "gbf.stds") else t
    expected.update({roberta_port_name(k): t.float() for k, t in chemberta.items()
                     if roberta_port_name(k) is not None})

    model = build_model(1, len(d), d.pad(), 0, compute_dtype="bfloat16", use_kernels=True,
                        unimol_overrides={"pair_dtype": "bfloat16"},
                        chemberta_overrides=hf_chemberta_overrides(dirs["chemberta_dir"]))
    sd = dict(model.state_dict())
    stats = {"unimol": {}, "chemberta": {}}
    t0 = time.perf_counter()
    ckpt = read_unicore_checkpoint(dirs["unimol_dir"])
    t1 = time.perf_counter()
    convert_unimol_checkpoint(ckpt, sd, stats=stats["unimol"])
    t2 = time.perf_counter()
    hf = read_hf_state_dict(dirs["chemberta_dir"])
    t3 = time.perf_counter()
    convert_hf_roberta(hf, sd, stats=stats["chemberta"])
    t4 = time.perf_counter()
    counts = {k: {"loaded": v["loaded"], "missing": len(v["missing"]),
                  "shape_mismatched": len(v["shape"])} for k, v in stats.items()}
    mappable = {"unimol": sum(unicore_port_name(k) is not None for k in unimol),
                "chemberta": sum(roberta_port_name(k) is not None for k in chemberta)}
    landed = sum(torch.equal(sd[k], v) for k, v in expected.items())
    result = {
        "unimol_file_bytes": os.path.getsize(dirs["unimol_dir"]),
        "chemberta_file_bytes": os.path.getsize(os.path.join(dirs["chemberta_dir"],
                                                             "model.safetensors")),
        "chemberta_dtype": "bfloat16", "write_s": write_s,
        "unimol_read_s": t1 - t0, "unimol_convert_s": t2 - t1,
        "chemberta_read_s": t3 - t2, "chemberta_convert_s": t4 - t3,
        "counts": counts, "mappable": mappable,
        "pretraining_head_tensors_skipped": {"unimol": len(unimol) - mappable["unimol"],
                                             "chemberta": len(chemberta) - mappable["chemberta"]},
        "tensors_equal_to_the_files": landed, "tensors_expected": len(expected),
    }
    print("pretrained: (a) " + json.dumps(result), flush=True)
    for k, c in counts.items():
        if c != {"loaded": mappable[k], "missing": 0, "shape_mismatched": 0}:
            raise Failed(f"pretrained ingestion {k}: {c}, expected {mappable[k]} loaded")
    if landed != len(expected):
        raise Failed(f"pretrained ingestion: {landed} of {len(expected)} tensors equal the files")
    return dirs, expected


@contextlib.contextmanager
def _initial_weights():
    """Inside the block, each NNModel records its initial weights (after
    the pretrained ingestion) and the ingestion's counts."""
    from mmdti_tpu_torch.train import nnmodel

    seen = {}
    real_init, real_load = nnmodel.NNModel._init_params, nnmodel.load_pretrained

    def init(self, params):
        real_init(self, params)
        seen["state"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def load(sd, **dirs):
        return real_load(sd, stats=seen.setdefault("stats", {}), **dirs)

    nnmodel.NNModel._init_params, nnmodel.load_pretrained = init, load
    try:
        yield seen
    finally:
        nnmodel.NNModel._init_params, nnmodel.load_pretrained = real_init, real_load


def _ln_backward_sites(model, feats):
    """The LayerNorm kernel sites of one train forward whose backward
    autograd calls: those whose input or parameters require grad (a
    forward with hooks; its launches are not part of any counted run)."""
    import torch

    from mmdti_tpu_torch.models.layers import FusedLN
    from mmdti_tpu_torch.ops.hopper_ln import ln_kernel_enabled

    sites = []

    def hook(m, args):
        x = args[0]
        if ln_kernel_enabled(m.use_kernels, x.shape, x.device):
            sites.append(x.requires_grad or any(p.requires_grad for p in m.parameters()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, FusedLN)]
    try:
        with torch.enable_grad():
            model(**feats, outputs="train")
    finally:
        for h in handles:
            h.remove()
    return sum(sites), len(sites)


def _pretrained_fit(work, name, dirs, paths, caches, **freeze):
    """MolTrain.fit(train, val) with the defaults (the feed, K steps a CUDA
    graph) from the pretrained dirs, MMDTI_PALLAS_LN=1: the initial
    weights, the launch counts and routes, the train graph's step device
    ms and port kernels (profiler, one replay after the fit), the epoch
    seconds, and the LayerNorm backward sites of a step."""
    import torch

    from mmdti_tpu_torch import MolTrain

    exp = os.path.join(work, name)
    with _ln_kernels_on(), _initial_weights() as init:
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(**_cv_kwargs(exp, epochs=PRETRAINED_EPOCHS, cache_dir_train=caches["train"],
                                    cache_dir_test=caches["val"], **dirs, **freeze))
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, routes = _read_counts(), _read_routes()
        programs = clf.trainer._last_programs[2]
        ((key, graph),) = programs.graphs.items()
        k = key[1]
        resident = graph.pins[0]
        ln_bwd, ln_fwd = _ln_backward_sites(
            clf.model.model, resident.take(torch.arange(32, device=programs.device))[0])
        replay, replay_ms, _ = _replay_launches(graph.graph.replay)
    with open(os.path.join(exp, "history_0.json")) as f:
        history = json.load(f)
    model = clf.model.model
    out = {"exp": exp, "fit_s": fit_s, "counts": counts, "routes": routes, "k": k,
           "init": init["state"], "stats": init.get("stats", {}), "frozen": clf.model.frozen,
           "ln_sites": (ln_fwd, ln_bwd), "replay_launches": replay,
           "step_device_ms": replay_ms / k, "epoch_s": [r["seconds"] for r in history],
           "trainable_tensors": sum(p.requires_grad for p in model.parameters()),
           "per_forward": {"gbf_proj": 1, "pair_bias_attention": model.unimol_cfg.encoder_layers,
                           "masked_attention": model.bert.cfg.num_hidden_layers
                           + 2 * model.cross_modal_module.cfg.num_layers,
                           "layer_norm": _ln_sites(model)}}
    del clf, programs, graph, resident
    torch.cuda.empty_cache()
    return out


def _pretrained_expected(fit, per_step_bwd):
    """Launcher counts of a default fit: one train graph of k steps and one
    validation sweep graph, each warmed up and captured; a step launches
    ``per_step_bwd`` backwards."""
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    runs = GRAPH_WARMUP + 1
    want = {}
    for name, n in fit["per_forward"].items():
        want[name] = runs * (fit["k"] + 1) * n
        want[name + "_bwd"] = runs * fit["k"] * per_step_bwd[name + "_bwd"]
    return want


def _check_pretrained_fit(name, fit, expected, per_step_bwd):
    """The initial weights equal the files (fp32, bit for bit), the
    launcher counts what the reckoning gives, the routes, and one replay's
    port kernels k times a step's."""
    import torch

    init = fit["init"]
    landed = sum(torch.equal(init[k].cpu(), v) for k, v in expected.items())
    if landed != len(expected):
        raise Failed(f"pretrained {name}: {landed} of {len(expected)} initial tensors equal the "
                     "files")
    want = _pretrained_expected(fit, per_step_bwd)
    if fit["counts"] != want:
        raise Failed(f"pretrained {name}: the launchers counted {fit['counts']}, expected {want}")
    _check_mma_routes(fit["routes"], {k: n for k, n in fit["counts"].items()
                                      if k in fit["routes"]}, f"pretrained {name}")
    want_replay = {k: fit["k"] * (fit["per_forward"][k] if k in fit["per_forward"]
                                  else per_step_bwd[k]) for k in KERNELS}
    if fit["replay_launches"] != want_replay:
        raise Failed(f"pretrained {name}: one replay launched {fit['replay_launches']}, "
                     f"expected {want_replay}")


def _predict_and_serve(exp, paths, caches):
    """(d) MolPredict and MolServe(load_model=exp) on the test split: the
    BPE tokenizer from chemberta_dir, serve against predict, the kernel
    path against the plain path, graph replays against eager forwards."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolServe
    from mmdti_tpu_torch.data.reader import read_csv

    smiles = list(read_csv(paths["test"])["smiles"])
    with _ln_kernels_on():
        _reset_counts()
        pred = MolPredict(load_model=exp, cache_dir=caches["test"]).predict(paths["test"])
        torch.cuda.synchronize()
        counts = _read_counts()
        plain = MolPredict(load_model=exp, cache_dir=caches["test"])
        plain.config["use_pallas"] = False
        plain_pred = plain.predict(paths["test"])
        server = MolServe(exp)
        graph = np.asarray(server.predict(smiles)["predict"]).reshape(pred.shape)
        server.use_graphs = False
        e1 = np.asarray(server.predict(smiles)["predict"]).reshape(pred.shape)
        e2 = np.asarray(server.predict(smiles)["predict"]).reshape(pred.shape)
        tokenizer = type(server.tokenizer).__name__
        graphs = len(server.graphs)
    del server
    torch.cuda.empty_cache()
    return {"predict_launches": counts, "tokenizer": tokenizer, "serve_graphs": graphs,
            "rows": int(pred.shape[0]), "finite": bool(np.isfinite(pred).all()),
            "serve_vs_predict_max_abs": float(np.abs(graph - pred).max()),
            "serve_tol": SERVE_PREDICT_TOL,
            "kernel_vs_plain_max_abs": float(np.abs(plain_pred - pred).max()),
            "plain_tol": LOGITS_TOL, "graph_bit_equal_eager": bool(np.array_equal(graph, e1)),
            "graph_vs_eager_max_abs": float(np.abs(graph - e1).max()),
            "eager_vs_eager_max_abs": float(np.abs(e2 - e1).max())}


def phase_pretrained(dev, card, graph_fit):
    """Fine-tuning from pretrained checkpoints on the card, on phase fit's
    400-molecule set (its conformer caches from phase cv): (a) the
    synthetic flagship checkpoints and their ingestion; (b) a fit from them
    with nothing frozen; (c) the same fit with ChemBERTa and the lower half
    of the Uni-Mol stream frozen; (d) predict and serve that fit's dir.
    Returns the launch counts of the phase (both fits and the predict)."""
    import torch

    work = os.path.join(REPO, "build", "chip_smoke_pretrained")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = graph_fit["paths"]
    caches = {k: os.path.join(REPO, "build", "chip_smoke_cv", f"{k}.features.pkl")
              for k in ("train", "val", "test")}
    t_phase = time.perf_counter()
    dirs, expected = _write_pretrained(work)

    full = _pretrained_fit(work, "exp_pretrained", dirs, paths, caches)
    per_step_full = {k + "_bwd": n for k, n in full["per_forward"].items()}
    _check_pretrained_fit("fit", full, expected, per_step_full)

    frozen = _pretrained_fit(work, "exp_frozen", dirs, paths, caches, **PRETRAINED_FREEZE)
    ln_fwd, ln_bwd = frozen["ln_sites"]
    # a frozen step: no gbf backward, the pair-bias backward of the 7
    # trainable Uni-Mol layers only, the masked backward of the 2
    # cross-modal attentions only (ChemBERTa's 6 frozen), and the
    # LayerNorm backward of the sites autograd still reaches
    per_step_frozen = {"gbf_proj_bwd": 0, "pair_bias_attention_bwd": 15 - FROZEN_UNIMOL_LAYERS,
                       "masked_attention_bwd": 8 - 6, "layer_norm_bwd": ln_bwd}
    flagship = {"gbf_proj": 1, "pair_bias_attention": 15, "masked_attention": 8,
                "layer_norm": LN_SITES}
    if frozen["per_forward"] != flagship or full["per_forward"] != flagship or (
            ln_fwd != LN_SITES):
        raise Failed(f"pretrained: launches a forward {frozen['per_forward']}, {ln_fwd} "
                     f"LayerNorm sites hooked; expected {flagship}")
    _check_pretrained_fit("frozen fit", frozen, expected, per_step_frozen)

    from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint

    saved = flax_params_to_state_dict(load_checkpoint(frozen["exp"], 0)["params"])
    init = {k: v.cpu() for k, v in frozen["init"].items()}
    frozen_equal = sum(torch.equal(saved[k], expected[k]) and torch.equal(saved[k], init[k])
                       for k in frozen["frozen"])
    trainable = [k for k in saved if k not in frozen["frozen"]]
    moved = sum(not torch.equal(saved[k], init[k]) for k in trainable)
    served = _predict_and_serve(frozen["exp"], paths, caches)

    def summary(fit):
        return {"fit_wall_s": fit["fit_s"], "epoch_s": fit["epoch_s"], "k": fit["k"],
                "step_device_ms": fit["step_device_ms"], "launches": fit["counts"],
                "one_replay_launches": fit["replay_launches"],
                "trainable_tensors": fit["trainable_tensors"],
                "ingestion_loaded": {k: v["loaded"] for k, v in fit["stats"].items()}}

    result = {
        "card": card, "molecules": graph_fit["sizes"], "epochs": PRETRAINED_EPOCHS,
        "dispatch": "defaults: device_feed auto (engaged), steps_per_call 4, MMDTI_PALLAS_LN=1",
        "freeze": PRETRAINED_FREEZE, "frozen_tensors": len(frozen["frozen"]),
        "per_step_backward": {"unfrozen": per_step_full, "frozen": per_step_frozen},
        "layer_norm_sites": {"forward": ln_fwd, "backward_frozen": ln_bwd},
        "unfrozen": summary(full), "frozen": summary(frozen),
        "frozen_equal_to_file": frozen_equal, "trainable_moved": moved,
        "trainable": len(trainable), **served,
    }
    print("pretrained: (b)-(d) " + json.dumps(result), flush=True)
    if frozen_equal != len(frozen["frozen"]) or moved != len(trainable):
        raise Failed(f"pretrained: {frozen_equal} of {len(frozen['frozen'])} frozen tensors "
                     f"equal the files, {moved} of {len(trainable)} trainable ones moved")
    if served["tokenizer"] != "RobertaBPETokenizer" or not served["finite"]:
        raise Failed(f"pretrained predict: tokenizer {served['tokenizer']}, finite "
                     f"{served['finite']}")
    want_pred = _pretrained_expected({**frozen, "k": 0}, per_step_frozen)
    if served["predict_launches"] != want_pred:
        raise Failed(f"pretrained predict: the launchers counted {served['predict_launches']}, "
                     f"expected {want_pred}")
    if not (served["serve_vs_predict_max_abs"] <= SERVE_PREDICT_TOL
            and served["kernel_vs_plain_max_abs"] <= LOGITS_TOL):
        raise Failed(f"pretrained: serve vs predict {served['serve_vs_predict_max_abs']}, "
                     f"kernel vs plain {served['kernel_vs_plain_max_abs']}")
    if served["graph_vs_eager_max_abs"] > served["eager_vs_eager_max_abs"]:
        raise Failed(f"pretrained serve: graph replays differ from eager forwards by "
                     f"{served['graph_vs_eager_max_abs']}")
    torch.cuda.empty_cache()
    print(f"pretrained: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"fit": full["counts"], "frozen_fit": frozen["counts"],
            "predict": served["predict_launches"]}


# ---- phase mof ---------------------------------------------------------------------

MOF_CRYSTALS, MOF_EPOCHS, MOF_BATCH = 96, 2, 16
MOF_ATOMS = (150, 700)       # atoms a synthetic crystal holds: past 512 the reader crops
MOF_MAX_ATOMS = 512          # MOFReader's default crop
MOF_PAD = 528                # 512 + BOS + EOS, up to the fit's pad_multiple 16
MOF_SPLIT = (64, 16, 16)     # train, val, test rows
MOF_PLAIN_B = 4              # rows of the kernel-vs-plain step (the plain path's memory)
MOF_MODE_B = 2               # rows of the device-vs-host check on the fp32 plain path
MOF_SYMBOLS = ("Zn", "Cu", "O", "C", "H", "N")
MOF_WORK = os.path.join(REPO, "build", "chip_smoke_mof")


def write_mof_data(work, n=MOF_CRYSTALS, seed=0):
    """n synthetic crystals of MOF_ATOMS atoms (fractional sites, cells of
    20-30 Å), written as CIF files under ``work``, and train/val/test CSVs
    of MOF_SPLIT rows with the CIF paths relative to the CSVs, a gas of the
    reader's list, pressure (bar), temperature (K) and an uptake target
    that the gas, the pressure and the crystal's size set, with noise.
    The first crystal has MOF_ATOMS[1] atoms, so that the crop engages.
    Returns ({split: csv path}, [atoms of each crystal])."""
    import numpy as np

    from mmdti_tpu_torch.chem.mof import GAS2ATTR, GAS_LIST
    from mmdti_tpu_torch.data.reader import write_csv

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.RandomState(seed)
    rows = {"cif": [], "gas": [], "pressure": [], "temperature": [], "uptake": []}
    sizes = []
    for i in range(n):
        n_atoms = MOF_ATOMS[1] if i == 0 else int(rng.randint(MOF_ATOMS[0], MOF_ATOMS[1] + 1))
        sizes.append(n_atoms)
        a, b, c = 20.0 + rng.rand(3) * 10.0
        symbols = rng.choice(MOF_SYMBOLS, n_atoms)
        frac = rng.rand(n_atoms, 3)
        lines = [f"data_mof_{i}", f"_cell_length_a {a:.4f}", f"_cell_length_b {b:.4f}",
                 f"_cell_length_c {c:.4f}", "_cell_angle_alpha 90.0", "_cell_angle_beta 90.0",
                 "_cell_angle_gamma 90.0", "loop_", "_atom_site_label",
                 "_atom_site_type_symbol", "_atom_site_fract_x", "_atom_site_fract_y",
                 "_atom_site_fract_z"]
        lines += [f"{s}{j} {s} {x:.5f} {y:.5f} {z:.5f}"
                  for j, (s, (x, y, z)) in enumerate(zip(symbols, frac))]
        with open(os.path.join(work, f"mof_{i}.cif"), "w") as f:
            f.write("\n".join(lines) + "\n")
        gas = GAS_LIST[i % len(GAS_LIST)]
        pressure, temperature = float(rng.rand() * 10), float(273 + rng.rand() * 100)
        rows["cif"].append(f"mof_{i}.cif")
        rows["gas"].append(gas)
        rows["pressure"].append(pressure)
        rows["temperature"].append(temperature)
        rows["uptake"].append(float(2.0 + GAS2ATTR[gas][0] + 0.1 * pressure + n_atoms / 500
                                    + 0.1 * rng.randn()))
    paths, start = {}, 0
    for name, count in zip(("train", "val", "test"), MOF_SPLIT):
        paths[name] = os.path.join(work, f"{name}.csv")
        write_csv({k: np.asarray(v[start:start + count], dtype=object if k in ("cif", "gas")
                                 else np.float64) for k, v in rows.items()}, paths[name])
        start += count
    return paths, sizes


def _mof_graph_vs_eager(progs, res, idx):
    """K steps replayed from the fit's train graph against the same K steps
    run eagerly from the same state (optimizer buffers with the weights,
    metric sums, generator): bit for bit, as two eager runs are (the small
    tables' one-hot embedding backward, models/layers.py Embed, keeps the
    atom embedding's gradient in one order at 8,448 tokens).  Returns the
    gaps."""
    import torch

    opt, gen = progs.optimizer, progs.generator

    def state():
        return [t.clone() for t in (*opt.graph_state, progs.metric_sums)], gen.get_state()

    def restore(saved):
        with torch.no_grad():
            for t, v in zip((*opt.graph_state, progs.metric_sums), saved[0]):
                t.copy_(v)
        gen.set_state(saved[1])

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    s0 = state()
    m_e1 = torch.stack([progs.single(*res.take(idx[k])) for k in range(idx.shape[0])])
    after_e1 = state()
    restore(s0)
    m_e2 = torch.stack([progs.single(*res.take(idx[k])) for k in range(idx.shape[0])])
    after_e2 = state()
    restore(s0)
    m_g = progs.feed(res, idx)
    after_g = state()
    torch.cuda.synchronize()
    out = {"eager_vs_eager_max_abs": gap([*after_e1[0], m_e1], [*after_e2[0], m_e2]),
           "graph_vs_eager_max_abs": gap([*after_g[0], m_g], [*after_e1[0], m_e1]),
           "bit_equal": all(torch.equal(x, y) for x, y in
                            zip([*after_g[0], m_g], [*after_e1[0], m_e1])),
           "generator_state_equal": bool(torch.equal(after_g[1], after_e1[1]))}
    if not (out["generator_state_equal"] and out["bit_equal"]
            and out["eager_vs_eager_max_abs"] == 0.0):
        raise Failed(f"mof: replayed steps differ from eager ones: {out}")
    return out


def phase_mof(dev, card):
    """MolTrain(data_type='mof') -> MolPredict at the flagship width and
    depth on synthetic crystals of up to 700 atoms (cropped to 512, padded
    to N=528), B=16, bf16, device pair features ('auto'), MMDTI_PALLAS_LN=1;
    returns the fit's launch counts."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.chem.mof import MOFReader
    from mmdti_tpu_torch.data.reader import read_csv
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.models.mof import build_mof_model
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP, build_train_loss

    t_phase = time.perf_counter()
    paths, sizes = write_mof_data(MOF_WORK)
    reader = MOFReader()
    t0 = time.perf_counter()
    n_tokens = []
    for split in ("train", "val", "test"):
        table = read_csv(paths[split])
        for cif, gas in zip(table["cif"], table["gas"]):
            n_tokens.append(len(reader.read_with_gas(os.path.join(MOF_WORK, cif),
                                                     gas)["src_tokens"]))
    featurize_s = time.perf_counter() - t0
    exp = os.path.join(MOF_WORK, "exp")
    with _ln_kernels_on():
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        clf = MolTrain(task="regression", data_type="mof", epochs=MOF_EPOCHS,
                       batch_size=MOF_BATCH, learning_rate=1e-4, early_stopping=20,
                       metrics="mse", target_cols=["uptake"], save_path=exp, seed=42,
                       device="cuda")
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak_fit = torch.cuda.max_memory_allocated(dev)
        fit_counts, fit_routes = _read_counts(), _read_routes()
        nn, trainer = clf.model, clf.trainer
        model = nn.model
        sites = _ln_sites(model)
        per_fwd = {"gbf_proj": 1, "pair_bias_attention": model.unimol_cfg.encoder_layers,
                   "masked_attention": 0, "layer_norm": sites}
        per_step = {**per_fwd, **{k + "_bwd": n for k, n in per_fwd.items()}}
        n_train = len(nn.features_train)
        steps = n_train // MOF_BATCH
        k_feed = _snap_to_divisor(GRAPH_K, steps)
        # one train graph (warm-ups and capture of k_feed steps) and one
        # validation sweep graph: nothing else launches
        want_fit = {k: n * (GRAPH_WARMUP + 1) * (k_feed + (0 if k.endswith("_bwd") else 1))
                    for k, n in per_step.items()}
        with open(os.path.join(exp, "history_0.json")) as f:
            history = json.load(f)
        resident = _resident_bytes(clf)
        info = {"crystals": MOF_CRYSTALS, "atoms": [min(sizes), max(sizes)],
                "cropped_crystals": sum(n > MOF_MAX_ATOMS for n in sizes),
                "featurization_s": featurize_s, "tokens_max": max(n_tokens),
                "pad_N": nn.atom_pad, "pair_feats": nn.collator.pair_feats,
                "layers": model.unimol_cfg.encoder_layers, "E": model.unimol_cfg.embed_dim,
                "H": model.unimol_cfg.attention_heads, "K": model.unimol_cfg.gaussian_kernels,
                "B": MOF_BATCH, "steps_per_epoch": steps, "steps_per_replay": k_feed,
                "fit_wall_s": fit_s, "epoch_wall_s": [r["seconds"] for r in history],
                "history": history, "peak_allocated_bytes_fit": peak_fit,
                "resident_bytes": resident, "fit_launches": fit_counts,
                "fit_launches_expected": want_fit, "card": card}
        print("mof: fit " + json.dumps(info), flush=True)
        if nn.atom_pad != MOF_PAD or nn.collator.pair_feats != "device":
            raise Failed(f"mof: pad N {nn.atom_pad} (expected {MOF_PAD}), pair features "
                         f"{nn.collator.pair_feats} (expected device)")
        if fit_counts != want_fit:
            raise Failed(f"mof: the fit launched {fit_counts}, expected {want_fit}")
        _check_mma_routes(fit_routes, {k: want_fit[k] for k in fit_routes}, "mof fit")

        # MolPredict on the test crystals: one sweep graph's forwards
        _reset_counts()
        pred = np.asarray(MolPredict(load_model=exp).predict(paths["test"]))
        pred_counts = _read_counts()
        want_pred = {k: 0 if k.endswith("_bwd") else n * (GRAPH_WARMUP + 1)
                     for k, n in per_step.items()}
        if pred.shape != (MOF_SPLIT[2], 1) or not np.isfinite(pred).all():
            raise Failed(f"mof: MolPredict gave {pred!r}")
        if pred_counts != want_pred:
            raise Failed(f"mof: MolPredict launched {pred_counts}, expected {want_pred}")

        # a step eager and replayed: launches, device ms; replay against eager
        progs = trainer._last_programs[2]
        res = trainer._slots["train"]
        rng = np.random.RandomState(1)
        idx = torch.from_numpy(np.stack([rng.permutation(n_train)[:MOF_BATCH]
                                         for _ in range(k_feed)])).to(dev)
        eager_launch, eager_ms, eager_kernels = _replay_launches(
            lambda: progs.single(*res.take(idx[0])))
        replay_launch, replay_ms, replay_kernels = _replay_launches(
            lambda: progs.feed(res, idx))
        marked = {k: per_step[k] for k in KERNEL_MARKERS}
        replay_check = _mof_graph_vs_eager(progs, res, idx)
        step_info = {"eager_step_launches": eager_launch,
                     "replay_launches_per_step": {k: n / k_feed for k, n in
                                                  replay_launch.items()},
                     "launches_per_step_reckoned": marked, "eager_step_device_ms": eager_ms,
                     "replay_device_ms_per_step": replay_ms / k_feed,
                     "eager_step_device_kernels": eager_kernels,
                     "replay_device_kernels_per_step": replay_kernels / k_feed,
                     "replay_vs_eager": replay_check, "card": card}
        print("mof: steps " + json.dumps(step_info), flush=True)
        if eager_launch != marked or replay_launch != {k: n * k_feed for k, n in
                                                       marked.items()}:
            raise Failed(f"mof: a step launched {eager_launch} eagerly and {replay_launch} in "
                         f"a {k_feed}-step replay; reckoned {marked} a step")

        # one batch kept for the path checks, in both pair modes
        rows = [(nn.features_train[i], np.asarray(nn.data_train["target"][i]))
                for i in range(MOF_PLAIN_B)]
        batch_dev, y = nn.collator(rows)
        nn.collator.pair_feats = "host"
        batch_host, _ = nn.collator(rows[:MOF_MODE_B])
        nn.collator.pair_feats = "device"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        cfg = dict(output_dim=1, atom_vocab_size=len(nn.dictionary),
                   atom_pad_idx=nn.dictionary.pad(), task="regression")
    del clf, nn, trainer, model, progs, res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # kernel path against plain path, one MOF batch of MOF_PLAIN_B rows, bf16
    def build(compute_dtype, use_kernels, pair_dtype):
        m = build_mof_model(**cfg, compute_dtype=compute_dtype, use_kernels=use_kernels,
                            unimol_overrides={"pair_dtype": pair_dtype})
        m.load_state_dict(state)
        return m.to(dev)

    def on_card(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()
                if k != "weights"}

    feats = on_card(batch_dev)
    labels = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    weights = torch.ones(MOF_PLAIN_B, 1, device=dev)
    kernel_model = build("bfloat16", True, "bfloat16")
    plain = build("bfloat16", False, "bfloat16")
    torch.cuda.reset_peak_memory_stats(dev)
    _compare_paths(kernel_model, plain, build_train_loss(zoo.mse_loss, "regression"), feats,
                   labels, weights, {k: n for k, n in per_step.items()
                                     if not k.startswith("layer_norm")}, what="mof")
    peak_compare = torch.cuda.max_memory_allocated(dev)
    del kernel_model, plain
    torch.cuda.empty_cache()

    # device against host pair features, plain fp32 path, MOF_MODE_B rows
    fp32 = build("float32", False, "float32")
    with torch.no_grad():
        sub = {k: v[:MOF_MODE_B] for k, v in feats.items()}
        got = fp32(**sub, outputs="logits")["logits"]
        want = fp32(**on_card(batch_host), outputs="logits")["logits"]
    mode_diff = float((got - want).abs().max())
    del fp32
    torch.cuda.empty_cache()
    print("mof: " + json.dumps({
        "check": "device vs host pair features, plain fp32 path", "B": MOF_MODE_B,
        "N": int(feats["src_tokens"].shape[1]), "logits_max_abs_diff": mode_diff,
        "tol": PAIR_MODE_TOL, "peak_allocated_bytes_kernel_vs_plain": peak_compare,
        "predict_rows": int(pred.shape[0]), "phase_s": time.perf_counter() - t_phase,
        "card": card}), flush=True)
    if not mode_diff <= PAIR_MODE_TOL:
        raise Failed(f"mof: device pair features differ from host ones by {mode_diff}")
    return fit_counts


# ---- phase conformers ---------------------------------------------------------

CONF_UNITS = ("c1ccc(cc1)", "c1ccc(nc1)", "C1CCN(CC1)", "C1CCC(CC1)", "C(=O)N", "CC", "OCC",
              "C(C)(C)", "S(=O)(=O)", "N(C)", "C(F)(F)", "C(O)", "c1ccc(s1)", "C(=O)O")
CONF_STARTS = ("C", "F", "Cl", "CO", "N", "FC(F)(F)", "N#C", "O")
CONF_ENDS = ("C", "F", "Cl", "OC", "N", "C(F)(F)F", "C#N", "O")
# atoms with hydrogens of each atom bucket's molecules: buckets 64, 128, 192, 256
CONF_RANGES = ((48, 64), (65, 128), (129, 192), (193, 200))
CONF_PER_BUCKET = 64         # 256 molecules; a group of 64 a bucket
CONF_FIT_PER_BUCKET = 50     # (d): the first 50 of each bucket, 200 molecules
CONF_FIT = (128, 72)         # (d): train and validation rows of the fit
CONF_FIT_EPOCHS = 2
CONF_SERVE_ROUNDS = 5        # (e): cold requests each way, alternated
CONF_DIST_TOL = 0.15         # device against host float64 distances (tests/test_device_refine.py)
CONF_ENERGY_RATIO = 1.10     # device energy at most this times the host's (same test)
CONF_BATCH_TOL = 1e-5        # a molecule alone against co-batched (BATCH_COMPOSITION_ATOL)
CONF_NATIVE_TOL = 1e-4       # native refinement against numpy _refine (tests/test_chem.py)
CONF_SERVE_TOL = 2e-2        # device- against host-provider answers (bf16 flagship)
CONF_MANY_PER_BUCKET = 500   # (d): 2,000 molecules featurized for the device memory they hold
CONF_BUSY_S = 1.0            # (e): seconds of a sleep kernel on the default stream
CONF_WORK = os.path.join(REPO, "build", "chip_smoke_conformers")


def drug_smiles(per_bucket=None, seed=0):
    """Drug-sized SMILES from a seed: a start, ring and chain units drawn by
    numpy.random.default_rng(seed) until the molecule reaches an atom count
    drawn in its bucket's range (CONF_RANGES), an end; per_bucket
    (CONF_PER_BUCKET) molecules in each range, in bucket order.  Each unit's atoms (hydrogens with it)
    add up, since a unit bonds to its neighbours in place of two
    hydrogens; the native parse confirms every count."""
    import numpy as np

    from mmdti_tpu_torch.chem import native

    def atoms(smi):
        return len(native.parse_graph(smi)[0])

    per_bucket = CONF_PER_BUCKET if per_bucket is None else per_bucket
    rng = np.random.default_rng(seed)
    unit_atoms = [atoms("C" + u + "C") - atoms("CC") for u in CONF_UNITS]
    out = []
    for lo, hi in CONF_RANGES:
        got = 0
        while got < per_bucket:
            target = int(rng.integers(lo, hi + 1))
            start = CONF_STARTS[rng.integers(len(CONF_STARTS))]
            end = CONF_ENDS[rng.integers(len(CONF_ENDS))]
            smi, n = start, atoms(start + end)
            while n < target:
                k = int(rng.integers(len(CONF_UNITS)))
                smi, n = smi + CONF_UNITS[k], n + unit_atoms[k]
            smi += end
            if lo <= n <= hi:
                if atoms(smi) != n:
                    raise Failed(f"conformers: {smi} has {atoms(smi)} atoms, counted {n}")
                out.append(smi)
                got += 1
    return out


def _conf_group(smis, dev):
    """One bucket's molecules as the device refinement's input tensors on
    dev (DeviceConformerBatcher's padding) and their _prepare tuples."""
    import torch

    from mmdti_tpu_torch.chem import device_conformer as dc

    items = [(i, dc._prepare(s, 42)) for i, s in enumerate(smis)]
    bucket = dc._atom_bucket(max(len(it[0]) for _, it in items))
    arrays = dc.DeviceConformerBatcher(device=dev).group_arrays(bucket, items)
    return [torch.from_numpy(a).to(dev) for a in arrays], items


def _conf_energy(coords, item):
    """The refinement's energy (ops/device_refine.py refine_energy) of one
    molecule's [n, 3] coordinates under its own terms, on the host."""
    import torch

    from mmdti_tpu_torch.ops.device_refine import refine_energy

    n = len(item[0])
    return float(refine_energy(torch.from_numpy(coords[None]), torch.ones(1, n),
                               *[torch.from_numpy(a[None]) for a in item[2:]])[0])


def _pool_bytes(dev, pool):
    """Bytes of device memory the caching allocator holds in one graph
    memory pool (segments of the allocator's snapshot with its id); None
    where no segment carries the id."""
    import torch

    sizes = [seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
             if seg.get("device", dev.index) == dev.index
             and tuple(seg["segment_pool_id"]) == tuple(pool)]
    return sum(sizes) if sizes else None


def _median_s(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_conformers(dev, card, build):
    """Conformer generation on the card and native host chemistry, on 256
    drug-sized molecules (48-200 atoms with hydrogens, 64 in each of the
    atom buckets 64, 128, 192, 256; drug_smiles, seed 0): (a) the native
    library's build and its refinement against numpy; (b) the device
    provider against the host one; (c) the cost a molecule by bucket,
    alone and in groups of 64; (d) MolTrain.fit with coord_provider 'auto'
    on 200 of them; (e) cold MolServe requests.  Returns the launch counts
    of (d) and (e)."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolServe, MolTrain
    from mmdti_tpu_torch.chem import device_conformer as dc
    from mmdti_tpu_torch.chem.conformer import (
        ConformerGen,
        _build_terms,
        _initial_coords,
        _refine,
        builtin_smi2coords,
    )
    from mmdti_tpu_torch.chem.smiles import parse_smiles
    from mmdti_tpu_torch.configs.config import load_yaml, save_yaml
    from mmdti_tpu_torch.data.reader import write_csv
    from mmdti_tpu_torch.ops import device_refine as dr
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    t_phase = time.perf_counter()
    shutil.rmtree(CONF_WORK, ignore_errors=True)
    os.makedirs(CONF_WORK)
    smis = drug_smiles()
    prepared = [dc._prepare(s, 42) for s in smis]
    n_atoms = [len(item[0]) for item in prepared]
    buckets = [dc._atom_bucket(n) for n in n_atoms]

    # (a) the native library: its build, and its refinement against numpy
    native_errs, native_ms = [], []
    for b in (0, 1, 2):
        smi = smis[b * CONF_PER_BUCKET]
        mol = parse_smiles(smi).add_hydrogens()
        coords0 = _initial_coords(mol.num_atoms(), 42)
        want = _refine(coords0.copy(), _build_terms(mol))
        got = builtin_smi2coords(smi, seed=42)[1]
        native_errs.append(float(np.abs(got - want).max()))
    for b in range(4):
        group = smis[b * CONF_PER_BUCKET:(b + 1) * CONF_PER_BUCKET][:8]
        native_ms.append(_median_s(lambda: [builtin_smi2coords(s) for s in group], 3)
                         / len(group) * 1e3)
    print("conformers: (a) " + json.dumps({
        "molecules": len(smis), "atoms": [min(n_atoms), max(n_atoms)],
        "per_bucket": {str(b): buckets.count(b) for b in sorted(set(buckets))},
        "native_build_s": build["native_s"], "native_library": build["native_path"],
        "native_vs_numpy_max_abs_err": native_errs, "tol": CONF_NATIVE_TOL,
        "host_native_ms_per_molecule_by_bucket": dict(zip(("64", "128", "192", "256"),
                                                          native_ms)),
        "card": card}), flush=True)
    if not max(native_errs) <= CONF_NATIVE_TOL:
        raise Failed(f"conformers: native refinement differs from numpy by {native_errs}")

    # (b) device provider against host provider, all 256
    torch.cuda.synchronize()
    graphs_before = len(dr.GRAPHS)
    device_cold, device_cold_s = _timed(
        lambda: dc.device_smi2coords_batch(smis, min_atoms=0, device=dev))
    device_warm, device_warm_s = _timed(
        lambda: dc.device_smi2coords_batch(smis, min_atoms=0, device=dev))
    host, host_s = _timed(lambda: [builtin_smi2coords(s, seed=42) for s in smis])
    repeat_equal = all(np.array_equal(a[1], b[1]) for a, b in zip(device_cold, device_warm))
    dist_err, ratios = 0.0, []
    for smi, item, (atoms_d, cd), (atoms_h, ch) in zip(smis, prepared, device_warm, host):
        if atoms_d != atoms_h:
            raise Failed(f"conformers: device and host atoms differ for {smi}")
        dd = np.sqrt(((cd[:, None] - cd[None]) ** 2).sum(-1))
        dh = np.sqrt(((ch[:, None] - ch[None]) ** 2).sum(-1))
        dist_err = max(dist_err, float(np.abs(dd - dh).max()))
        ratios.append((_conf_energy(cd, item), _conf_energy(ch, item)))
    worst_ratio = max(e_d / e_h for e_d, e_h in ratios)
    energy_ok = all(e_d <= e_h * CONF_ENERGY_RATIO + 1e-3 for e_d, e_h in ratios)
    # one molecule alone against its group of 64
    lone_i = CONF_PER_BUCKET   # the first molecule of bucket 128
    alone = dc.device_smi2coords_batch([smis[lone_i]], min_atoms=0, device=dev)[0][1]
    alone_err = float(np.abs(alone - device_warm[lone_i][1]).max())
    # one group (bucket 128, 64 molecules): graph replay against eager
    inputs, _ = _conf_group(smis[CONF_PER_BUCKET:2 * CONF_PER_BUCKET], dev)
    eager = [dr.refine_conformers(*inputs, use_graph=False) for _ in range(2)]
    replay = [dr.refine_conformers(*inputs) for _ in range(2)]
    eager_gap = float((eager[0] - eager[1]).abs().max())
    graph_err = float((replay[0] - eager[0]).abs().max())
    ev_eager = _kernel_events(lambda: dr.refine_conformers(*inputs, use_graph=False), 1)
    ev_graph = _kernel_events(lambda: dr.refine_conformers(*inputs), 1)
    group_eager_s = _median_s(lambda: (dr.refine_conformers(*inputs, use_graph=False),
                                       torch.cuda.synchronize()), 3)
    group_graph_s = _median_s(lambda: (dr.refine_conformers(*inputs),
                                       torch.cuda.synchronize()), 5)
    info = {
        "device_cold_s": device_cold_s, "device_warm_s": device_warm_s, "host_s": host_s,
        "device_mols_per_s": len(smis) / device_warm_s, "host_mols_per_s": len(smis) / host_s,
        "graphs_recorded": len(dr.GRAPHS) - graphs_before,
        "distance_max_abs_err": dist_err, "distance_tol": CONF_DIST_TOL,
        "energy_ratio_max": worst_ratio, "energy_ratio_limit": CONF_ENERGY_RATIO,
        "repeat_calls_bit_equal": repeat_equal,
        "alone_vs_cobatched_max_abs_err": alone_err, "alone_tol": CONF_BATCH_TOL,
        "graph_vs_eager_max_abs_err": graph_err, "eager_vs_eager_max_abs_err": eager_gap,
        "replays_bit_equal": bool(torch.equal(replay[0], replay[1])),
        "group": {"M": int(inputs[0].shape[0]), "Np": int(inputs[0].shape[1]),
                  "iters": 300,
                  "eager_kernels": sum(c for c, _ in ev_eager.values()),
                  "eager_device_ms": sum(us for _, us in ev_eager.values()) / 1e3,
                  "replay_kernels": sum(c for c, _ in ev_graph.values()),
                  "replay_device_ms": sum(us for _, us in ev_graph.values()) / 1e3,
                  "host_launches_eager": sum(c for c, _ in ev_eager.values()),
                  "host_launches_replay": 1,
                  "eager_wall_ms": group_eager_s * 1e3, "replay_wall_ms": group_graph_s * 1e3},
        "card": card}
    print("conformers: (b) " + json.dumps(info), flush=True)
    if not (repeat_equal and info["replays_bit_equal"]):
        raise Failed("conformers: repeated device refinements differ")
    if not dist_err <= CONF_DIST_TOL or not energy_ok:
        raise Failed(f"conformers: device vs host distances {dist_err}, energy ratio "
                     f"{worst_ratio}")
    if not alone_err <= CONF_BATCH_TOL:
        raise Failed(f"conformers: a molecule alone differs from co-batched by {alone_err}")
    if not graph_err <= eager_gap:
        raise Failed(f"conformers: graph replay differs from eager by {graph_err} (two eager "
                     f"runs: {eager_gap})")

    # (c) the cost a molecule by atom bucket: host native against device,
    # a lone molecule and groups of 64 (the device's graphs recorded above)
    by_bucket = {}
    for b, bucket in enumerate((64, 128, 192, 256)):
        group = smis[b * CONF_PER_BUCKET:(b + 1) * CONF_PER_BUCKET]
        dc.device_smi2coords_batch(group[:1], min_atoms=0, device=dev)   # record M=8
        lone = _median_s(lambda: dc.device_smi2coords_batch(group[:1], min_atoms=0,
                                                             device=dev), 5)
        grouped = _median_s(lambda: dc.device_smi2coords_batch(group, min_atoms=0,
                                                                device=dev), 3)
        host_one = native_ms[b] / 1e3
        by_bucket[str(bucket)] = {"host_native_ms": host_one * 1e3,
                                  "device_lone_ms": lone * 1e3,
                                  "device_group64_ms_per_molecule": grouped / len(group) * 1e3,
                                  "device_group64_wall_ms": grouped * 1e3}
    print("conformers: (c) " + json.dumps({"ms_per_molecule": by_bucket, "card": card}),
          flush=True)

    # (d) the device memory a fit's featurization holds: 2,000 molecules in
    # groups of at most GROUP_MAX, the shapes (b) recorded; the [N, N] pair
    # arrays left out (the card's device pair mode builds them)
    many = drug_smiles(per_bucket=CONF_MANY_PER_BUCKET, seed=2)
    torch.cuda.synchronize()
    graphs_before = len(dr.GRAPHS)
    allocated_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    many_feats, many_s = _timed(
        lambda: ConformerGen(device=dev, pair_feats=False).transform(many))
    torch.cuda.synchronize()
    largest_m = max(key[1] for key in dr.GRAPHS)
    memory = {"molecules": len(many), "featurize_s": many_s,
              "molecules_per_s": len(many) / many_s,
              "graphs_recorded": len(dr.GRAPHS) - graphs_before, "graphs": len(dr.GRAPHS),
              "largest_group": largest_m,
              "peak_allocated_above_start_bytes":
                  torch.cuda.max_memory_allocated(dev) - allocated_before,
              "graph_pool_bytes": _pool_bytes(dev, dr._POOLS[dev]),
              "reserved_bytes": torch.cuda.memory_reserved(dev), "card": card}
    print("conformers: (d) memory " + json.dumps(memory), flush=True)
    if largest_m > dc.GROUP_MAX or len(many_feats) != len(many):
        raise Failed(f"conformers: a group of {largest_m} molecules recorded, "
                     f"{len(many_feats)} of {len(many)} featurized")
    del many_feats

    # (d) MolTrain.fit, coord_provider 'auto' (the card: device), 200 molecules
    fit_smis = [smis[b * CONF_PER_BUCKET + i] for i in range(CONF_FIT_PER_BUCKET)
                for b in range(4)]
    rng = np.random.default_rng(0)
    y = np.array([len(s) / 50.0 for s in fit_smis]) + rng.normal(0, 0.1, len(fit_smis))
    paths = {}
    for name, rows in (("train", slice(0, CONF_FIT[0])), ("val", slice(CONF_FIT[0], None))):
        paths[name] = os.path.join(CONF_WORK, f"{name}.csv")
        write_csv({"smiles": fit_smis[rows], "y": y[rows]}, paths[name])
    feat_dev_s = _timed(lambda: ConformerGen(device=dev).transform(fit_smis))[1]
    feat_host_s = _timed(lambda: ConformerGen(coord_provider="host").transform(fit_smis))[1]
    exp = os.path.join(CONF_WORK, "exp")
    fit_kw = dict(task="regression", epochs=CONF_FIT_EPOCHS, learning_rate=1e-4, batch_size=32,
                  early_stopping=20, metrics="mse", smiles_col="smiles", target_cols=["y"],
                  seed=42, device="cuda")
    with _ln_kernels_on():
        _reset_counts()
        clf, fit_s = _timed(lambda: MolTrain(save_path=exp, **fit_kw).fit(paths["train"],
                                                                          paths["val"]))
        torch.cuda.synchronize()
        fit_counts = _read_counts()
        nn = clf.model
        model = nn.model
        sites = _ln_sites(model)
        per_fwd = {"gbf_proj": 1, "pair_bias_attention": model.unimol_cfg.encoder_layers,
                   "masked_attention": model.bert.cfg.num_hidden_layers
                   + 2 * model.cross_modal_module.cfg.num_layers, "layer_norm": sites}
        steps = len(nn.features_train) // 32
        k_feed = _snap_to_divisor(GRAPH_K, steps)
        # the train graph's warm-ups and capture take every backward launch
        want_bwd = {k + "_bwd": n * (GRAPH_WARMUP + 1) * k_feed for k, n in per_fwd.items()}
        with open(os.path.join(exp, "history_0.json")) as f:
            history = json.load(f)
        host_exp = os.path.join(CONF_WORK, "exp_host_branch")
        host_fit, host_fit_s = _timed(lambda: MolTrain(
            save_path=host_exp, device_feed=False, **fit_kw).fit(paths["train"], paths["val"]))
        with open(os.path.join(host_exp, "history_0.json")) as f:
            host_history = json.load(f)
    info = {"molecules": len(fit_smis), "split": list(CONF_FIT),
            "featurize_device_provider_s": feat_dev_s, "featurize_host_provider_s": feat_host_s,
            "resolved_provider": ConformerGen(device=dev).resolved_provider(),
            "pad_N": nn.atom_pad, "steps_per_epoch": steps, "steps_per_replay": k_feed,
            "fit_wall_s": fit_s, "epoch_wall_s": [r["seconds"] for r in history],
            "fit_launches": fit_counts, "backward_launches_expected": want_bwd,
            "host_branch_fit_wall_s": host_fit_s,
            "host_branch_epoch_wall_s": [r["seconds"] for r in host_history],
            "host_branch_val_mse": [r["val_mse"] for r in host_history],
            "val_mse": [r["val_mse"] for r in history], "card": card}
    print("conformers: (d) " + json.dumps(info), flush=True)
    if info["resolved_provider"] != "device" or nn.atom_pad < 128:
        raise Failed(f"conformers: provider {info['resolved_provider']}, pad N {nn.atom_pad}")
    if any(fit_counts[k] != n for k, n in want_bwd.items()) or not all(fit_counts.values()):
        raise Failed(f"conformers: the fit launched {fit_counts}, backwards expected "
                     f"{want_bwd}")
    if not all(np.isfinite(r["val_mse"]) for r in history + host_history):
        raise Failed("conformers: a fit's validation loss is not finite")

    # (e) cold MolServe requests: 8 unseen molecules, feature cache off,
    # device provider against host provider (a copy of the dir whose
    # config names coord_provider 'host'), alternated
    host_dir = os.path.join(CONF_WORK, "exp_host_provider")
    shutil.copytree(exp, host_dir)
    cfg = load_yaml(os.path.join(host_dir, "config.yaml"))
    cfg["coord_provider"] = "host"
    save_yaml(cfg, os.path.join(host_dir, "config.yaml"))
    unseen = drug_smiles(per_bucket=2, seed=1)
    if set(unseen) & set(smis):
        raise Failed("conformers: a cold request's molecule is in the fit's set")
    with _ln_kernels_on():
        servers = {"device": MolServe(exp, feature_cache=0),
                   "host": MolServe(host_dir, feature_cache=0)}
        answers = {k: srv.predict(unseen)["predict"] for k, srv in servers.items()}   # record
        times = {k: [] for k in servers}
        for _ in range(CONF_SERVE_ROUNDS):
            for k, srv in servers.items():
                t0 = time.perf_counter()
                srv.predict(unseen)
                times[k].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    launches = _read_counts()
    # a cold featurization while the default stream is busy (as it is with
    # the forward of the request before): the refinement's copies, replays
    # and pull run on its own stream and do not wait for the sleep
    conformer = servers["device"].conformer
    want = conformer.transform(unseen)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(CONF_BUSY_S * _sm_clock_hz()))
    beside_busy, beside_busy_s = _timed(lambda: conformer.transform(unseen))
    busy_after = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize()
    beside_equal = all(np.array_equal(a["src_coord"], b["src_coord"])
                       for a, b in zip(beside_busy, want))
    serve_diff = float(np.abs(answers["device"] - answers["host"]).max())
    print("conformers: (e) " + json.dumps({
        "molecules": len(unseen), "providers": {k: s.conformer.resolved_provider()
                                                for k, s in servers.items()},
        "p50_ms": {k: statistics.median(v) * 1e3 for k, v in times.items()},
        "answers_max_abs_diff": serve_diff, "tol": CONF_SERVE_TOL,
        "featurize_beside_busy_stream_ms": beside_busy_s * 1e3,
        "busy_stream_sleep_s": CONF_BUSY_S, "default_stream_busy_after": busy_after,
        "beside_busy_bit_equal": beside_equal,
        "phase_launches": launches, "phase_s": time.perf_counter() - t_phase,
        "card": card}), flush=True)
    if not (busy_after and beside_equal):
        raise Failed(f"conformers: a featurization beside a busy default stream waited for "
                     f"it ({beside_busy_s} s) or differs (bit-equal: {beside_equal})")
    if [s.conformer.resolved_provider() for s in servers.values()] != ["device", "host"]:
        raise Failed("conformers: the servers did not take the device and host providers")
    if not serve_diff <= CONF_SERVE_TOL:
        raise Failed(f"conformers: device- and host-provider answers differ by {serve_diff}")
    del servers, clf, host_fit
    torch.cuda.empty_cache()
    return launches


DP_WORK = os.path.join(REPO, "build", "chip_smoke_dp")
# phase dp (b): two ranks against one process, no dropout, bf16: each rank
# runs its GEMMs over 16 rows instead of 32 and the ranks' gradients sum in
# another order, so the fits part by rounding; the kernel-vs-plain
# tolerance of the flagship logits bounds it
DP_PRED_TOL = LOGITS_TOL
DP_FIT_EPOCHS = 2        # (b): the two ranks step eagerly (gloo), so fewer epochs
DP_COLLECTIVES_PER_STEP = 5   # gathers of logits|pooled and of InfoNCE, their backwards, the mean
NO_DROPOUT = dict(
    unimol_overrides={"dropout": 0.0, "emb_dropout": 0.0, "attention_dropout": 0.0,
                      "pooler_dropout": 0.0},
    chemberta_overrides={"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    crossmodal_overrides={"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _no_infonce_dropout():
    """InfoNCE's query dropout (0.1, no config knob) off inside the block."""
    import functools

    import mmdti_tpu_torch.models.mm_model as mm

    real = mm.InfoNCE
    mm.InfoNCE = functools.partial(real, embed_dropout=0.0)
    try:
        yield
    finally:
        mm.InfoNCE = real


def _audit_writes(root):
    """Every path under ``root`` this process opens to write, as it happens
    (an audit hook; it stays for the process's life)."""
    writes = []

    def hook(event, args):
        if event == "open" and isinstance(args[0], str) and args[0].startswith(root):
            mode, flags = args[1] or "", args[2] or 0
            if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
                writes.append(os.path.relpath(args[0], root))

    sys.addaudithook(hook)
    return writes


def _fit_predictions(fit, paths):
    """(cv_pred, test predictions, model_0.ckpt bytes) of a _run_fit."""
    import numpy as np

    from mmdti_tpu_torch import MolPredict

    exp = fit["clf"].save_path
    with _ln_kernels_on():
        test = MolPredict(load_model=exp).predict(paths["test"])
    with open(os.path.join(exp, "model_0.ckpt"), "rb") as f:
        ckpt = f.read()
    return np.asarray(fit["clf"].cv_pred), np.asarray(test), ckpt


def _step_replay(fit, k):
    """One replay of a fit's train graph: the port kernels it launches,
    device ms and kernels a step, {kernel name: launches} of one replay
    and the collectives the graph recorded."""
    import torch

    trainer = fit["clf"].trainer
    programs = trainer._last_programs[2]
    res = trainer._slots["train"]
    idx = torch.arange(k * 32, device=res.labels.device).view(k, 32)
    (prog,) = programs.graphs.values()

    def step():
        programs.feed(res, idx)

    with _ln_kernels_on():      # the fit's graph: recorded with the LayerNorm kernels on
        launches, ms, kernels = _replay_launches(step)
        names = {name: c for name, (c, _) in _kernel_events(step, 1).items()}
    if len(programs.graphs) != 1:
        raise Failed(f"dp: the replay recorded another train graph ({len(programs.graphs)})")
    return {"port_kernels_one_replay": launches, "device_ms_per_step": ms / k,
            "kernels_per_step": kernels / k, "collectives_recorded": prog.collectives}, names


def dp_worker(rank, port, spec_path):
    """One rank of phase dp (b): a gloo group of two processes on the one
    card, the flagship fit without dropout, its launches and what it
    wrote; then dropout on: the pair-bias attention kernel on rows that
    are the same on both ranks, each rank's keep mask from its own
    generator.  Writes its findings to the spec's ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from mmdti_tpu_torch.models.layers import draw_seed
    from mmdti_tpu_torch.ops.hopper_attention import keep_mask_for, pair_bias_attention_cuda
    from mmdti_tpu_torch.parallel.mesh import DataGroup, initialize_distributed, rank_seed

    with open(spec_path) as f:
        spec = json.load(f)
    writes = _audit_writes(spec["exp"])
    dev = initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    group = DataGroup()
    t0 = time.perf_counter()
    with _no_infonce_dropout():
        fit = _run_fit(spec["paths"], spec["exp"], epochs=DP_FIT_EPOCHS, **NO_DROPOUT)
    fit_s = time.perf_counter() - t0
    out = {"rank": rank, "device": str(dev), "backend": group.backend, "fit_s": fit_s,
           "launches": fit["counts"], "routes": fit["routes"],
           "batch_size": fit["clf"].trainer.batch_size,
           "train_graphs": len(fit["clf"].trainer._last_programs[2].graphs),
           "history": fit["history"], "cv_pred": np.asarray(fit["clf"].cv_pred).tolist()}
    # dropout on: rows that are the same on both ranks, each rank's seed
    gen = torch.Generator(device=dev).manual_seed(rank_seed(42, rank))
    seed = draw_seed(gen, DROPOUT)
    g = torch.Generator(device=dev).manual_seed(0)
    B, N, H, D = 2, 64, 64, 8
    q, k, v = (torch.randn(1, N, H * D, generator=g, device=dev, dtype=torch.bfloat16)
               .expand(B, N, H * D).contiguous() for _ in range(3))
    bias = torch.zeros(B, H, N, N, device=dev, dtype=torch.bfloat16)
    attn, _, _ = pair_bias_attention_cuda(q, k, v, bias, H, seed=seed, dropout_rate=DROPOUT)
    mask = keep_mask_for(seed, DROPOUT, B, H, N, N, dev)
    outs = group.gather_rows(attn.float().unsqueeze(0))        # [rank, B, N, H*D]
    masks = group.gather_rows(mask.to(torch.uint8).unsqueeze(0))
    out["dropout"] = {
        "seed": int(seed.item()),
        "keep_fraction": float(mask.float().mean()),
        "outputs_differ_across_ranks": not torch.equal(outs[0], outs[1]),
        "masks_differ_across_ranks": not torch.equal(masks[0], masks[1]),
        "rows_differ_within_rank": not torch.equal(mask[0], mask[1]),
    }
    out["writes"] = sorted(set(writes))
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_dp(dev, card, graph_fit):
    """Data parallelism: (a) a one-rank NCCL group against no group on the
    flagship fit of phase 7's set (the feed, K steps a CUDA graph,
    MMDTI_PALLAS_LN=1, dropout on): the collectives each train graph
    records, device ms a step each way, bit-equal weights, history and
    predictions; (b) two ranks over gloo on the one card, eager steps, no
    dropout, against one process (DP_PRED_TOL), every kernel launched on
    each rank, only rank 0 writing, and with dropout on each rank's own
    attention masks; (c) MolServe(mesh_shape=(1, 1)) bit-equal to
    MolServe() on phase serve's dir, and (2, 1) refused on one card.
    Returns each run's launch counts."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.parallel.mesh import initialize_distributed
    from mmdti_tpu_torch.train.fit_loop import _snap_to_divisor

    t_phase = time.perf_counter()
    paths, sizes = graph_fit["paths"], graph_fit["sizes"]
    shutil.rmtree(DP_WORK, ignore_errors=True)
    os.makedirs(DP_WORK)
    k = _snap_to_divisor(GRAPH_K, sizes["train"] // 32)

    # (a) no group, then a one-rank NCCL group, the same fit
    ref = _run_fit(paths, os.path.join(DP_WORK, "exp_ref"))
    ref_out = _fit_predictions(ref, paths)
    ref_step, ref_names = _step_replay(ref, k)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        grp = _run_fit(paths, os.path.join(DP_WORK, "exp_nccl"))
        grp_out = _fit_predictions(grp, paths)
        grp_step, grp_names = _step_replay(grp, k)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    # what the group adds to one replay: NCCL's kernels, the packing copies
    added = {name: c - ref_names.get(name, 0) for name, c in grp_names.items()
             if c != ref_names.get(name, 0)}
    same = {"cv_pred": bool(np.array_equal(ref_out[0], grp_out[0])),
            "test_pred": bool(np.array_equal(ref_out[1], grp_out[1])),
            "model_0_ckpt_bytes": ref_out[2] == grp_out[2],
            "history": _without_times(ref["history"]) == _without_times(grp["history"])}
    print("dp: (a) " + json.dumps({
        "backend": backend, "world_size": 1, "steps_per_graph": k,
        "collectives_per_train_graph": grp_step["collectives_recorded"],
        "collectives_expected": DP_COLLECTIVES_PER_STEP * k,
        "no_group": ref_step, "nccl_group": grp_step, "kernels_the_group_adds": added,
        "device_ms_per_step_cost_of_the_group": grp_step["device_ms_per_step"]
        - ref_step["device_ms_per_step"],
        "bit_equal": same, "fit_wall_s": {"no_group": ref["fit_s"], "nccl_group": grp["fit_s"]},
        "launches_nccl_fit": grp["counts"], "card": card}), flush=True)
    if grp_step["collectives_recorded"] != DP_COLLECTIVES_PER_STEP * k:
        raise Failed(f"dp (a): a train graph recorded {grp_step['collectives_recorded']} "
                     f"collectives, expected {DP_COLLECTIVES_PER_STEP * k}")
    if not all(same.values()):
        raise Failed(f"dp (a): the one-rank NCCL fit differs from the fit without a group: {same}")

    # (b) two ranks over gloo on the one card, no dropout, against one process
    with _no_infonce_dropout():
        one = _run_fit(paths, os.path.join(DP_WORK, "exp_one"), epochs=DP_FIT_EPOCHS,
                       **NO_DROPOUT)
    one_pred, one_hist = np.asarray(one["clf"].cv_pred), one["history"]
    del one
    spec = {"paths": paths, "exp": os.path.join(DP_WORK, "exp_two"),
            "out": os.path.join(DP_WORK, "rank{rank}.json")}
    spec_path = os.path.join(DP_WORK, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               "--dp-port", str(port), "--dp-spec", spec_path],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise Failed(f"dp (b): rank {r} exited {p.returncode}:\n{log[-4000:]}")
    ranks = []
    for r in range(2):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    preds = [np.asarray(x["cv_pred"]) for x in ranks]
    diff = float(np.abs(preds[0] - one_pred).max())
    print("dp: (b) " + json.dumps({
        "backend": ranks[0]["backend"], "world_size": 2, "devices": [x["device"] for x in ranks],
        "global_batch": ranks[0]["batch_size"], "rows_a_rank": ranks[0]["batch_size"] // 2,
        "epochs": DP_FIT_EPOCHS, "dropout": "off", "both_ranks_s": two_s,
        "fit_s": [x["fit_s"] for x in ranks],
        "train_graphs_recorded": [x["train_graphs"] for x in ranks],
        "launches": {f"rank{x['rank']}": x["launches"] for x in ranks},
        "ranks_bit_equal": bool(np.array_equal(preds[0], preds[1])),
        "vs_one_process_max_abs": diff, "tol": DP_PRED_TOL,
        "epoch_wall_s": {f"rank{x['rank']}": [h["seconds"] for h in x["history"]]
                         for x in ranks},
        "one_process_epoch_wall_s": [h["seconds"] for h in one_hist],
        "val_mse": {"two_ranks": [h["val_mse"] for h in ranks[0]["history"]],
                    "one_process": [h["val_mse"] for h in one_hist]},
        "writes": {f"rank{x['rank']}": x["writes"] for x in ranks},
        "dropout_on": {f"rank{x['rank']}": x["dropout"] for x in ranks}, "card": card}),
        flush=True)
    for x in ranks:
        for name, n in x["launches"].items():
            if n == 0:
                raise Failed(f"dp (b): rank {x['rank']} did not launch {name}")
        _check_mma_routes(x["routes"], {k: x["launches"][k] for k in x["routes"]},
                          f"dp (b) rank {x['rank']}")
        if x["train_graphs"]:
            raise Failed(f"dp (b): rank {x['rank']} recorded a train graph under gloo")
    if not np.array_equal(preds[0], preds[1]):
        raise Failed("dp (b): the two ranks predict differently")
    if not diff <= DP_PRED_TOL:
        raise Failed(f"dp (b): two ranks differ from one process by {diff} > {DP_PRED_TOL}")
    if ranks[1]["writes"] or "model_0.ckpt.tmp" not in ranks[0]["writes"]:
        raise Failed(f"dp (b): the writes break the single-writer rule: "
                     f"{[x['writes'] for x in ranks]}")
    drop = [x["dropout"] for x in ranks]
    if not (drop[0]["outputs_differ_across_ranks"] and drop[0]["masks_differ_across_ranks"]
            and drop[0]["seed"] != drop[1]["seed"]):
        raise Failed(f"dp (b): the ranks drew correlated dropout: {drop}")

    # (c) serving: a one-replica mesh is the server without one
    plain = MolServe(SERVE_DIR, device=dev)
    meshed = MolServe(SERVE_DIR, device=dev, mesh_shape=(1, 1))
    equal = {}
    for n in REQUESTS:
        for srv in (plain, meshed):
            srv.predict(SMILES_20[:n])          # record, then replay
        a, b = plain.predict(SMILES_20[:n]), meshed.predict(SMILES_20[:n])
        equal[n] = bool(np.array_equal(a["predict"], b["predict"]))
    try:
        MolServe(SERVE_DIR, device=dev, mesh_shape=(2, 1))
        refused = None
    except ValueError as e:
        refused = str(e)
    print("dp: (c) " + json.dumps({
        "mesh": meshed.mesh.shape, "buckets": list(meshed.batch_buckets),
        "graphs": len(meshed.graphs), "bit_equal_by_request": equal,
        "mesh_2_1_refused": refused, "phase_s": time.perf_counter() - t_phase,
        "card": card}), flush=True)
    if not all(equal.values()):
        raise Failed(f"dp (c): MolServe(mesh_shape=(1, 1)) differs from MolServe(): {equal}")
    if refused is None or f"only {torch.cuda.device_count()} available" not in refused:
        raise Failed(f"dp (c): mesh_shape=(2, 1) on one card was not refused: {refused}")
    del plain, meshed
    torch.cuda.empty_cache()
    return {"w1_nccl": grp["counts"], "w2_rank0": ranks[0]["launches"],
            "w2_rank1": ranks[1]["launches"]}


def _without_times(history):
    return [{k: v for k, v in row.items() if k not in ("seconds", "val_seconds")}
            for row in history]


# ---- phase scalers: the target_normalize modes through fit, predict and serve ------------

SCALER_WORK = os.path.join(REPO, "build", "chip_smoke_scalers")
# (name, target_normalize, how the train targets are moved first)
SCALER_FITS = (("minmax", "minmax", None), ("maxabs", "maxabs", None),
               ("quantile", "quantile", None), ("box-cox", "power_trans", "positive"),
               ("yeo-johnson", "power_trans", "centered"), ("log1p", "log1p", "positive"))
SCALER_ROUND_TRIP_TOL = 1e-9   # inverse_transform(transform(y)) against y
SCALER_EPOCHS = 1


def _scaler_csvs(paths, work):
    """Phase fit's splits with their targets moved: "positive" (the least
    target of any split at 0.5, for Box-Cox and log1p), "centered" (the
    train median at 0: both signs, Yeo-Johnson), and "multilabel":
    measured and a second column, each with NaN holes.  Returns {kind:
    {split: path}}."""
    import numpy as np

    from mmdti_tpu_torch.data.reader import read_csv, write_csv

    y = {k: np.asarray(read_csv(p)["measured"], np.float64) for k, p in paths.items()}
    shift = {"positive": 0.5 - min(v.min() for v in y.values()),
             "centered": -float(np.median(y["train"]))}
    out = {None: paths}
    for kind in ("positive", "centered", "multilabel"):
        out[kind] = {}
        for split, path in paths.items():
            table = read_csv(path)
            y = np.asarray(table["measured"], np.float64)
            if kind == "multilabel":
                rows = np.arange(len(y))
                t1 = np.where(rows % 5 == 1, np.nan, y)
                t2 = np.where(rows % 7 == 3, np.nan, 0.5 * y ** 2 - 1.0)
                table = {"smiles": table["smiles"], "t1": t1, "t2": t2}
            else:
                table = dict(table, measured=y + shift[kind])
            out[kind][split] = os.path.join(work, f"{kind}_{split}.csv")
            write_csv(table, out[kind][split])
    return out


def _scaler_fit(name, mode, paths, caches, task="regression"):
    """MolTrain.fit(train, val) with ``target_normalize=mode`` at the
    flagship width and depth, bf16, the card's defaults (the resident
    feed, CUDA graphs), SCALER_EPOCHS epoch, MMDTI_PALLAS_LN=1; then
    MolPredict and MolServe over its dir.  Returns what phase scalers
    checks and prints."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolServe, MolTrain
    from mmdti_tpu_torch.data.reader import read_csv
    from mmdti_tpu_torch.data.scaler import TargetScaler

    exp = os.path.join(SCALER_WORK, f"exp_{name}")
    target_cols = ["t1", "t2"] if task == "multilabel_regression" else ["measured"]
    with _ln_kernels_on():
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(task=task, epochs=SCALER_EPOCHS, learning_rate=1e-4, batch_size=32,
                       early_stopping=20, metrics="mae", smiles_col="smiles", save_path=exp,
                       target_cols=target_cols, using_infonce=True, using_ct=True,
                       target_normalize=mode, seed=42, cache_dir_train=caches["train"],
                       cache_dir_test=caches["val"], device="cuda")
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, routes = _read_counts(), _read_routes()
        val_pred = np.asarray(MolPredict(load_model=exp, cache_dir=caches["val"]).predict(
            paths["val"]), np.float64)
        server = MolServe(exp)
        served = np.asarray(server.predict(list(read_csv(paths["val"])["smiles"]))["predict"],
                            np.float64).reshape(val_pred.shape)
        del server
    torch.cuda.empty_cache()
    scaler = clf.data_train["target_scaler"]
    # the targets as the fit took them: the rows its reader kept (3-sigma
    # anomaly filter), read as float32
    y = np.asarray(clf.data_train["raw_target"], np.float32).reshape(
        -1, len(target_cols)).astype(np.float64)
    round_trip = scaler.inverse_transform(scaler.transform(y))
    reread = TargetScaler(mode, task, exp)
    probe = np.concatenate([y, y[:8] * 0.5 + 0.25])
    probe = np.where(np.isnan(probe), 1.0, probe)
    t_fit, t_read = scaler.transform(probe), reread.transform(probe)
    return {"clf": clf, "fit_s": fit_s, "counts": counts, "routes": routes,
            "classes": [type(o).__name__[1:] for o in scaler.scaler],
            "method": getattr(scaler.scaler[0], "method", None),
            "predict_vs_fit_max_abs": float(np.abs(val_pred - clf.cv_pred).max()),
            # the model's outputs (the scaled space) and the targets' units
            "serve_vs_predict_scaled_max_abs": float(np.abs(
                scaler.transform(served) - scaler.transform(val_pred)).max()),
            "serve_vs_predict_max_abs": float(np.abs(served - val_pred).max()),
            "round_trip_max_abs": float(np.nanmax(np.abs(round_trip - y))),
            "artifact_transform_equal": bool(np.array_equal(t_fit, t_read)),
            "artifact_inverse_equal": bool(np.array_equal(scaler.inverse_transform(t_fit),
                                                          reread.inverse_transform(t_fit))),
            "val_pred_finite": bool(np.isfinite(val_pred).all()),
            "val_pred_range": [float(val_pred.min()), float(val_pred.max())]}


def phase_scalers(dev, card, graph_fit):
    """The target_normalize modes the other phases' fits do not run
    (minmax, maxabs, quantile, power_trans as Box-Cox and as Yeo-Johnson,
    log1p; normalizer has no inverse, so no fit of it finishes), each
    through a short flagship fit of phase fit's data (and quantile through
    a multilabel_regression fit over NaN-masked columns): MolPredict from
    the dir reproduces the fit's predictions exactly (phase fit's check),
    MolServe over the dir agrees with MolPredict within SERVE_PREDICT_TOL
    on the model's scaled outputs (so the inverse runs on the serving path
    too), inverse_transform(transform(y)) is within SCALER_ROUND_TRIP_TOL of
    the train targets, the artifact read back gives the same numbers, and
    the fit launched all eight kernels (attention and gbf on "mma").
    Returns the launches summed over the fits."""
    import torch

    os.makedirs(SCALER_WORK, exist_ok=True)
    csvs = _scaler_csvs(graph_fit["paths"], SCALER_WORK)
    caches = {s: os.path.join(SCALER_WORK, f"conformers_{s}.pkl") for s in ("train", "val")}
    runs = [(name, mode, csvs[kind], "regression") for name, mode, kind in SCALER_FITS]
    runs.append(("multilabel-quantile", "quantile", csvs["multilabel"], "multilabel_regression"))
    total = {k: 0 for k in KERNELS}
    t_phase = time.perf_counter()
    for name, mode, paths, task in runs:
        r = _scaler_fit(name, mode, paths, caches, task)
        info = {k: v for k, v in r.items() if k not in ("clf", "routes")}
        info.update(task=task, target_normalize=mode,
                    routes={k: v for k, v in r["routes"].items() if sum(v.values())},
                    serve_tol=SERVE_PREDICT_TOL, round_trip_tol=SCALER_ROUND_TRIP_TOL)
        print(f"scalers: {name} " + json.dumps(info), flush=True)
        if r["predict_vs_fit_max_abs"] != 0.0:
            raise Failed(f"scalers {name}: MolPredict differs from the fit's predictions by "
                         f"{r['predict_vs_fit_max_abs']}")
        if not r["serve_vs_predict_scaled_max_abs"] <= SERVE_PREDICT_TOL:
            raise Failed(f"scalers {name}: MolServe differs from MolPredict by "
                         f"{r['serve_vs_predict_scaled_max_abs']} (scaled)")
        if not r["round_trip_max_abs"] <= SCALER_ROUND_TRIP_TOL:
            raise Failed(f"scalers {name}: the round trip is off by {r['round_trip_max_abs']}")
        if not (r["artifact_transform_equal"] and r["artifact_inverse_equal"]):
            raise Failed(f"scalers {name}: target_scaler.ss read back gives other numbers")
        if not r["val_pred_finite"]:
            raise Failed(f"scalers {name}: predictions not finite")
        if name == "box-cox" and r["method"] != "box-cox" or \
                name == "yeo-johnson" and r["method"] != "yeo-johnson":
            raise Failed(f"scalers {name}: the fit chose {r['method']}")
        missing = [k for k in KERNELS if r["counts"][k] == 0]
        if missing:
            raise Failed(f"scalers {name}: {missing} were not launched in the fit")
        _check_mma_routes(r["routes"], {k: r["counts"][k] for k in r["routes"]},
                          f"scalers {name}")
        total = _add_counts(total, r["counts"])
        del r
        torch.cuda.empty_cache()
    print(f"scalers: {len(runs)} fits, predicts and serves in "
          f"{time.perf_counter() - t_phase:.1f} s; launches " + json.dumps(total) + f" ({card})",
          flush=True)
    return total


# ---- phase remat: the encoder recomputed in the backward -----------------------------------

REMAT_B, REMAT_N, REMAT_L = 32, 280, 64
REMAT_MOF_B, REMAT_MOF_N = 16, 528
# (e): the shapes of PERF.md §4 the auto rule is asked about
REMAT_RULE_SHAPES = tuple((b, n) for n in (64, 280) for b in (32, 64, 128, 256))


def _set_remat(model, on):
    """Rematerialize ``model``'s Uni-Mol encoder or not (its config is frozen:
    a replaced copy with ``remat``)."""
    import dataclasses

    model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=on)


def _saved_bytes(model, fn):
    """Bytes autograd saves for the backward while ``fn()`` runs a forward
    (each storage once, parameters left out), by where the tensor was
    saved: "layer" (inside a Uni-Mol layer, summed over the layers) or
    "other", and by kind: "pair" (a tensor whose last two dims are N x N)
    or "token": {where: {kind: bytes}}.  The forward's graph dies before it
    returns; one left alive would keep the parameters' gradient
    accumulators, made on this stream, and a later CUDA graph capture
    would wait on it."""
    import torch

    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    where, seen = ["other"], {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params and s.data_ptr() not in seen:
            pair = t.dim() >= 3 and t.shape[-1] == t.shape[-2] > 1
            seen[s.data_ptr()] = (where[-1], "pair" if pair else "token", s.nbytes())
        # not t itself: a node saving its own output would hold it, and
        # through it itself, in a cycle the collector cannot see
        return t.detach()

    def enter(*args):
        where.append("layer")

    def leave(*args):
        where.pop()

    layers = [m for name, m in model.encoder.named_children() if name.startswith("layers_")]
    hooks = [m.register_forward_pre_hook(enter) for m in layers]
    hooks += [m.register_forward_hook(leave) for m in layers]
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
    finally:
        for h in hooks:
            h.remove()
    total = {w: {"pair": 0, "token": 0} for w in ("layer", "other")}
    for w, kind, n in seen.values():
        total[w][kind] += n
    return total


def _step_peak(dev, fn):
    """(peak bytes allocated while fn() runs, fn's result), synchronized."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev), out


def _mof_batch(dev, B, N, seed=0):
    """A MOF batch of B crystals of N-2 atoms (BOS, atoms, EOS) in device
    pair mode: random tokens, coordinates in a 12 A box, gas and
    environment."""
    import torch

    from mmdti_tpu_torch.chem.dictionary import Dictionary

    d = Dictionary.load()
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(4, len(d), (B, N), generator=g)
    tok[:, 0], tok[:, -1] = d.bos(), d.eos()
    feats = {"src_tokens": tok.int(), "src_coord": torch.rand(B, N, 3, generator=g) * 12.0,
             "gas_id": torch.randint(0, 4, (B,), generator=g),
             "gas_attr": torch.rand(B, 6, generator=g), "pressure": torch.rand(B, generator=g),
             "temperature": torch.rand(B, generator=g)}
    return {k: v.to(dev) for k, v in feats.items()}


def _mof_flagship():
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.models.mof import build_mof_model

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    return build_mof_model(1, len(d), d.pad(), "regression", compute_dtype="bfloat16",
                           unimol_overrides={"pair_dtype": "bfloat16"})


def remat_peaks(dev, model, feats, labels, weights, gen, base):
    """One eager train step (loss, gradients, FusedAdam) of ``model`` on
    ``feats`` with remat off and on, dropout on: {"off"|"on": peak bytes
    allocated}, the bytes the model and optimizer hold before it, each
    above ``base`` (what was allocated before the model was built, so a
    process's earlier tensors stay out), and the bytes the forward saves
    (_saved_bytes, remat off)."""
    import torch

    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_loss, build_train_step

    opt = FusedAdam(dict(model.named_parameters()), 1e-4, 100)
    step = build_train_step(model, opt, zoo.mse_loss, "regression")
    _set_remat(model, False)
    saved = _saved_bytes(model, lambda: build_train_loss(zoo.mse_loss, "regression")(
        model, feats, labels, weights, gen))
    torch.cuda.empty_cache()
    peaks = {}
    for way in ("off", "on"):
        _set_remat(model, way == "on")
        step(feats, labels, weights, gen)       # cuBLAS workspaces, kernel caches
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev) - base
        peak, _ = _step_peak(dev, lambda: step(feats, labels, weights, gen))
        peaks[way] = peak - base
    _set_remat(model, False)
    del opt, step
    torch.cuda.empty_cache()
    return {"peak": peaks, "resident": resident, "saved": saved}


def phase_remat(dev, card):
    """Encoder remat (models/unimol.py; train/nnmodel.py's rule) at the
    flagship Uni-Mol shape B=32, N=280 (L=64), bf16, dropout on,
    MMDTI_PALLAS_LN=1: (a) one eager step with remat off and on: loss,
    every gradient and the generator's state after it bit-equal, the
    launches of each; (b) GRAPH_K steps replayed from one CUDA graph with
    remat on, bit-equal to GRAPH_K eager steps with remat on; (c) the
    peak allocated by one eager step with remat off and on, here and at
    the MOF step (B=16, N=528), each beside train/nnmodel.py's predicted
    peak (LayerNorm kernels off, as the model was fitted); (d)
    device ms and launches a step replayed, remat off and on (pair-bias
    forward 15 -> 30, the Uni-Mol layers' LayerNorm forwards again in the
    backward); (e) the auto rule's decision at the shapes of
    PERF.md §4 with its predicted peaks.  Returns the launches of (a)."""
    import dataclasses

    import numpy as np
    import torch

    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train import nnmodel
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP, TrainPrograms, build_train_loss

    t_phase = time.perf_counter()
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    B, N, L, K = REMAT_B, REMAT_N, REMAT_L, GRAPH_K
    out = {"card": card, "total_memory": total_memory}
    with _ln_kernels_on():
        # (c) memory first, before any graph holds a pool: flagship, then MOF,
        # with the LayerNorm kernels off (MMDTI_PALLAS_LN=0), as the memory
        # model was fitted
        _set_ln("off")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model = _flagship(True)
        model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
        model.to(dev)
        res = _graph_resident(dev, N, L, B)
        feats, labels, weights = res.feats, res.labels, res.weights
        gen = torch.Generator(device=dev).manual_seed(7)
        ucfg = model.unimol_cfg
        mem = {"flagship": remat_peaks(dev, model, feats, labels, weights, gen, base)}
        mem["flagship"]["predicted"] = {
            way: nnmodel.predicted_step_bytes(B, N, L, ucfg, remat=way == "on")
            for way in ("off", "on")}
        torch.cuda.synchronize()
        mof_base = torch.cuda.memory_allocated(dev)
        mof = _mof_flagship()
        mof.reset_parameters_like_flax(torch.Generator().manual_seed(0))
        mof.to(dev)
        mb = _mof_batch(dev, REMAT_MOF_B, REMAT_MOF_N)
        mem["mof"] = remat_peaks(dev, mof, mb, labels[:REMAT_MOF_B], weights[:REMAT_MOF_B],
                                 gen, mof_base)
        mem["mof"]["predicted"] = {
            way: nnmodel.predicted_step_bytes(REMAT_MOF_B, REMAT_MOF_N, 0, mof.unimol_cfg,
                                              remat=way == "on") for way in ("off", "on")}
        del mof, mb
        torch.cuda.empty_cache()
        out["c_memory"] = mem
        print("remat: (c) LayerNorm kernels off " + json.dumps(mem) + f" ({card})", flush=True)
        _set_ln("on")

        # (a) one eager step off and on from one generator state
        train_loss = build_train_loss(zoo.mse_loss, "regression")
        params = [p for p in model.parameters()]
        n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
        sites = _ln_sites(model)
        layer_sites = 2 * ucfg.encoder_layers       # the two LayerNorms of every layer
        gen0 = gen.get_state()

        def eager_step(way):
            """One step's loss, gradients, generator state and launches; the
            step's graph dies here (a graph left alive keeps the gradient
            accumulators made on this stream, and (b)'s capture would
            wait on it)."""
            _set_remat(model, way == "on")
            gen.set_state(gen0)
            _reset_counts()
            total, _ = train_loss(model, feats, labels, weights, gen)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            torch.cuda.synchronize()
            return {"loss": total.detach().clone(), "grads": grads,
                    "generator": gen.get_state(), "counts": _read_counts()}

        steps = {way: eager_step(way) for way in ("off", "on")}
        per_step = {way: {**_attention_launches(ucfg.encoder_layers, n_masked),
                          "layer_norm": sites, "layer_norm_bwd": sites}
                    for way in ("off", "on")}
        per_step["on"]["pair_bias_attention"] *= 2
        per_step["on"]["layer_norm"] += layer_sites
        loss_equal = torch.equal(steps["off"]["loss"], steps["on"]["loss"])
        grads_equal = all((a is None and b is None) or torch.equal(a, b)
                          for a, b in zip(steps["off"]["grads"], steps["on"]["grads"]))
        gen_equal = torch.equal(steps["off"]["generator"], steps["on"]["generator"])
        moved = not torch.equal(steps["off"]["generator"], gen0)
        out["a_eager"] = {"loss": float(steps["off"]["loss"]), "loss_bit_equal": loss_equal,
                          "grads_bit_equal": grads_equal, "grads": len(params),
                          "generator_state_equal": gen_equal, "generator_moved": moved,
                          "launches": {w: steps[w]["counts"] for w in steps},
                          "launches_expected": per_step}
        print("remat: (a) " + json.dumps(out["a_eager"]), flush=True)
        if not (loss_equal and grads_equal and gen_equal and moved):
            raise Failed(f"remat (a): remat on differs from off: loss {loss_equal}, gradients "
                         f"{grads_equal}, generator {gen_equal} (moved {moved})")
        for way in steps:
            got = {k: steps[way]["counts"][k] for k in per_step[way]}
            if got != per_step[way]:
                raise Failed(f"remat (a) {way}: launched {got}, expected {per_step[way]}")
        launches = steps["on"]["counts"]
        del steps
        torch.cuda.empty_cache()

        # (b) K replayed steps with remat on against K eager ones; (d) a
        # replayed step's device ms and launches, remat off and on
        rng = np.random.RandomState(0)
        idx = torch.from_numpy(np.stack([rng.permutation(B) for _ in range(K)])).to(dev)
        opt = FusedAdam(dict(model.named_parameters()), 1e-4, 1000, warmup_ratio=0.1,
                        max_norm=1.0)
        progs = {way: TrainPrograms(model, opt, zoo.mse_loss, "regression", gen)
                 for way in ("off", "on")}

        def state(p):
            return [t.clone() for t in (*opt.graph_state, p.metric_sums)], gen.get_state()

        def restore(p, saved):
            with torch.no_grad():
                for t, v in zip((*opt.graph_state, p.metric_sums), saved[0]):
                    t.copy_(v)
            gen.set_state(saved[1])

        def same(a, b):
            return all(torch.equal(x, y) for x, y in zip([*a[0]], [*b[0]])) and \
                torch.equal(a[1], b[1])

        _set_remat(model, True)
        p = progs["on"]
        s0 = state(p)
        m_eager = torch.stack([p.single(*res.take(idx[k])) for k in range(K)])
        after_eager = state(p)
        restore(p, s0)
        m_graph = p.feed(res, idx)
        torch.cuda.synchronize()
        after_graph = state(p)
        graph_equal = torch.equal(m_graph, m_eager) and same(after_graph, after_eager)
        out["b_graph"] = {"steps": K, "graph_bit_equal_eager": graph_equal,
                          "graphs": len(p.graphs), "warmups": GRAPH_WARMUP}
        print("remat: (b) " + json.dumps(out["b_graph"]), flush=True)
        if not graph_equal:
            raise Failed("remat (b): the replayed steps with remat differ from eager ones")
        timing = {}
        for way in ("off", "on"):
            _set_remat(model, way == "on")
            fn = (lambda p=progs[way]: p.feed(res, idx))
            one, ms, kernels = _replay_launches(fn)
            timing[way] = {"device_ms_per_step": ms / K, "device_kernels_per_step": kernels / K,
                           "port_launches_per_step": {k: n / K for k, n in one.items()}}
            if {k: n / K for k, n in one.items()} != per_step[way]:
                raise Failed(f"remat (d) {way}: a replayed step launched {one} / {K}, "
                             f"expected {per_step[way]}")
        timing["on_over_off"] = timing["on"]["device_ms_per_step"] / \
            timing["off"]["device_ms_per_step"]
        out["d_step"] = timing
        print("remat: (d) " + json.dumps(timing) + f" ({card})", flush=True)
        _set_remat(model, False)
        del progs, opt, model, res
        torch.cuda.empty_cache()

    # (e) the rule's decisions at the shapes of PERF.md §4
    rule = []
    for b, n in REMAT_RULE_SHAPES + ((REMAT_MOF_B, REMAT_MOF_N),):
        mof_shape = (b, n) == (REMAT_MOF_B, REMAT_MOF_N)
        cfg = ucfg
        need = nnmodel.predicted_step_bytes(b, n, 0 if mof_shape else L, cfg)
        rule.append({"B": b, "N": n, "model": "mof" if mof_shape else "mm",
                     "predicted_peak_off": need,
                     "predicted_peak_on": nnmodel.predicted_step_bytes(
                         b, n, 0 if mof_shape else L, cfg, remat=True),
                     "remat": nnmodel.auto_remat(dataclasses.asdict(cfg), n, L, b, dev,
                                                 data_type="mof" if mof_shape else "molecule")})
    out["e_rule"] = {"share": nnmodel.REMAT_MEMORY_SHARE, "total_memory": total_memory,
                     "decisions": rule}
    print("remat: (e) " + json.dumps(out["e_rule"]), flush=True)
    if any(r["remat"] for r in rule if (r["B"], r["N"]) in ((32, 64), (32, 280))):
        raise Failed("remat (e): the rule turned remat on at a shape the card holds easily")
    print(f"remat: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---- tensor parallelism ---------------------------------------------------------

TP_WORK = os.path.join(REPO, "build", "chip_smoke_tp")
TP_GBF_HEADS = (16, 32, 48)   # a model rank's gbf heads: flagship 64/4, 64/2, scale-arch 96/2
TP_SEED = 11                  # the step's weights and dropout stream
TP_RANK_TIMEOUT_S = 600
TP_SERVE_TOL = SERVE_PREDICT_TOL   # the two-shard server against the one-shard server


class _HeadLog:
    """Inside the block, the head count of every launch of the attention
    and gbf launchers: {"launcher heads=H": n}.  The launchers are wrapped
    in their module while the block runs (their counters still count) and
    restored after it."""

    def __enter__(self):
        from mmdti_tpu_torch.ops import hopper_attention as ha
        from mmdti_tpu_torch.ops import hopper_gbf as hg

        self.seen, self._saved = {}, []
        heads = {"pair_bias_attention_cuda": lambda a: a[4],
                 "pair_bias_attention_bwd_cuda": lambda a: a[8],
                 "masked_attention_cuda": lambda a: a[4],
                 "masked_attention_bwd_cuda": lambda a: a[7],
                 "gbf_pair_bias_cuda": lambda a: a[5].shape[0],
                 "gbf_pair_bias_bwd_cuda": lambda a: a[5].shape[0]}
        for mod in (ha, hg):
            for name, of in heads.items():
                if not hasattr(mod, name):
                    continue
                real = getattr(mod, name)

                def fn(*a, _real=real, _name=name, _of=of, **kw):
                    key = f"{_name} heads={_of(a)}"
                    self.seen[key] = self.seen.get(key, 0) + 1
                    return _real(*a, **kw)

                # a launcher counts through its module's name for it, the
                # wrapper while the block runs: it carries the counters
                fn.launches, fn.routes = real.launches, real.routes
                self._saved.append((mod, name, real, fn))
                setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, real, fn in self._saved:
            real.launches = fn.launches
            setattr(mod, name, real)
        return False


def _tp_step(dev, model, data_group=None):
    """One flagship train step (B=32, N=L=64, bf16, every dropout on, the
    LayerNorm kernels on) from seed TP_SEED: (loss, gradients by name,
    launch counts, routes, heads, the step's bytes: the peak allocated
    less what the process held before the model came to the card)."""
    import torch

    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.parallel.mesh import rank_seed
    from mmdti_tpu_torch.train.steps import build_train_loss

    model.reset_parameters_like_flax(torch.Generator().manual_seed(TP_SEED))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    model.to(dev)
    B = 32
    feats = _train_batch(dev, 64, 64, B)
    labels = torch.randn(B, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    weights = torch.ones(B, 1, device=dev)
    train_loss = build_train_loss(zoo.mse_loss, "regression", data_group=data_group)
    gen = torch.Generator(device=dev).manual_seed(
        rank_seed(TP_SEED, 0 if data_group is None else data_group.rank))
    names, params = zip(*model.named_parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    with _ln_kernels_on(), _HeadLog() as log:
        total, _ = train_loss(model, feats, labels, weights, gen)
        grads = torch.autograd.grad(total, params)
    torch.cuda.synchronize()
    return (float(total.detach()), dict(zip(names, grads)), _read_counts(), _read_routes(),
            log.seen, torch.cuda.max_memory_allocated(dev) - held)


def tp_worker(rank, port, spec_path):
    """One rank of phase tp (a): a gloo group of two processes on the one
    card as one model row, mesh (1, 2); the flagship step on this rank's
    shard (_tp_step); rank 0 saves the loss and the gradient gathered whole
    over the model group.  Writes its findings to the spec's ``out``."""
    import torch

    sys.path.insert(0, REPO)
    from mmdti_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, mesh_groups

    with open(spec_path) as f:
        spec = json.load(f)
    dev = initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                                 timeout=TP_RANK_TIMEOUT_S)
    data_group, model_group = mesh_groups(make_mesh((1, 2)))
    t0 = time.perf_counter()
    loss, grads, counts, routes, heads, peak = _tp_step(
        dev, _flagship(True, model_group=model_group), data_group)
    step_s = time.perf_counter() - t0
    whole = model_group.gather_state_dict(grads)
    if rank == 0:
        torch.save({"loss": loss, "grads": whole}, spec["grads"])
    out = {"rank": rank, "device": str(dev), "model_index": model_group.index,
           "loss": loss, "launches": counts, "routes": routes, "heads": heads,
           "step_peak_bytes": peak, "step_s_with_setup": step_s,
           "model_collectives": model_group.calls}
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _tp_ranks(dev, card):
    """Phase tp (a): the two ranks beside the one-process step."""
    import torch

    shutil.rmtree(TP_WORK, ignore_errors=True)
    os.makedirs(TP_WORK)
    spec = {"out": os.path.join(TP_WORK, "rank{rank}.json"),
            "grads": os.path.join(TP_WORK, "grads.pt")}
    spec_path = os.path.join(TP_WORK, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for r in range(2):
        with open(os.path.join(TP_WORK, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                 "--tp-port", str(port), "--tp-spec", spec_path],
                stdout=log, stderr=subprocess.STDOUT))
    try:
        # the one-process step meanwhile
        loss1, grads1, counts1, routes1, heads1, peak1 = _tp_step(dev, _flagship(True))
        grads1 = {k: v.float().cpu() for k, v in grads1.items()}
        for p in procs:
            p.wait(timeout=TP_RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        tails = []
        for r in range(2):
            with open(os.path.join(TP_WORK, f"rank{r}.log")) as f:
                tails.append(f"rank {r}:\n" + f.read()[-3000:])
        raise Failed("tp (a): a rank failed\n" + "\n".join(tails))
    ranks = []
    for r in range(2):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    saved = torch.load(spec["grads"], weights_only=True)
    floor = 1e-3 * max(float(g.abs().max()) for g in grads1.values())
    rel = {}
    for name, g in grads1.items():
        got = saved["grads"][name].float()
        if not torch.isfinite(got).all():
            raise Failed(f"tp (a): the gathered gradient of {name} is not finite")
        rel[name] = float((got - g).abs().max()) / max(float(g.abs().max()), floor)
    worst = max(rel, key=rel.get)
    want_heads = {"pair_bias_attention_cuda heads=32", "pair_bias_attention_bwd_cuda heads=32",
                  "masked_attention_cuda heads=4", "masked_attention_cuda heads=8",
                  "masked_attention_bwd_cuda heads=4", "masked_attention_bwd_cuda heads=8",
                  "gbf_pair_bias_cuda heads=32", "gbf_pair_bias_bwd_cuda heads=32"}
    print("tp: (a) " + json.dumps({
        "mesh": [1, 2], "backend": "gloo, two ranks on one card", "B": 32, "N": 64, "L": 64,
        "dropout": "every layer's default", "loss_one_process": loss1,
        "loss_ranks": [r["loss"] for r in ranks], "loss_tol": TRAIN_LOSS_TOL,
        "max_rel_grad_diff": rel[worst], "worst_param": worst,
        "median_rel_grad_diff": statistics.median(rel.values()), "grad_tol": TRAIN_GRAD_TOL,
        # the weights, the batch and the step's activations and gradients
        "step_peak_gb": {"one_process": peak1 / 1e9,
                         **{f"rank{r['rank']}": r["step_peak_bytes"] / 1e9 for r in ranks}},
        "launches": {"one_process": counts1,
                     **{f"rank{r['rank']}": r["launches"] for r in ranks}},
        "heads": {"one_process": heads1, **{f"rank{r['rank']}": r["heads"] for r in ranks}},
        "gbf_routes": {f"rank{r['rank']}": [r["routes"]["gbf_proj"], r["routes"]["gbf_proj_bwd"]]
                       for r in ranks},
        "model_collectives": [r["model_collectives"] for r in ranks],
        "step_s_with_setup": [r["step_s_with_setup"] for r in ranks], "card": card}),
        flush=True)
    for r in ranks:
        if abs(r["loss"] - loss1) > TRAIN_LOSS_TOL:
            raise Failed(f"tp (a): rank {r['rank']} loss {r['loss']} vs one process {loss1}")
        if r["loss"] != ranks[0]["loss"]:
            raise Failed("tp (a): the model ranks' losses differ")
        zero = [k for k, n in r["launches"].items() if n == 0]
        if zero:
            raise Failed(f"tp (a): rank {r['rank']} launched {zero} no time")
        missing = want_heads - set(r["heads"])
        if missing:
            raise Failed(f"tp (a): rank {r['rank']} launched no {sorted(missing)}: {r['heads']}")
        if r["routes"]["gbf_proj"]["fma"] or r["routes"]["gbf_proj_bwd"]["fma"]:
            raise Failed(f"tp (a): rank {r['rank']} ran gbf on the FMA route: {r['routes']}")
    if rel[worst] > TRAIN_GRAD_TOL:
        raise Failed(f"tp (a): gathered gradient of {worst} differs by {rel[worst]} of its max")
    return {f"rank{r['rank']}": r["launches"] for r in ranks}


def _tp_server(dev, card):
    """Phase tp (b): the two shards of one replica on cuda:0."""
    import numpy as np

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.api import serve_api

    real_mesh = serve_api.make_mesh
    serve_api.make_mesh = lambda shape, devices=None: real_mesh(shape, [dev, dev])
    try:
        tp_srv = MolServe(SERVE_DIR, mesh_shape=(1, 2))
    finally:
        serve_api.make_mesh = real_mesh
    one = MolServe(SERVE_DIR)
    requests = {n: SMILES_20[:n] for n in REQUESTS}
    smi20 = requests[20]
    _reset_counts()
    graph_out = tp_srv.predict(smi20)["predict"]
    counts = _read_counts()
    eager_srv = MolServe.__new__(MolServe)
    eager_srv.__dict__.update(tp_srv.__dict__)
    eager_srv.use_graphs = False
    eager_out = eager_srv.predict(smi20)["predict"]
    one_out = one.predict(smi20)["predict"]
    p50, _ = _alternated_p50({"graph": tp_srv, "eager": eager_srv, "one_shard_graph": one},
                             requests)
    gap = float(np.abs(graph_out - one_out).max())
    same = bool(np.array_equal(graph_out, eager_out))
    print("tp: (b) " + json.dumps({
        "mesh": [1, 2], "shards_on": [str(d) for d in tp_srv.mesh.devices],
        "graphs": len(tp_srv.graphs), "graph_equals_eager": same,
        "max_abs_vs_one_shard": gap, "tol": TP_SERVE_TOL, "p50_ms": p50,
        "launches_first_request_20": counts, "card": card}), flush=True)
    if not same:
        raise Failed("tp (b): the two-shard server's graph replay differs from its eager "
                     "forward")
    if gap > TP_SERVE_TOL:
        raise Failed(f"tp (b): the two-shard server is {gap} from the one-shard server")
    if not tp_srv.graphs:
        raise Failed("tp (b): the two-shard server recorded no graph")


def phase_tp(dev, card):
    """Tensor parallelism on the one card.  (a) Two gloo ranks as one model
    row, mesh (1, 2): the flagship train step (B=32, N=L=64, bf16, dropout
    on) on each rank's shard, held to the one-process step on the same
    weights and seed (loss TRAIN_LOSS_TOL, each gradient TRAIN_GRAD_TOL of
    its max, gathered whole); every kernel launched on each rank, at its
    shard's heads (pair-bias 32, masked 4 and 8, gbf 32 on "mma"); each
    rank's peak memory beside the one-process step's (above what each
    process held before its model came to the card).  (b) A (1, 2) server
    whose two shards share cuda:0 (make_mesh given the card twice, the
    twin of the CPU's repeated device): its graph replay bit-equal to its
    eager forward, within TP_SERVE_TOL of the one-shard server, p50 at 1,
    8 and 20 SMILES each way.  NCCL refuses two ranks on one card: the
    collectives of (a) are gloo's (eager steps).  Returns (a)'s launch
    counts by rank."""
    t0 = time.perf_counter()
    launches = _tp_ranks(dev, card)
    t1 = time.perf_counter()
    _tp_server(dev, card)
    print("tp: " + json.dumps({"a_s": t1 - t0, "b_s": time.perf_counter() - t1}), flush=True)
    return launches


def main() -> int:
    if "--dp-rank" in sys.argv:       # one rank of phase dp (b), started by phase dp
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        dp_worker(int(args["--dp-rank"]), int(args["--dp-port"]), args["--dp-spec"])
        return 0
    if "--tp-rank" in sys.argv:       # one rank of phase tp (a), started by phase tp
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        tp_worker(int(args["--tp-rank"]), int(args["--tp-port"]), args["--tp-spec"])
        return 0
    if not os.path.isdir(os.path.join(REPO, "mmdti_tpu_torch")):
        print("chip_smoke.py needs the mmdti_tpu_torch package beside it", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py needs torch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"seconds: {name} {seconds[name]}", flush=True)
        return out

    card = timed("card", phase_card)
    build = timed("build", phase_build)
    summary = timed("kernels", phase_kernels, dev)
    timed("serve", phase_serve, dev, card)
    train_launches = timed("train", phase_train, dev)
    graph_fit = timed("graphs", phase_graphs, dev)
    remat_launches = timed("remat", phase_remat, dev, card)
    fit_launches = timed("fit", phase_fit, dev, graph_fit)
    task_launches = timed("tasks", phase_tasks, dev)
    cv_launches = timed("cv", phase_cv, dev, graph_fit)
    pretrained_launches = timed("pretrained", phase_pretrained, dev, card, graph_fit)
    mof_launches = timed("mof", phase_mof, dev, card)
    conformer_launches = timed("conformers", phase_conformers, dev, card, build)
    scaler_launches = timed("scalers", phase_scalers, dev, card, graph_fit)
    dp_launches = timed("dp", phase_dp, dev, card, graph_fit)
    tp_launches = timed("tp", phase_tp, dev, card)
    print("seconds: " + json.dumps({**seconds, "total": round(sum(seconds.values()), 1)}),
          flush=True)

    launches = {k: train_launches[k] if k in TRAIN_KERNELS else fit_launches[k] for k in KERNELS}
    for name, n in launches.items():
        if n == 0:
            raise Failed(f"{name} was not launched on its path")
    pretrained_total = _add_counts(*pretrained_launches.values())
    for task, counts in {**task_launches, "cv": cv_launches, "pretrained": pretrained_total,
                         "conformers": conformer_launches, "scalers": scaler_launches,
                         "remat": remat_launches,
                         **{f"dp {run}": c for run, c in dp_launches.items()},
                         **{f"tp {run}": c for run, c in tp_launches.items()}}.items():
        for name, n in counts.items():
            if n == 0:
                raise Failed(f"{name} was not launched on the {task} path")
    # a MOF model has no SMILES stream: masked attention launches nowhere on it
    for name, n in mof_launches.items():
        if (n != 0) if name.startswith("masked") else (n == 0):
            raise Failed(f"{name} launched {n} times on the mof path")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **summary[name],
         "task_launches": {task: counts[name] for task, counts in task_launches.items()},
         "cv_launches": cv_launches[name],
         "pretrained_launches": {run: counts[name] for run, counts in pretrained_launches.items()},
         "mof_launches": mof_launches[name],
         "conformers_launches": conformer_launches[name],
         "scalers_launches": scaler_launches[name], "remat_launches": remat_launches[name],
         "dp_launches": {run: counts[name] for run, counts in dp_launches.items()},
         "tp_launches": {run: counts[name] for run, counts in tp_launches.items()}}
        for name, (src, rep) in KERNELS.items()
    ]
    print(card, flush=True)   # again beside the summary, for readers of the tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
