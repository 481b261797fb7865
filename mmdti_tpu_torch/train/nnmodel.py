"""Task-level model orchestration (port of mmdti_tpu/train/nnmodel.py).

Resolves the task's loss, activation and output width, builds the model
(models/mm_model.py::build_model) with the tokenizer and atom dictionary,
draws its initial weights, prepares the FDS state and buckets, and drives
Trainer.fit_predict (``run``: one train/validation pair; ``run_cv``: one
fold after another, every fold from the same initial weights, with
out-of-fold predictions) and the best-checkpoint predict (``evaluate``,
averaging fold checkpoints).  multilabel_classification with
``loss_key="ghm"`` trains with its EMA bin counts carried on the device
(losses/zoo.py GHMCState).

Pretrained weights: ``unimol_dir`` (a unicore ``.pt``; the atom dictionary
is the ``mol.dict.txt`` beside it, plus [MASK]) and ``chemberta_dir`` (an
HF ChemBERTa dir: its BPE tokenizer, its config.json dims under the
user's ``chemberta_overrides``, its weights) are loaded over the random
initial weights (models/convert.py::load_pretrained) before the optimizer
takes the parameters into its flat buffer and before cross-validation
snapshots the weights every fold starts from.  Freezing
(``freeze_layers``, ``freeze_layers_reversed``, ``freeze_module``) selects
parameters by the JAX package's name-prefix predicate on their flax paths
(``frozen_parameter_names``); the frozen ones get ``requires_grad=False``,
so autograd does none of their work, and the optimizer keeps them where
they are.

``use_pallas`` keeps the JAX config key: 'auto' or True builds the kernel
path (the Hopper kernels on a CUDA device, their plain versions on the
CPU), False the plain oracle path.  The threaded pair logits are bf16 on a
CUDA device and fp32 on the CPU unless ``unimol_overrides`` names a dtype.
``device_pair_feats`` ('auto', True/'device', False/'host';
ops/pair_feats.py resolve_pair_feats_mode) puts the pair distances and
edge types on the host collator or in the model: 'auto' builds them on the
device on a CUDA device and on the host on the CPU, and features made
without host pair arrays (``pair_feats=False``) take the device mode.
``data_type='mof'`` builds models/mof.py's MOFModel (``mof_overrides``);
it takes no InfoNCE and no ChemBERTa checkpoint.  ``data_type='docking'``
builds models/docking.py's DockingPoseModel (``pocket_overrides``,
``decoder_layers``, ``recycling``) over the ligand and pocket dictionaries
(chem/pocket.py), pads the pockets to their own length and trains the
docking_pose loss on the padded distance targets (task 'docking'); it
takes no InfoNCE, CT, FDS or pretrained checkpoint, and runs without
tensor parallelism.

``unimol_overrides={"remat": True}`` (or False) decides encoder remat
(models/unimol.py); without it the fit decides (``auto_remat``, logging
the JAX package's message): on the CPU at the JAX package's XLA-path
threshold, an atom pad of 160; on a CUDA device where the card's memory
model (``predicted_step_bytes``) puts one eager step of this rank's rows
past REMAT_MEMORY_SHARE of the device's memory.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, FrozenSet, Optional

import numpy as np
import torch

from mmdti_tpu_torch.chem.dictionary import Dictionary, unimol_dict_path
from mmdti_tpu_torch.chem.pocket import MAX_POCKET_ATOMS, pocket_dictionary
from mmdti_tpu_torch.chem.tokenizer import load_tokenizer
from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
from mmdti_tpu_torch.data.batching import (
    BatchCollator,
    MolDataset,
    dataset_pad_lengths,
    docking_labels,
)
from mmdti_tpu_torch.data.reader import read_csv
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.losses.fds import fds_bucket_params, fds_kernel_window, init_fds_state
from mmdti_tpu_torch.losses.registry import ACTIVATION_REGISTRY, resolve_loss, resolve_output_dim
from mmdti_tpu_torch.models.convert import chemberta_overrides, flax_path, load_pretrained
from mmdti_tpu_torch.models.docking import build_docking_model
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.models.mof import build_mof_model
from mmdti_tpu_torch.ops.pair_feats import resolve_pair_feats_mode
from mmdti_tpu_torch.parallel.mesh import load_model_state, model_state
from mmdti_tpu_torch.train.trainer import Trainer, load_weights

logger = logging.getLogger("mmdti_tpu_torch")


def _names(value):
    """A comma string or a list of names -> the list (spaces dropped)."""
    if isinstance(value, str):
        return [p for p in value.replace(" ", "").split(",") if p]
    if isinstance(value, (list, tuple)):
        return list(value)
    return []


def frozen_parameter_names(model, freeze_layers=None, reversed_sel: bool = False,
                           freeze_module=None) -> FrozenSet[str]:
    """The names of ``model``'s parameters that stay frozen: the JAX
    package's predicate (train/nnmodel.py::_build_frozen_mask) on each
    parameter's flax path joined by dots (models/convert.py's bridge rule),
    so a prefix reaching a leaf (``...fc1.kernel``, ``...ln.scale``)
    selects the same tensors in both packages.  A path starting with one
    of ``freeze_layers`` (a comma string or a list; a plain prefix match,
    so ``encoder.layers_1`` also takes layers 10-19: end it with '.'),
    the opposite with ``reversed_sel``, or whose first name is one of
    ``freeze_module``."""
    prefixes, modules = _names(freeze_layers), _names(freeze_module)
    if not prefixes and not modules:
        return frozenset()
    frozen = set()
    for name, p in model.named_parameters():
        path = ".".join(flax_path(name, p.dim()))
        hit = any(path.startswith(pref) for pref in prefixes)
        if reversed_sel:
            hit = not hit
        if modules and path.split(".")[0] in modules:
            hit = True
        if hit:
            frozen.add(name)
    return frozenset(frozen)


# the JAX package's remat threshold on its XLA path, which the port's CPU
# path twins: a fit whose atom pad reaches it rematerializes the encoder
CPU_REMAT_ATOM_PAD = 160
# on a CUDA device remat turns on where one eager train step's predicted
# peak without it passes this share of the card's memory
REMAT_MEMORY_SHARE = 0.8
# The card's memory model of one eager train step (per rank: its rows of
# the batch), in bytes: STATIC (the weights, FusedAdam's buffers) plus,
# per row, for each Uni-Mol layer PAIR_LAYER bytes an element of its
# [H,N,N] logits (the bf16 chain, which remat keeps too) and TOKEN_LAYER
# bytes an atom (the activations remat frees; held for one layer, the one
# recomputed, under remat; scaled by (E + FFN) / 2560), and for the rest
# of the step TOKEN_OTHER bytes an atom and SMILES bytes a SMILES token.
# PAIR_LAYER and TOKEN_LAYER are what autograd saves (saved-tensor
# hooks), the rest a non-negative least-squares fit to the peaks
# allocated: scripts/remat_memory.py on an NVIDIA H100 80GB HBM3 at
# 700 W, flagship widths, bf16 compute and pair logits, LayerNorm kernels
# off (MMDTI_PALLAS_LN=0), B=32-256, N=64-280, L=64/256.  Without remat
# every peak is within 3.5 % of the model but the smallest (B=32, N=64:
# 12 % under); with remat within 8 % from B=128 or N=160 up, and under by
# up to 38 % below that, where the step's peak is not the activations'
# (PERF.md §6).  With the kernels on, the card's default, the model lies
# 20-40 % above the peak without remat from B=64 or N=160 up, so the rule
# turns remat on early, never late.  The rule reads only the peak without
# remat.  Under tensor parallelism over m model ranks a rank holds 1/m of
# each layer's logits and of its sharded token activations (the model's
# own split, not a measured one: TOKEN_LAYER is divided by m whole).
STEP_MEMORY = dict(static=1.187e9, pair_layer=2.0, token_layer=28_184.0,
                   token_other=53_663.0, smiles=187_059.0)


def predicted_step_bytes(rows: int, atom_pad: int, smiles_pad: int, cfg: UniMolEncoderConfig,
                         remat: bool = False, model_parallel: int = 1) -> float:
    """One eager train step's peak allocated bytes on the card (the memory
    model above): ``rows`` molecules of ``atom_pad`` atoms and
    ``smiles_pad`` SMILES tokens (0 for a MOF model), on one of
    ``model_parallel`` model ranks."""
    m = STEP_MEMORY
    layers = cfg.encoder_layers
    pair = cfg.attention_heads * float(atom_pad) ** 2 / model_parallel
    pair_scale = (2.0 if cfg.pair_dtype == "bfloat16" else 4.0) / 2.0
    token = (cfg.embed_dim + cfg.ffn_embed_dim) / 2560.0 * atom_pad / model_parallel
    per_row = (layers * m["pair_layer"] * pair_scale * pair
               + (1 if remat else layers) * m["token_layer"] * token
               + m["token_other"] * atom_pad + m["smiles"] * smiles_pad)
    return m["static"] + rows * per_row


def docking_step_bytes(rows: int, atom_pad: int, pocket_pad: int, cfg: UniMolEncoderConfig,
                       decoder_layers: int = 4, recycling: int = 3) -> float:
    """One eager docking train step's peak (models/docking.py) by the same
    memory model, summed over its three stacks: the ligand encoder at
    ``atom_pad``, the pocket encoder at ``pocket_pad`` and the decoder's
    ``decoder_layers * recycling`` layer applications at their sum, one
    STATIC for all (the model's own sum, not a fitted one), plus the cross
    head's pair activations: four [Nm, Np, 2E + H] tensors a row in bf16."""
    def stack(layers, n):
        return predicted_step_bytes(
            rows, n, 0, dataclasses.replace(cfg, encoder_layers=layers)) - STEP_MEMORY["static"]

    n_c = atom_pad + pocket_pad
    heads = rows * 4 * 2.0 * atom_pad * pocket_pad * (2 * cfg.embed_dim + cfg.attention_heads)
    return (STEP_MEMORY["static"] + stack(cfg.encoder_layers, atom_pad)
            + stack(cfg.encoder_layers, pocket_pad) + stack(decoder_layers * recycling, n_c)
            + heads)


def auto_remat(unimol_overrides: Dict[str, Any], atom_pad: int, smiles_pad: int, rows: int,
               device: torch.device, data_type: str = "molecule",
               total_memory: Optional[int] = None, model_parallel: int = 1,
               pocket_pad: int = 0, decoder_layers: int = 4, recycling: int = 3) -> bool:
    """Whether a fit turns encoder remat on by itself (the JAX package's
    train/nnmodel.py rule; an explicit ``remat`` is the caller's).  On the
    CPU the port runs the plain path, the twin of the JAX package's XLA
    path, so it takes that path's threshold: atom_pad >= 160.  On a CUDA
    device remat turns on where the predicted peak of one eager step
    without it, for this rank's ``rows`` and its share of ``model_parallel``
    model ranks, passes REMAT_MEMORY_SHARE of the card's memory
    (``total_memory``, else the device's own).  A docking model
    (``pocket_pad``, ``decoder_layers``, ``recycling``) is judged at its
    complex, the decoder's length, on the CPU and by docking_step_bytes on
    a card."""
    docking = data_type == "docking"
    if device.type != "cuda":
        return (atom_pad + pocket_pad if docking else atom_pad) >= CPU_REMAT_ATOM_PAD
    if total_memory is None:
        total_memory = torch.cuda.get_device_properties(device).total_memory
    cfg = UniMolEncoderConfig(**{k: v for k, v in unimol_overrides.items() if k != "remat"})
    if docking:
        need = docking_step_bytes(rows, atom_pad, pocket_pad, cfg, decoder_layers, recycling)
    else:
        need = predicted_step_bytes(rows, atom_pad, 0 if data_type == "mof" else smiles_pad,
                                    cfg, model_parallel=model_parallel)
    return need > REMAT_MEMORY_SHARE * total_memory


class NNModel:
    def __init__(self, data_train: Dict[str, Any], data_test: Dict[str, Any], trainer: Trainer,
                 **params):
        self.data_type = params.get("data_type", "molecule")
        if self.data_type == "mof" and params.get("using_infonce", False):
            raise ValueError(
                "using_infonce=True is not applicable to data_type='mof': MOF samples have "
                "no SMILES stream to align (MOFModel, models/mof.py)")
        if self.data_type == "docking":
            for key in ("using_infonce", "using_ct", "fds"):
                if params.get(key, False):
                    raise ValueError(f"{key}=True is not applicable to data_type='docking' "
                                     "(models/docking.py trains the docking_pose loss alone)")
            if params.get("unimol_dir"):
                raise NotImplementedError(
                    "data_type='docking' starts from random weights: the published "
                    "mol/pocket checkpoints' name map waits on those files")
        self.data_train = data_train
        self.data_test = data_test
        self.trainer = trainer
        self.device = trainer.device
        self.task = params["task"]
        self.num_classes = data_train.get("num_classes")
        self.target_scaler = data_train.get("target_scaler")
        self.features_train = data_train["unimol_input"]
        self.features_test = data_test["unimol_input"]
        self.loss_key = params.get("loss_key", None)
        self.using_ct = params.get("using_ct", False)
        self.using_infonce = params.get("using_infonce", False)
        self.use_weight = params.get("use_weight", False)
        self.use_fds = params.get("fds", False)
        self.fds_num = params.get("fds_num", 30)
        self.save_path = trainer.save_path
        self.model_folds = int(params.get("model_folds", 1) or 1)
        self.cv: Dict[str, Any] = {}

        # the atom dictionary beside a Uni-Mol checkpoint sets the shapes of
        # embed_tokens and of gbf's edge tables
        self.dictionary = Dictionary.load(unimol_dict_path(params.get("unimol_dir")))
        self.dictionary.add_symbol("[MASK]", is_special=True)
        self.tokenizer = load_tokenizer(params.get("chemberta_dir", "") or None)
        self.output_dim = resolve_output_dim(self.task, self.num_classes,
                                             data_train.get("multiclass_cnt"))
        self.loss_func = resolve_loss(self.task, self.loss_key)
        self.activation_fn = ACTIVATION_REGISTRY[self.task]
        # GHM's EMA bin counts persist across train steps; validation scores
        # the stateless GHM of the registry, as in the JAX package
        self.stateful_loss = None
        if self.task == "multilabel_classification" and self.loss_key == "ghm":
            self.stateful_loss = zoo.GHMCState(self.device)

        pad_multiple = int(params.get("pad_multiple", 16))
        pad_mode = params.get("pad_mode", "dataset")
        if pad_mode == "fixed":
            def up(n):
                return int(-(-n // pad_multiple) * pad_multiple)

            self.atom_pad = up(int(params.get("max_atoms", 256)) + 2)
            self.smiles_pad = up(int(params.get("smiles_pad_len", 128)))
        else:
            self.atom_pad, self.smiles_pad = dataset_pad_lengths(
                self.features_train, self.tokenizer, pad_multiple,
                extra_datasets=[self.features_test])
        self.pocket_pad = 0
        if self.data_type == "docking":
            # the pocket's own pad, and the padded distance targets as labels
            longest = (int(params.get("max_pocket_atoms", MAX_POCKET_ATOMS)) + 2
                       if pad_mode == "fixed" else
                       max(len(f["pocket_src_tokens"])
                           for f in [*self.features_train, *self.features_test]))
            self.pocket_pad = -(-longest // pad_multiple) * pad_multiple
            for data in (data_train, data_test):
                data["target"] = docking_labels(data["unimol_input"], self.atom_pad,
                                                self.pocket_pad)
        self.pair_feats = resolve_pair_feats_mode(params.get("device_pair_feats", "auto"),
                                                  self.device)
        probe = (self.features_train or self.features_test or [None])[0]
        if self.pair_feats == "host" and isinstance(probe, dict) and "src_distance" not in probe:
            logger.info("features were built without host pair arrays (pair_feats=False); "
                        "switching the collator to device-side pair featurization")
            self.pair_feats = "device"
        self.collator = BatchCollator(self.tokenizer, pad_idx=self.dictionary.pad(),
                                      pad_mode=pad_mode, atom_pad=self.atom_pad,
                                      smiles_pad=self.smiles_pad, pair_feats=self.pair_feats,
                                      pocket_pad=self.pocket_pad)

        use_kernels = params.get("use_pallas", "auto")
        use_kernels = True if use_kernels == "auto" else bool(use_kernels)
        unimol_overrides = dict(params.get("unimol_overrides") or {})
        unimol_overrides.setdefault(
            "pair_dtype", "bfloat16" if self.device.type == "cuda" else "float32")
        # an explicit remat always wins; else the device's rule decides
        if "remat" not in unimol_overrides and auto_remat(
                unimol_overrides, self.atom_pad, self.smiles_pad,
                trainer.batch_size // (trainer.data_group.size if trainer.data_group else 1),
                self.device, data_type=self.data_type,
                model_parallel=trainer.model_group.size if trainer.model_group else 1,
                pocket_pad=self.pocket_pad, decoder_layers=int(params.get("decoder_layers", 4)),
                recycling=int(params.get("recycling", 3))):
            unimol_overrides["remat"] = True
            logger.info("Auto-enabled encoder rematerialization (atom_pad=%d)", self.atom_pad)
        common = dict(
            output_dim=self.output_dim,
            atom_vocab_size=len(self.dictionary),
            atom_pad_idx=self.dictionary.pad(),
            compute_dtype=params.get("compute_dtype", "bfloat16"),
            use_kernels=use_kernels,
            unimol_overrides=unimol_overrides,
            task=self.task,
            use_fds=self.use_fds,
            fds_num=self.fds_num,
            model_group=trainer.model_group,
        )
        if self.data_type == "mof":
            self.model = build_mof_model(
                **common, mof_overrides=dict(params.get("mof_overrides") or {}) or None)
        elif self.data_type == "docking":
            pdict = pocket_dictionary(params.get("pocket_dict_path"))
            self.model = build_docking_model(
                len(self.dictionary), self.dictionary.pad(), len(pdict), pdict.pad(),
                common["compute_dtype"], use_kernels, unimol_overrides,
                pocket_overrides=dict(params.get("pocket_overrides") or {}) or None,
                decoder_layers=int(params.get("decoder_layers", 4)),
                recycling=int(params.get("recycling", 3)))
        else:
            self.model = build_model(
                **common,
                smiles_vocab_size=getattr(self.tokenizer, "vocab_size", 600),
                chemberta_overrides=chemberta_overrides(params) or None,
                crossmodal_overrides=dict(params.get("crossmodal_overrides") or {}) or None,
            )
        # predict restores a checkpoint over whatever is drawn here, and
        # freezing is train-only
        self.frozen: FrozenSet[str] = frozenset()
        if not params.get("evaluate_only"):
            self._init_params(params)
            n_params = sum(p.numel() for p in self.model.parameters())
            logger.info("Number of trainable parameters: %d", n_params)
            self.frozen = frozen_parameter_names(
                self.model, params.get("freeze_layers"),
                bool(params.get("freeze_layers_reversed", False)), params.get("freeze_module"))
            for name, p in self.model.named_parameters():
                p.requires_grad_(name not in self.frozen)
            if self.frozen:
                n_frozen = sum(p.numel() for n, p in self.model.named_parameters()
                               if n in self.frozen)
                logger.info("Frozen: %d parameter tensors, %d parameters", len(self.frozen),
                            n_frozen)
        self.model.to(self.device)

        self.fds_state = None
        self.fds_bucket = (0.0, 1.0)
        self.fds_kernel = None
        if self.use_fds and self.task == "regression":
            raw_path = params.get("fds_raw_path", "") or params.get("raw_data", "")
            col = params.get("fds_col_data", "") or data_train["target_cols"][0]
            if raw_path and isinstance(raw_path, str) and os.path.exists(raw_path):
                raw_vals = np.asarray(read_csv(raw_path)[col], np.float64)
            else:
                raw_vals = np.asarray(data_train["raw_target"]).reshape(-1)
            self.fds_bucket = fds_bucket_params(raw_vals, self.fds_num,
                                                using_scale=params.get("use_scaler", True))
            cfg = self.model.fds_cfg
            self.fds_state = init_fds_state(cfg, self.device)
            self.fds_kernel = fds_kernel_window(cfg.kernel, cfg.ks, cfg.sigma)

    def _init_params(self, params) -> None:
        """The initial weights: random ones, then the pretrained checkpoints'
        tensors over them (under tensor parallelism over the whole model's
        state dict, gathered, and this rank's shard kept)."""
        self._random_init()
        if self.data_type == "docking":
            return
        load_model_state(self.model, load_pretrained(
            model_state(self.model), unimol_dir=params.get("unimol_dir") or None,
            # MOFModel has no ChemBERTa stream to take those weights
            chemberta_dir=(params.get("chemberta_dir") or None)
            if self.data_type != "mof" else None))

    def _random_init(self) -> None:
        """Random weights, drawn as the flax initializers draw them, from
        the trainer's seed."""
        self.model.reset_parameters_like_flax(torch.Generator().manual_seed(self.trainer.seed))

    def _fit_fold(self, fold: int, train_dataset, valid_dataset):
        return self.trainer.fit_predict(
            self.model, train_dataset, valid_dataset, self.loss_func, self.activation_fn,
            self.save_path, fold, self.target_scaler, self.collator,
            use_infonce=self.using_infonce, use_ct=self.using_ct, use_weight=self.use_weight,
            fds_state=self.fds_state, fds_bucket=self.fds_bucket, fds_kernel=self.fds_kernel,
            fds_start_update=self.model.fds_cfg.start_update if self.fds_state is not None else 0,
            stateful_loss=self.stateful_loss, frozen=self.frozen,
        )

    def run(self):
        logger.info("start training the MM-DTI model")
        y_train = np.asarray(self.data_train["target"])
        y_valid = np.asarray(self.data_test["target"])
        y_pred = self._fit_fold(0, MolDataset(self.features_train, y_train),
                                MolDataset(self.features_test, y_valid))
        self._log_fold_metric(0, y_valid, y_pred)
        self.cv["pred"] = y_pred
        return y_pred

    def run_cv(self, splits):
        """K-fold cross-validation over the training data: ``splits`` is a
        list of (train indices, validation indices) (MolTrain._cv_splits).
        Each fold starts from the same initial weights, copied back into
        the model's own parameter tensors (a CUDA graph of the last fold
        holds their addresses), with fresh FDS and loss state, and writes
        model_{fold}.ckpt.  Returns the out-of-fold predictions in dataset
        order: each row predicted once, by the model that did not see it."""
        y_all = np.asarray(self.data_train["target"])
        feats = self.features_train
        initial = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        oof = None
        self.fold_seconds = []
        for fold, (tr_idx, va_idx) in enumerate(splits):
            t0 = time.perf_counter()
            with torch.no_grad():
                for k, v in self.model.state_dict().items():
                    v.copy_(initial[k])
            y_pred = self._fit_fold(fold, MolDataset([feats[i] for i in tr_idx], y_all[tr_idx]),
                                    MolDataset([feats[i] for i in va_idx], y_all[va_idx]))
            if oof is None:
                oof = np.zeros((len(y_all),) + y_pred.shape[1:], dtype=y_pred.dtype)
            oof[np.asarray(va_idx)] = y_pred
            self.fold_seconds.append(time.perf_counter() - t0)
            self._log_fold_metric(fold, y_all[va_idx], y_pred)
        self._log_fold_metric("cv (out-of-fold)", y_all, oof)
        self.cv["pred"] = oof
        return oof

    def _log_fold_metric(self, fold, y_true, y_pred) -> None:
        scaler = self.target_scaler
        if scaler is not None and scaler.scaler is not None:
            y_true, y_pred = scaler.inverse_transform(y_true), scaler.inverse_transform(y_pred)
        score = self.trainer.metrics.cal_metric(y_true, y_pred,
                                                label_cnt=self.data_train.get("multiclass_cnt"))
        logger.info("fold %s, result %s", fold, score)

    def evaluate(self, trainer: Optional[Trainer] = None,
                 checkpoints_path: Optional[str] = None):
        """Best-checkpoint predictions on the test features; a CV
        experiment (config model_folds > 1) averages every fold's."""
        logger.info("start predicting with the MM-DTI model")
        trainer = trainer or self.trainer
        dataset = MolDataset(self.features_test, np.asarray(self.data_test["target"]))
        # bulk predict sweeps the dataset resident on the device when the
        # feed engages (the fit loop's rule); every fold's checkpoint loads
        # into the same parameters, so one sweep serves them all
        device_data = None
        if trainer.feed_engaged(self.collator, dataset):
            device_data = trainer.build_eval_device_data(
                self.model, dataset, self.collator, self.loss_func, self.activation_fn)
        fold_preds = []
        for fold in range(max(1, self.model_folds)):
            load_weights(self.model, checkpoints_path, fold)
            y_pred, _, _ = trainer.predict(self.model, dataset, self.activation_fn,
                                           self.target_scaler, self.collator,
                                           loss_fn=self.loss_func, skip_metrics=True,
                                           device_data=device_data)
            fold_preds.append(y_pred)
        y_pred = np.mean(np.stack(fold_preds), axis=0) if len(fold_preds) > 1 else fold_preds[0]
        self.cv["test_pred"] = y_pred
        return y_pred
