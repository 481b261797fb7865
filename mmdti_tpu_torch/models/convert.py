"""Weight bridge between the JAX package's flax params and this package's
state dict.

The port's module attributes carry the flax scope names, so the bridge is a
rule, not a table:

  flax path                       state-dict key
  a/b/c/kernel  [in, out]    <->  a.b.c.weight  [out, in]  (transposed)
  a/b/embedding [V, E]       <->  a.b.weight    [V, E]
  a/b/scale     [E]          <->  a.b.weight    [E]        (LayerNorm)
  a/b/<other>                <->  a.b.<other>               (bias, means, ...)

This defines the port's names for every flax scope, including the ones the
JAX converter has no unicore/HF names for: ``cross_modal_module.*``,
``infonce.*`` and ``classification_head.*`` are their flax paths joined
with dots.  Arrays are numpy on the flax side and torch tensors on the
port's side; values are copied exactly.  The same rule carries optax's Adam
moments (trees shaped like the params) into train/optim.py's AdamState.

Pretrained ingestion (port of the JAX package's convert.py, reference:
a Uni-Mol unicore ``.pt`` loaded with strict=False and an HF ChemBERTa):
``convert_unimol_checkpoint`` and ``convert_hf_roberta`` map those
checkpoints' torch state dicts onto the port's state dict.  unicore and HF
Linear weights are [out, in] like the port's, so they land untransposed;
missing and shape-mismatched entries are skipped with a log line, and a
checkpoint of which nothing lands raises.  ``load_pretrained`` reads the
files (models/hf_weights.py, without transformers) and converts them.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mmdti_tpu_torch.models.hf_weights import read_hf_state_dict, read_unicore_checkpoint
from mmdti_tpu_torch.train.optim import AdamState

logger = logging.getLogger("mmdti_tpu_torch")

# flax nn.Embed scopes: their "weight" is an embedding table, not a kernel
EMBEDDING_SCOPES = frozenset(
    {"embed_tokens", "word_embeddings", "position_embeddings", "token_type_embeddings",
     "gas_embed", "pressure_embed", "temperature_embed"}
)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def flax_path(key: str, ndim: int):
    """The flax path (a list of names) of the port's state-dict ``key``
    naming a tensor of ``ndim`` dimensions, by the bridge rule."""
    *scope, name = key.split(".")
    if name == "weight":
        if scope and scope[-1] in EMBEDDING_SCOPES:
            name = "embedding"
        elif ndim == 1:
            name = "scale"
        else:
            name = "kernel"
    return [*scope, name]


def flax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax ``params``) -> port state dict (fp32)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)
        *scope, name = path
        if name == "kernel":
            arr, name = arr.T, "weight"
        elif name in ("embedding", "scale"):
            name = "weight"
        sd[".".join([*scope, name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def adam_state_from_optax(mu: Mapping[str, Any], nu: Mapping[str, Any], count: int,
                          schedule_count: int, mu_dtype=torch.bfloat16) -> AdamState:
    """optax's ScaleByAdamState (``mu`` and ``nu`` as nested dicts of arrays
    shaped like the flax params, ``count``) and the schedule's count ->
    train/optim.py's AdamState under the port's parameter names, with mu
    stored in ``mu_dtype``."""
    return AdamState(
        count=int(count),
        mu={k: v.to(mu_dtype) for k, v in flax_params_to_state_dict(mu).items()},
        nu=flax_params_to_state_dict(nu),
        schedule_count=int(schedule_count),
    )


def state_dict_to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of flax_params_to_state_dict: port state dict -> nested dict
    of numpy arrays with the flax leaf names."""
    params: Dict[str, Any] = {}
    for key, val in state_dict.items():
        *scope, name = flax_path(key, val.dim())
        arr = val.detach().cpu().float().numpy()
        if name == "kernel":
            arr = arr.T
        node = params
        for s in scope:
            node = node.setdefault(s, {})
        node[name] = np.ascontiguousarray(arr)
    return params


# ---- pretrained ingestion ---------------------------------------------------------

def _t(x) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy) as an fp32 CPU tensor."""
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(torch.float32)


def _assign(sd: Dict[str, torch.Tensor], key: str, value: torch.Tensor, stats) -> None:
    if key not in sd:
        stats["missing"].append(key)
        return
    if tuple(sd[key].shape) != tuple(value.shape):
        stats["shape"].append(f"{key}: {tuple(sd[key].shape)} vs {tuple(value.shape)}")
        return
    sd[key] = value.to(sd[key].dtype)
    stats["loaded"] += 1


def _weight_bias(sd, key, src, name, stats) -> None:
    """``name``.weight and .bias of a torch Linear or LayerNorm onto the
    port's ``key``.weight and .bias (both [out, in] for a Linear)."""
    for leaf in ("weight", "bias"):
        if f"{name}.{leaf}" in src:
            _assign(sd, f"{key}.{leaf}", _t(src[f"{name}.{leaf}"]), stats)


def _ln_fp32(sd, key, src, name, stats) -> None:
    # LayerNormFP32 nests its LayerNorm under 'ln'
    _weight_bias(sd, key + ".ln", src, name, stats)


def _new_stats():
    return {"loaded": 0, "missing": [], "shape": []}


def _log_stats(what: str, stats) -> None:
    logger.info("%s checkpoint: %d tensors loaded, %d missing, %d shape-mismatched", what,
                stats["loaded"], len(stats["missing"]), len(stats["shape"]))
    for m in stats["shape"][:5]:
        logger.info("  shape mismatch: %s", m)


def convert_unimol_checkpoint(state_dict: Mapping[str, Any], sd: Dict[str, torch.Tensor],
                              stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Map a Uni-Mol unicore checkpoint (its ``model`` state dict, names
    under ``unimat.``) onto the port's state dict ``sd`` (embed_tokens,
    gbf, gbf_proj, encoder, classification_head), in place; returns
    ``sd``.  The layer count is the checkpoint's; pretraining heads are
    skipped.  ``stats`` (a dict) receives the loaded count and the missing
    and shape-mismatched names."""
    src = state_dict.get("model", state_dict)
    src = {k.replace("unimat.", ""): v for k, v in src.items()}
    st = _new_stats() if stats is None else stats
    st.update(_new_stats())

    if "embed_tokens.weight" in src:
        _assign(sd, "embed_tokens.weight", _t(src["embed_tokens.weight"]), st)
    for name in ("means", "stds"):
        if f"gbf.{name}.weight" in src:
            _assign(sd, f"gbf.{name}", _t(src[f"gbf.{name}.weight"]).reshape(-1), st)
    for name in ("mul", "bias"):
        if f"gbf.{name}.weight" in src:
            _assign(sd, f"gbf.{name}", _t(src[f"gbf.{name}.weight"]), st)
    _weight_bias(sd, "gbf_proj.linear1", src, "gbf_proj.linear1", st)
    _weight_bias(sd, "gbf_proj.linear2", src, "gbf_proj.linear2", st)

    _ln_fp32(sd, "encoder.emb_layer_norm", src, "encoder.emb_layer_norm", st)
    _ln_fp32(sd, "encoder.final_layer_norm", src, "encoder.final_layer_norm", st)
    n_layers = 0
    while f"encoder.layers.{n_layers}.fc1.weight" in src:
        n_layers += 1
    for i in range(n_layers):
        p, t = f"encoder.layers_{i}", f"encoder.layers.{i}"
        _weight_bias(sd, f"{p}.in_proj", src, f"{t}.self_attn.in_proj", st)
        _weight_bias(sd, f"{p}.out_proj", src, f"{t}.self_attn.out_proj", st)
        _ln_fp32(sd, f"{p}.self_attn_layer_norm", src, f"{t}.self_attn_layer_norm", st)
        _ln_fp32(sd, f"{p}.final_layer_norm", src, f"{t}.final_layer_norm", st)
        _weight_bias(sd, f"{p}.fc1", src, f"{t}.fc1", st)
        _weight_bias(sd, f"{p}.fc2", src, f"{t}.fc2", st)

    _weight_bias(sd, "classification_head.dense", src, "classification_head.dense", st)
    _weight_bias(sd, "classification_head.out_proj", src, "classification_head.out_proj", st)
    _log_stats("Uni-Mol", st)
    # strict=False tolerates a partial overlap (the pretraining heads), but
    # a checkpoint of which nothing lands means the name map does not fit
    # it: the model would train from scratch unnoticed
    if src and st["loaded"] == 0:
        raise ValueError(
            "Uni-Mol checkpoint ingestion loaded 0 tensors out of "
            f"{len(src)} checkpoint entries — the name map does not match this "
            f"checkpoint (sample keys: {sorted(src)[:5]}). Refusing to silently train "
            "from scratch.")
    return sd


def convert_hf_roberta(state_dict: Mapping[str, Any], sd: Dict[str, torch.Tensor],
                       prefix: str = "bert", stats: Optional[dict] = None
                       ) -> Dict[str, torch.Tensor]:
    """Map an HF RoBERTa/ChemBERTa state dict (names under ``roberta.`` or
    none) onto the ChemBerta module ``prefix`` of the port's state dict
    ``sd``, in place; returns ``sd``.  ``stats`` as in
    convert_unimol_checkpoint."""
    src = {k.removeprefix("roberta."): v for k, v in state_dict.items()}
    st = _new_stats() if stats is None else stats
    st.update(_new_stats())

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        if f"embeddings.{name}.weight" in src:
            _assign(sd, f"{prefix}.embeddings.{name}.weight",
                    _t(src[f"embeddings.{name}.weight"]), st)
    _weight_bias(sd, f"{prefix}.embeddings.LayerNorm", src, "embeddings.LayerNorm", st)
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in src:
        p, t = f"{prefix}.layer_{i}", f"encoder.layer.{i}"
        _weight_bias(sd, f"{p}.attn_query", src, f"{t}.attention.self.query", st)
        _weight_bias(sd, f"{p}.attn_key", src, f"{t}.attention.self.key", st)
        _weight_bias(sd, f"{p}.attn_value", src, f"{t}.attention.self.value", st)
        _weight_bias(sd, f"{p}.attn_output", src, f"{t}.attention.output.dense", st)
        _weight_bias(sd, f"{p}.attn_LayerNorm", src, f"{t}.attention.output.LayerNorm", st)
        _weight_bias(sd, f"{p}.intermediate", src, f"{t}.intermediate.dense", st)
        _weight_bias(sd, f"{p}.output", src, f"{t}.output.dense", st)
        _weight_bias(sd, f"{p}.output_LayerNorm", src, f"{t}.output.LayerNorm", st)
        i += 1
    _log_stats("ChemBERTa", st)
    # the same loud failure: every tensor skipped (e.g. the checkpoint's
    # hidden_size differs from the built model's) discards the weights
    if src and st["loaded"] == 0:
        sample = sorted(st["shape"])[:5] or sorted(src)[:5]
        raise ValueError(
            "ChemBERTa checkpoint ingestion loaded 0 tensors out of "
            f"{len(src)} checkpoint entries — dims or names do not match the "
            f"built model (sample: {sample}). Pass matching "
            "chemberta_overrides (or rely on the config.json auto-read) "
            "instead of silently training from scratch.")
    return sd


HF_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "hidden_act", "hidden_dropout_prob",
    "attention_probs_dropout_prob", "max_position_embeddings",
    "type_vocab_size", "layer_norm_eps", "pad_token_id",
)


def hf_chemberta_overrides(chemberta_dir: str) -> Dict[str, Any]:
    """ChemBertaConfig fields read from an HF checkpoint's config.json (none
    when it is missing or unreadable), so that the built model has the
    checkpoint's dims; a caller's explicit chemberta_overrides go on top."""
    path = os.path.join(chemberta_dir, "config.json")
    if not os.path.isfile(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            hf = json.load(f)
    except (OSError, ValueError) as e:
        logger.info("Unreadable HF config.json at %s (%s); using defaults.", path, e)
        return {}
    return {k: hf[k] for k in HF_CONFIG_KEYS if k in hf}


def chemberta_overrides(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """The ChemBERTa dims a model is built with: the config.json fields of
    ``cfg["chemberta_dir"]`` (where it is a directory) under the explicit
    ``cfg["chemberta_overrides"]``.  Training and serving merge them the
    same way, so a checkpoint restores onto the same shapes."""
    overrides = dict(cfg.get("chemberta_overrides") or {})
    cb_dir = cfg.get("chemberta_dir", "") or ""
    if cb_dir and os.path.isdir(cb_dir):
        overrides = {**hf_chemberta_overrides(cb_dir), **overrides}
    return overrides


def load_pretrained(sd: Dict[str, torch.Tensor], unimol_dir: Optional[str] = None,
                    chemberta_dir: Optional[str] = None,
                    stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The Uni-Mol checkpoint file ``unimol_dir`` and the HF model dir
    ``chemberta_dir``, where they exist (a path that does not is logged
    and skipped, as in the JAX package), converted into the port's state
    dict ``sd`` (in place; returned).  A ``chemberta_dir`` without a
    weights file raises (models/hf_weights.py).  ``stats`` (a dict)
    receives each converter's counts under "unimol" and "chemberta"."""
    if unimol_dir and os.path.exists(unimol_dir):
        logger.info("Loading Uni-Mol pretrained weights from %s", unimol_dir)
        st = {}
        convert_unimol_checkpoint(read_unicore_checkpoint(unimol_dir), sd, stats=st)
        if stats is not None:
            stats["unimol"] = st
    elif unimol_dir:
        logger.warning("unimol_dir %s does not exist: no Uni-Mol weights loaded", unimol_dir)
    if chemberta_dir and os.path.isdir(chemberta_dir):
        logger.info("Loading ChemBERTa pretrained weights from %s", chemberta_dir)
        st = {}
        convert_hf_roberta(read_hf_state_dict(chemberta_dir), sd, stats=st)
        if stats is not None:
            stats["chemberta"] = st
    elif chemberta_dir:
        logger.warning("chemberta_dir %s is not a directory: no ChemBERTa weights loaded",
                       chemberta_dir)
    return sd
