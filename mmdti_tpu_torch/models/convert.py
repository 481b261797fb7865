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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mmdti_tpu_torch.train.optim import AdamState

# flax nn.Embed scopes: their "weight" is an embedding table, not a kernel
EMBEDDING_SCOPES = frozenset(
    {"embed_tokens", "word_embeddings", "position_embeddings", "token_type_embeddings"}
)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


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
        *scope, name = key.split(".")
        arr = val.detach().cpu().float().numpy()
        if name == "weight":
            if scope and scope[-1] in EMBEDDING_SCOPES:
                name = "embedding"
            elif arr.ndim == 1:
                name = "scale"
            else:
                arr, name = arr.T, "kernel"
        node = params
        for s in scope:
            node = node.setdefault(s, {})
        node[name] = np.ascontiguousarray(arr)
    return params
