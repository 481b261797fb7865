"""Pair features built on the device (port of mmdti_tpu/ops/pair_feats.py).

The host featurizer writes dense [N,N] fp32 distances and int edge types
per molecule; both are functions of the [N] tokens and [N,3] coordinates.
In device mode the collator ships the padded [B,N,3] coordinates instead
(data/batching.py, ``pair_feats="device"``) and the model rebuilds the pair
arrays here, inside its forward (and so inside a CUDA graph on the card).
The semantics are the host collation's:

* distance ``||c_i - c_j||`` in fp32 over real tokens (BOS and EOS carry
  zero coordinates and are real), 0 wherever either side is a pad row;
  for MOF crystals (chem/mof.py) also 0 on the BOS and EOS rows and
  columns, EOS being the last real token of each row;
* edge type ``tok_i * V + tok_j`` over real tokens, the pad index wherever
  either side is a pad row.

These are plain torch operations, as the JAX package's are plain jnp: no
Pallas kernel stands behind them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def resolve_pair_feats_mode(value, device=None) -> str:
    """``device_pair_feats`` -> "host" | "device", the one rule NNModel and
    MolServe share.  'auto' (or None) picks "device" when ``device`` (the
    model's; None: CUDA where it is available) is a CUDA device and "host"
    on the CPU, where the host arrays are the numerics oracle; the strings
    and booleans are the JAX package's spellings, and any other raises: a
    misspelling that fell to "host" would ship the dense arrays without a
    word."""
    if value == "auto" or value is None:
        if device is None:
            on_card = torch.cuda.is_available()
        else:
            on_card = torch.device(device).type == "cuda"
        return "device" if on_card else "host"
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("device", "true", "on", "1", "yes"):
            return "device"
        if v in ("host", "false", "off", "0", "no"):
            return "host"
        raise ValueError(
            f"device_pair_feats={value!r} not understood: expected 'auto', "
            "'device'/True, or 'host'/False"
        )
    if isinstance(value, (bool, int)):
        return "device" if value else "host"
    raise ValueError(f"device_pair_feats={value!r} not understood")


def _distances(src_coord: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    coord = src_coord.float()
    diff = coord[:, :, None, :] - coord[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.where(keep[:, :, None] & keep[:, None, :], dist, torch.zeros((), device=dist.device))


def _edges(tok: torch.Tensor, real: torch.Tensor, vocab: int, pad_idx: int) -> torch.Tensor:
    edge = tok[:, :, None] * vocab + tok[:, None, :]
    return torch.where(real[:, :, None] & real[:, None, :], edge,
                       torch.full((), pad_idx, dtype=edge.dtype, device=edge.device))


def pair_feats_from_coords(src_tokens: torch.Tensor, src_coord: torch.Tensor, vocab: int,
                           pad_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src_distance [B,N,N] fp32, src_edge_type [B,N,N] int32) of tokens
    [B,N] and coordinates [B,N,3] (pad rows zero)."""
    tok = src_tokens.to(torch.int32)
    real = tok != pad_idx
    return _distances(src_coord, real), _edges(tok, real, vocab, pad_idx)


def mof_pair_feats_from_coords(src_tokens: torch.Tensor, src_coord: torch.Tensor, vocab: int,
                               pad_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MOF variant (chem/mof.py coords2unimol_mof): distances only among
    the inner crystal atoms, zero on the BOS row and column and on those of
    EOS, the last real token of each row; edge types as for molecules."""
    tok = src_tokens.to(torch.int32)
    real = tok != pad_idx
    n_real = real.sum(dim=1, keepdim=True)                       # [B,1]
    pos = torch.arange(tok.shape[1], device=tok.device)[None, :]
    inner = real & (pos != 0) & (pos != n_real - 1)
    return _distances(src_coord, inner), _edges(tok, real, vocab, pad_idx)
