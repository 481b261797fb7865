"""MM-DTI flagship model (port of mmdti_tpu/models/mm_model.py).

  atom tokens --embed--> Uni-Mol encoder biased by Gaussian(distance, tokens)
  SMILES ids  --------> ChemBERTa (RoBERTa) encoder
  InfoNCE aligns the two pooled projection streams
  bidirectional BERT cross-attention fuses the token streams
  masked concat-mean pooling -> MLP head

Module attribute names follow the flax scopes (``encoder.layers_3.in_proj``
is flax ``encoder/layers_3/in_proj``), so models/convert.py moves weights
between the two by rule.  ``use_kernels=True`` routes the Gaussian pair
bias and every attention through ops/hopper_*.py (the Hopper kernels on
CUDA tensors, their plain versions on CPU tensors); ``False`` takes the
plain oracle path everywhere, the counterpart of the JAX XLA path.  Both
paths are differentiable; on the kernel path every attention and the
Gaussian bias run their own backward kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from mmdti_tpu_torch.configs.architectures import (
    ChemBertaConfig,
    CrossModalConfig,
    FDSConfig,
    UniMolEncoderConfig,
)
from mmdti_tpu_torch.losses.fds import fds_smooth
from mmdti_tpu_torch.losses.infonce import InfoNCE
from mmdti_tpu_torch.models.chemberta import ChemBerta
from mmdti_tpu_torch.models.crossmodal import CrossAttentionModel
from mmdti_tpu_torch.models.gaussian import FusedGbfProj, GaussianLayer
from mmdti_tpu_torch.models.layers import (
    ClassificationHead,
    Embed,
    NonLinearHead,
    init_like_flax,
)
from mmdti_tpu_torch.models.unimol import UniMolEncoder, torch_dtype
from mmdti_tpu_torch.ops.attention import merge_padding_into_bias


def unimol_3d_stream(mdl: "MMModel", src_tokens, src_distance, src_edge_type,
                     pair_outputs: bool = True, generator=None):
    """Token embedding, Gaussian pair bias and the Uni-Mol encoder; returns
    (encoder outputs, padding_mask, atom_mask).  ``mdl`` holds the
    submodules under their flax names (embed_tokens / gbf / gbf_proj /
    encoder); ``pair_outputs`` and ``generator`` are passed on to the
    encoder."""
    padding_mask = src_tokens == mdl.atom_pad_idx
    atom_mask = (~padding_mask).long()
    x = mdl.embed_tokens(src_tokens)
    pair_dtype = torch_dtype(mdl.unimol_cfg.pair_dtype)
    if mdl.use_kernels:
        # fused Gaussian + gbf_proj: emits the [B,H,N,N] bias with the
        # padding merged in, in the pair dtype
        u = mdl.gbf(src_distance, src_edge_type, tokens=src_tokens, return_affine=True)
        bias = mdl.gbf_proj(u, mdl.gbf.means, mdl.gbf.stds, padding_mask)
    else:
        feat = mdl.gbf(src_distance, src_edge_type, tokens=src_tokens)     # [B,N,N,K]
        bias = mdl.gbf_proj(feat.to(mdl.compute_dtype))                    # [B,N,N,H]
        bias = merge_padding_into_bias(
            bias.permute(0, 3, 1, 2).float(), padding_mask, pair_dtype=pair_dtype
        )
    enc = mdl.encoder(x, bias, padding_mask, pair_outputs=pair_outputs, generator=generator)
    return enc, padding_mask, atom_mask


class MMModel(nn.Module):
    def __init__(
        self,
        unimol_cfg: UniMolEncoderConfig,
        chemberta_cfg: ChemBertaConfig,
        cross_cfg: CrossModalConfig,
        output_dim: int = 1,
        atom_vocab_size: int = 35,
        atom_pad_idx: int = 1,
        dtype=torch.float32,
        use_kernels: bool = True,
        fds_cfg: Optional[FDSConfig] = None,
        task: str = "regression",
        use_fds: bool = False,
    ):
        super().__init__()
        if unimol_cfg.kernel != "gaussian":
            raise ValueError(
                f"unimol kernel {unimol_cfg.kernel!r} is not ported; only 'gaussian'"
            )
        ucfg = unimol_cfg
        self.unimol_cfg = ucfg
        self.atom_pad_idx = atom_pad_idx
        self.output_dim = output_dim
        self.fds_cfg = fds_cfg or FDSConfig(feature_dim=ucfg.embed_dim)
        self.task = task
        self.use_fds = use_fds
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        self.embed_tokens = Embed(atom_vocab_size, ucfg.embed_dim, dtype)
        self.gbf = GaussianLayer(ucfg.gaussian_kernels, atom_vocab_size * atom_vocab_size)
        if use_kernels:
            self.gbf_proj = FusedGbfProj(
                ucfg.attention_heads, ucfg.gaussian_kernels, ucfg.activation_fn,
                dtype=dtype, pair_dtype=torch_dtype(ucfg.pair_dtype),
            )
        else:
            self.gbf_proj = NonLinearHead(
                ucfg.gaussian_kernels, ucfg.attention_heads, ucfg.activation_fn, dtype=dtype
            )
        self.encoder = UniMolEncoder(ucfg, dtype, use_kernels)
        self.bert = ChemBerta(chemberta_cfg, dtype, use_kernels)
        self.infonce = InfoNCE(ucfg.embed_dim, dtype=dtype)
        self.cross_modal_module = CrossAttentionModel(cross_cfg, dtype, use_kernels)
        self.classification_head = ClassificationHead(
            cross_cfg.hidden_size, ucfg.embed_dim, output_dim,
            ucfg.pooler_activation_fn, dtype, pooler_dropout=ucfg.pooler_dropout,
        )

    def reset_parameters_like_flax(self, generator: torch.Generator) -> "MMModel":
        """Random weights drawn as the flax initializers draw them."""
        init_like_flax(self, generator)
        return self

    def forward(
        self,
        src_tokens: torch.Tensor,       # [B,N] int atom tokens
        src_distance: torch.Tensor,     # [B,N,N] fp32
        src_edge_type: torch.Tensor,    # [B,N,N] int
        input_ids: torch.Tensor,        # [B,L] int SMILES tokens
        attention_mask: torch.Tensor,   # [B,L] {0,1}
        outputs: str = "all",
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        fds_state: Optional[Dict[str, torch.Tensor]] = None,
        net_target: Optional[torch.Tensor] = None,
        epoch: float = 0.0,
        fds_bucket: Tuple[float, float] = (0.0, 1.0),
    ) -> Dict[str, Any]:
        """The JAX model's output dict, or the part of it a caller reads:

        * ``outputs="all"``: every entry (what the parity tests compare);
        * ``outputs="train"``: logits, pooled, infonce_loss and cls_repr —
          what the train and eval steps read; the encoder's norm terms,
          final logits and the [B,N,N,H] delta-pair tensor, which the JAX
          train step lets XLA drop, are not computed;
        * ``outputs="logits"``: the serving call, {"logits"} only (no
          InfoNCE either).

        ``deterministic=False`` applies every dropout of the JAX model,
        drawn from ``generator`` (a torch.Generator on the inputs' device);
        one generator state gives one result, bit for bit on one device.

        A regression model built with ``use_fds`` recalibrates the pooled
        features by their target's bucket before the head on a train
        forward (``deterministic=False``) that gets ``fds_state`` and
        ``net_target`` (losses/fds.py::fds_smooth, from ``epoch`` on
        ``fds_cfg.start_smooth``); "pooled" stays the pre-smoothing value."""
        if outputs not in ("all", "train", "logits"):
            raise ValueError(f"outputs must be 'all', 'train' or 'logits', got {outputs!r}")
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False needs a generator for the dropout masks")
        enc, padding_mask, atom_mask = unimol_3d_stream(
            self, src_tokens, src_distance, src_edge_type,
            pair_outputs=outputs == "all", generator=generator,
        )
        encoder_rep = enc["rep"]                                  # [B,N,E]
        bert_rep = self.bert(input_ids, attention_mask, generator)  # [B,L,E]
        if outputs != "logits":
            infonce_loss = self.infonce(encoder_rep, bert_rep, generator)

        a_to_b, b_to_a = self.cross_modal_module(
            encoder_rep, bert_rep, atom_mask, attention_mask, generator
        )
        a_to_b = a_to_b * atom_mask[..., None].to(a_to_b.dtype)
        b_to_a = b_to_a * attention_mask[..., None].to(b_to_a.dtype)
        fused = torch.cat([a_to_b, b_to_a], dim=1)                # [B, N+L, E]
        denom = (
            atom_mask.sum(dim=1, keepdim=True) + attention_mask.sum(dim=1, keepdim=True)
        ).float()
        pooled = fused.sum(dim=1).float() / denom                 # [B,E] fp32
        head_in = pooled
        if (self.use_fds and self.task == "regression" and fds_state is not None
                and net_target is not None and not deterministic):
            head_in = fds_smooth(fds_state, pooled, net_target, epoch, fds_bucket[0],
                                 fds_bucket[1], self.fds_cfg)
        logits = self.classification_head(head_in.to(self.compute_dtype), generator).float()
        if outputs == "logits":
            return {"logits": logits}
        out = {
            "logits": logits,
            "pooled": pooled,
            "infonce_loss": infonce_loss,
            "cls_repr": encoder_rep[:, 0, :],
        }
        if outputs == "train":
            return out
        return {
            **out,
            "encoder_rep": encoder_rep,
            "bert_rep": bert_rep,
            "atom_mask": atom_mask,
            "pair_logits": enc["pair_logits"],
            "x_norm": enc["x_norm"],
            "delta_pair_repr_norm": enc["delta_pair_repr_norm"],
        }


def build_model(
    output_dim: int,
    atom_vocab_size: int,
    atom_pad_idx: int,
    smiles_vocab_size: int,
    compute_dtype: str = "float32",
    use_kernels: bool = True,
    unimol_overrides: Optional[dict] = None,
    chemberta_overrides: Optional[dict] = None,
    crossmodal_overrides: Optional[dict] = None,
    task: str = "regression",
    use_fds: bool = False,
    fds_num: int = 20,
) -> MMModel:
    """Assemble the flagship model from task-level options (same overrides
    and FDS options as mmdti_tpu.models.mm_model.build_model)."""
    ucfg = UniMolEncoderConfig(**(unimol_overrides or {}))
    ccfg = ChemBertaConfig(
        **{"vocab_size": smiles_vocab_size, **(chemberta_overrides or {})}
    )
    xcfg = CrossModalConfig(
        **{"hidden_size": ucfg.embed_dim, **(crossmodal_overrides or {})}
    )
    return MMModel(
        unimol_cfg=ucfg,
        chemberta_cfg=ccfg,
        cross_cfg=xcfg,
        output_dim=output_dim,
        atom_vocab_size=atom_vocab_size,
        atom_pad_idx=atom_pad_idx,
        dtype=torch_dtype(compute_dtype),
        use_kernels=use_kernels,
        fds_cfg=dataclasses.replace(FDSConfig(), bucket_num=fds_num, feature_dim=ucfg.embed_dim),
        task=task,
        use_fds=use_fds,
    )

