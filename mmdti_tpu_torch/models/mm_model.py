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

Built with a sharding ``model_group`` (parallel/mesh.py) a model holds one
model rank's shard of every transformer layer and of the gbf projection's
output heads (``TP_RULES``); InfoNCE, FDS, the heads and the embeddings
stay whole.  Its state dict is the shard's: ``mesh.load_model_state`` and
``mesh.model_state`` move between it and the whole one, and
``reset_parameters_like_flax`` draws the whole model's weights (on a
full-width twin) and keeps the shard, so every mesh starts from the same
weights.  A width the model ranks do not divide raises.
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
from mmdti_tpu_torch.models.gaussian import FusedGbfProj, GaussianLayer, NumericalEmbed
from mmdti_tpu_torch.models.layers import (
    ClassificationHead,
    Embed,
    NonLinearHead,
    init_like_flax,
    tensor_parallel,
)
from mmdti_tpu_torch.models.unimol import UniMolEncoder, torch_dtype
from mmdti_tpu_torch.ops.attention import merge_padding_into_bias
from mmdti_tpu_torch.ops.pair_feats import mof_pair_feats_from_coords, pair_feats_from_coords
from mmdti_tpu_torch.parallel.mesh import check_divisible, load_model_state
from mmdti_tpu_torch.train.profiler import mark, mark_backward

# the fused gbf kernel's gate on a shard's heads: the JAX package's
# gbf_fused_supported takes heads % 8 == 0 per shard
GBF_SHARD_HEADS = 8


class ShardedModel:
    """The model axis of MMModel and MOFModel: ``model_group`` (a ModelGroup
    of more than one shard, or None), a full-width twin built from the
    same arguments, and the flax-like initialization of the whole model,
    sharded."""

    model_group = None

    def full_width(self) -> nn.Module:
        """The same model without a model group, on the CPU."""
        return type(self)(**{**self._init_kwargs, "model_group": None})

    def reset_parameters_like_flax(self, generator: torch.Generator):
        """Random weights drawn as the flax initializers draw them (for a
        shard: the whole model's, then the shard's part)."""
        if self.model_group is None:
            init_like_flax(self, generator)
            return self
        twin = self.full_width()
        init_like_flax(twin, generator)
        load_model_state(self, twin.state_dict())
        return self


def build_3d_stream(mdl: nn.Module, ucfg: UniMolEncoderConfig, atom_vocab_size: int,
                    dtype, use_kernels: bool, group=None) -> None:
    """Attach the 3D stream's submodules to ``mdl`` under their flax names
    (embed_tokens / gbf / gbf_proj / encoder), as MMModel and MOFModel
    share them.  The Gaussian kernel on the kernel path takes the fused
    Gaussian + gbf_proj kernels; the numerical kernel and the plain path a
    gbf_proj NonLinearHead (the JAX package's unfused route).  A sharding
    ``group`` shards the encoder and gbf_proj's heads; heads or FFN
    columns it does not divide, and on the fused path a shard's heads that
    break the gbf kernel's gate, raise ValueError."""
    group = tensor_parallel(group)
    if group is not None:
        m = group.size
        check_divisible("Uni-Mol attention_heads", ucfg.attention_heads, m)
        check_divisible("Uni-Mol ffn_embed_dim", ucfg.ffn_embed_dim, m)
        local = ucfg.attention_heads // m
        if use_kernels and ucfg.kernel == "gaussian" and local % GBF_SHARD_HEADS:
            raise ValueError(
                f"tensor parallelism over {m} model ranks: the fused gbf kernel's gate (a "
                f"shard's heads a multiple of {GBF_SHARD_HEADS}, the JAX package's "
                f"gbf_fused_supported) fails at attention_heads / {m} = {local}; "
                "use_pallas=False takes the plain path")
    edge_types = atom_vocab_size * atom_vocab_size
    mdl.embed_tokens = Embed(atom_vocab_size, ucfg.embed_dim, dtype)
    if ucfg.kernel == "gaussian":
        mdl.gbf = GaussianLayer(ucfg.gaussian_kernels, edge_types)
    elif ucfg.kernel == "numerical":
        mdl.gbf = NumericalEmbed(ucfg.gaussian_kernels, edge_types, ucfg.activation_fn)
    else:
        raise ValueError(
            f"unimol kernel {ucfg.kernel!r}: expected 'gaussian' or 'numerical'")
    if use_kernels and ucfg.kernel == "gaussian":
        mdl.gbf_proj = FusedGbfProj(
            ucfg.attention_heads, ucfg.gaussian_kernels, ucfg.activation_fn,
            dtype=dtype, pair_dtype=torch_dtype(ucfg.pair_dtype), group=group,
        )
    else:
        mdl.gbf_proj = NonLinearHead(
            ucfg.gaussian_kernels, ucfg.attention_heads, ucfg.activation_fn, dtype=dtype,
            group=group,
        )
    mdl.encoder = UniMolEncoder(ucfg, dtype, use_kernels, group)


def unimol_3d_stream(mdl: nn.Module, src_tokens, src_distance, src_edge_type,
                     src_coord=None, pair_mode: str = "molecule",
                     pair_outputs: bool = True, generator=None, mark_name: str = "unimol"):
    """Token embedding, the pair bias and the Uni-Mol encoder; returns
    (encoder outputs, padding_mask, atom_mask).  ``mdl`` holds the
    submodules of build_3d_stream and atom_vocab_size, atom_pad_idx,
    compute_dtype, use_kernels and unimol_cfg.  Without the host pair
    arrays the distances and edge types are rebuilt from ``src_coord``
    (ops/pair_feats.py; ``pair_mode`` "mof" zeroes the BOS and EOS
    distances, as the MOF featurizer does).  ``pair_outputs`` and
    ``generator`` are passed on to the encoder.  The stream begins with
    the section mark ``mark_name`` (train/profiler.py; ``unimol`` unless a
    model with a second stream names another)."""
    mark(mark_name, src_tokens)
    if src_distance is None or src_edge_type is None:
        if src_coord is None:
            raise ValueError(
                "model needs either (src_distance, src_edge_type) or src_coord to "
                "derive them from")
        feats_fn = mof_pair_feats_from_coords if pair_mode == "mof" else pair_feats_from_coords
        src_distance, src_edge_type = feats_fn(src_tokens, src_coord, mdl.atom_vocab_size,
                                               mdl.atom_pad_idx)
    padding_mask = src_tokens == mdl.atom_pad_idx
    atom_mask = (~padding_mask).long()
    x = mdl.embed_tokens(src_tokens)
    pair_dtype = torch_dtype(mdl.unimol_cfg.pair_dtype)
    if isinstance(mdl.gbf_proj, FusedGbfProj):
        # fused Gaussian + gbf_proj: emits the [B,H,N,N] bias with the
        # padding merged in, in the pair dtype
        u = mdl.gbf(src_distance, src_edge_type, tokens=src_tokens, return_affine=True)
        bias = mdl.gbf_proj(u, mdl.gbf.means, mdl.gbf.stds, padding_mask)
    else:
        if isinstance(mdl.gbf, NumericalEmbed):
            feat = mdl.gbf(src_distance, src_edge_type)                     # [B,N,N,K]
        else:
            feat = mdl.gbf(src_distance, src_edge_type, tokens=src_tokens)  # [B,N,N,K]
        bias = mdl.gbf_proj(feat.to(mdl.compute_dtype))                     # [B,N,N,H]
        bias = merge_padding_into_bias(
            bias.permute(0, 3, 1, 2).float(), padding_mask, pair_dtype=pair_dtype
        )
    enc = mdl.encoder(x, bias, padding_mask, pair_outputs=pair_outputs, generator=generator)
    return enc, padding_mask, atom_mask


class MMModel(ShardedModel, nn.Module):
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
        model_group=None,
    ):
        init_kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        super().__init__()
        self._init_kwargs = init_kwargs
        self.model_group = group = tensor_parallel(model_group)
        if group is not None:
            for what, n in (("ChemBERTa num_attention_heads", chemberta_cfg.num_attention_heads),
                            ("ChemBERTa intermediate_size", chemberta_cfg.intermediate_size),
                            ("cross-modal num_attention_heads", cross_cfg.num_attention_heads),
                            ("cross-modal intermediate_size", cross_cfg.intermediate_size)):
                check_divisible(what, n, group.size)
        ucfg = unimol_cfg
        self.unimol_cfg = ucfg
        self.atom_vocab_size = atom_vocab_size
        self.atom_pad_idx = atom_pad_idx
        self.output_dim = output_dim
        self.fds_cfg = fds_cfg or FDSConfig(feature_dim=ucfg.embed_dim)
        self.task = task
        self.use_fds = use_fds
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        build_3d_stream(self, ucfg, atom_vocab_size, dtype, use_kernels, group)
        self.bert = ChemBerta(chemberta_cfg, dtype, use_kernels, group)
        self.infonce = InfoNCE(ucfg.embed_dim, dtype=dtype)
        self.cross_modal_module = CrossAttentionModel(cross_cfg, dtype, use_kernels, group)
        self.classification_head = ClassificationHead(
            cross_cfg.hidden_size, ucfg.embed_dim, output_dim,
            ucfg.pooler_activation_fn, dtype, pooler_dropout=ucfg.pooler_dropout,
        )

    def forward(
        self,
        src_tokens: torch.Tensor,                       # [B,N] int atom tokens
        src_distance: Optional[torch.Tensor] = None,    # [B,N,N] fp32
        src_edge_type: Optional[torch.Tensor] = None,   # [B,N,N] int
        input_ids: torch.Tensor = None,                 # [B,L] int SMILES tokens
        attention_mask: torch.Tensor = None,            # [B,L] {0,1}
        outputs: str = "all",
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        fds_state: Optional[Dict[str, torch.Tensor]] = None,
        net_target: Optional[torch.Tensor] = None,
        epoch=0.0,
        fds_bucket: Tuple[float, float] = (0.0, 1.0),
        src_coord: Optional[torch.Tensor] = None,       # [B,N,3] fp32 (device pair mode)
        gather_rows=None,
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
        ``fds_cfg.start_smooth``; a number, or a 0-dim float32 tensor on the
        inputs' device as the fit loop passes it, like the JAX package's
        ``epoch_f``); "pooled" stays the pre-smoothing value.
        ``gather_rows`` (a data group's, parallel/mesh.py) makes InfoNCE's
        negatives the global batch's."""
        if outputs not in ("all", "train", "logits"):
            raise ValueError(f"outputs must be 'all', 'train' or 'logits', got {outputs!r}")
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False needs a generator for the dropout masks")
        enc, padding_mask, atom_mask = unimol_3d_stream(
            self, src_tokens, src_distance, src_edge_type, src_coord,
            pair_outputs=outputs == "all", generator=generator,
        )
        # the section marks (train/profiler.py): forward and backward of
        # each encoder, then the head
        encoder_rep = mark_backward(enc["rep"], "unimol_bwd")     # [B,N,E]
        mark("smiles", input_ids)
        bert_rep = mark_backward(self.bert(input_ids, attention_mask, generator),
                                 "smiles_bwd")                    # [B,L,E]
        mark("head", input_ids)
        if outputs != "logits":
            infonce_loss = self.infonce(encoder_rep, bert_rep, generator, gather_rows)

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
    model_group=None,
) -> MMModel:
    """Assemble the flagship model from task-level options (same overrides
    and FDS options as mmdti_tpu.models.mm_model.build_model); with a
    sharding ``model_group``, one model rank's shard of it."""
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
        model_group=model_group,
    )

