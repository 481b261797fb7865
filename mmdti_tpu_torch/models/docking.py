"""Uni-Mol binding-pose docking (Zhou et al., "Uni-Mol: A Universal 3D
Molecular Representation Learning Framework", ICLR 2023; the published
``unimol/models/docking_pose.py`` DockingPoseModel and
``unimol/losses/docking_pose.py``).

  ligand atoms  --mol_model-->    x_m [B,Nm,E], last logits P_m [B,H,Nm,Nm]
  pocket atoms  --pocket_model--> x_p [B,Np,E], last logits P_p [B,H,Np,Np]
  complex: x = [x_m ; x_p], bias A [B,H,Nc,Nc] with P_m and P_p on the
  diagonal, zero cross blocks, -inf at every padded key (Nc = Nm + Np)
  concat_decoder (a Uni-Mol encoder of ``decoder_layers`` layers) run
  ``recycling`` times with the same weights, each round on the previous
  round's tokens and logits
  heads on the last round's logits P (with -inf set to 0) and tokens x:
    cross_distance_project [C_ij ; x_i ; x_j] -> elu + 1   [B,Nm,Np]
      with C_ij = (P[i, Nm+j] + P[Nm+j, i]) / 2
    holo_distance_project  [P_ij ; x_i] -> (y + y^T) / 2   [B,Nm,Nm]

The two encoders are the 3D stream of the other models
(models/mm_model.py build_3d_stream / unimol_3d_stream: embed_tokens, the
Gaussian pair kernel and its projection, the pair-bias encoder), each over
its own dictionary and with its own weights; the decoder is the same
UniMolEncoder, fed the assembled complex instead of a gbf bias.  Module
names follow the published model (mol_model.*, pocket_model.*,
concat_decoder.*, cross_distance_project.*, holo_distance_project.*) with
the port's flax-style names inside (``mol_model.encoder.layers_3.in_proj``).

The model returns ``logits`` = [cross | holo] as one [B, Nm, Np + Nm]
tensor, so the train step's ``loss_fn(logits, labels)`` contract holds with
labels the matching targets (losses/zoo.py docking_pose_loss).

Departures from the published code, none of which changes a value the
loss reads:

* the loss's boolean indexing is a masked mean (the same value, and a
  fixed shape that a CUDA graph can hold); a batch with no kept entry
  reads 0 for that term where the published mean of nothing is NaN;
* the decoder's ``final_head_layer_norm`` is not built: the published
  model never reads it (it gets no gradient there either, hence its
  ``--find-unused-parameters``);
* -inf logits are set to 0 before both heads (the published code zeroes
  them in the cross pairs only; the holo head reads the ligand block,
  whose -inf entries are padded keys the loss masks out).

Each encoder's last logits now have a consumer, so every pair-bias
backward of a docking step takes a logits gradient.  Section marks
(train/profiler.py DOCKING_MARKS): ``unimol`` opens the ligand stream,
``pocket`` the pocket stream, ``decoder`` the assembly and the rounds,
``dock_head`` the heads; their backward marks fire where the backward
reaches each section's outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
from mmdti_tpu_torch.models.layers import (
    Dense,
    LayerNormFP32,
    NonLinearHead,
    get_activation_fn,
    tensor_parallel,
)
from mmdti_tpu_torch.models.mm_model import ShardedModel, build_3d_stream, unimol_3d_stream
from mmdti_tpu_torch.models.unimol import UniMolEncoder, torch_dtype
from mmdti_tpu_torch.train.profiler import mark, mark_backward, mark_backward_joint


class StreamModel(nn.Module):
    """One entity's 3D stream over its own dictionary (the ligand's or the
    pocket's): embed_tokens, gbf, gbf_proj and encoder."""

    def __init__(self, ucfg: UniMolEncoderConfig, vocab_size: int, pad_idx: int, dtype,
                 use_kernels: bool):
        super().__init__()
        self.unimol_cfg = ucfg
        self.atom_vocab_size = vocab_size
        self.atom_pad_idx = pad_idx
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        build_3d_stream(self, ucfg, vocab_size, dtype, use_kernels)


class DistanceHead(nn.Module):
    """The published DistanceHead: Linear, activation, LayerNorm, Linear to
    one value a pair, symmetrised as (y + y^T) / 2."""

    def __init__(self, features: int, activation_fn: str = "relu", dtype=torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.act = get_activation_fn(activation_fn)
        self.dense = Dense(features, features, dtype)
        self.layer_norm = LayerNormFP32(features, use_kernels=use_kernels)
        self.out_proj = Dense(features, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,N,N,F] -> [B,N,N] float32."""
        y = self.out_proj(self.layer_norm(self.act(self.dense(x)))).squeeze(-1).float()
        return (y + y.transpose(-1, -2)) * 0.5


class DockingPoseModel(ShardedModel, nn.Module):
    def __init__(
        self,
        mol_cfg: UniMolEncoderConfig,
        pocket_cfg: Optional[UniMolEncoderConfig] = None,
        decoder_layers: int = 4,
        recycling: int = 3,
        atom_vocab_size: int = 35,
        atom_pad_idx: int = 1,
        pocket_vocab_size: int = 10,
        pocket_pad_idx: int = 1,
        dtype=torch.float32,
        use_kernels: bool = True,
        model_group=None,
    ):
        init_kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        super().__init__()
        if tensor_parallel(model_group) is not None:
            raise ValueError("the docking model runs without tensor parallelism (mesh (d, 1))")
        if recycling < 1:
            raise ValueError(f"recycling must be at least 1, got {recycling}")
        self._init_kwargs = init_kwargs
        pocket_cfg = pocket_cfg or mol_cfg
        if (pocket_cfg.embed_dim, pocket_cfg.attention_heads) != (mol_cfg.embed_dim,
                                                                  mol_cfg.attention_heads):
            raise ValueError("the ligand and pocket encoders must share their width and heads")
        self.recycling = int(recycling)
        self.compute_dtype = dtype
        self.mol_model = StreamModel(mol_cfg, atom_vocab_size, atom_pad_idx, dtype, use_kernels)
        self.pocket_model = StreamModel(pocket_cfg, pocket_vocab_size, pocket_pad_idx, dtype,
                                        use_kernels)
        # the decoder: the mol encoder's widths and dropouts over 4 layers,
        # with no delta-pair head norm (the published one is never read)
        self.decoder_cfg = dataclasses.replace(mol_cfg, encoder_layers=int(decoder_layers),
                                               delta_pair_repr_norm_loss=-1.0)
        self.concat_decoder = UniMolEncoder(self.decoder_cfg, dtype, use_kernels)
        E, H = mol_cfg.embed_dim, mol_cfg.attention_heads
        self.cross_distance_project = NonLinearHead(2 * E + H, 1, "relu", dtype=dtype)
        self.holo_distance_project = DistanceHead(E + H, "relu", dtype, use_kernels)

    # -- the complex ------------------------------------------------------------

    @staticmethod
    def assemble(p_m: torch.Tensor, p_p: torch.Tensor, padding_mask: torch.Tensor):
        """[B,H,Nc,Nc] bias: P_m and P_p on the diagonal, zero cross blocks,
        -inf at every padded key (``padding_mask`` [B,Nc], True at pads)."""
        Nm, Np = p_m.shape[-1], p_p.shape[-1]
        top = F.pad(p_m, (0, Np))
        bottom = F.pad(p_p.to(p_m.dtype), (Nm, 0))
        bias = torch.cat([top, bottom], dim=-2)
        return bias.masked_fill(padding_mask[:, None, None, :], float("-inf"))

    def heads(self, x: torch.Tensor, logits: torch.Tensor, Nm: int):
        """(cross [B,Nm,Np], holo [B,Nm,Nm]) float32 from the last round's
        tokens x [B,Nc,E] and logits [B,H,Nc,Nc]."""
        dt = self.compute_dtype
        p = logits.masked_fill(torch.isneginf(logits), 0.0)
        Np = p.shape[-1] - Nm
        cross = (p[:, :, :Nm, Nm:] + p[:, :, Nm:, :Nm].transpose(-1, -2)) * 0.5
        x = x.to(dt)
        x_m, x_p = x[:, :Nm], x[:, Nm:]
        B, E = x.shape[0], x.shape[-1]
        cross_in = torch.cat([cross.permute(0, 2, 3, 1).to(dt),
                              x_m[:, :, None, :].expand(B, Nm, Np, E),
                              x_p[:, None, :, :].expand(B, Nm, Np, E)], dim=-1)
        cross_pred = F.elu(self.cross_distance_project(cross_in).squeeze(-1).float()) + 1.0
        holo_in = torch.cat([p[:, :, :Nm, :Nm].permute(0, 2, 3, 1).to(dt),
                             x_m[:, :, None, :].expand(B, Nm, Nm, E)], dim=-1)
        return cross_pred, self.holo_distance_project(holo_in)

    def forward(
        self,
        src_tokens: torch.Tensor,                          # [B,Nm] ligand tokens
        src_distance: Optional[torch.Tensor] = None,       # [B,Nm,Nm] fp32
        src_edge_type: Optional[torch.Tensor] = None,      # [B,Nm,Nm] int
        pocket_src_tokens: Optional[torch.Tensor] = None,  # [B,Np] pocket tokens
        pocket_src_coord: Optional[torch.Tensor] = None,   # [B,Np,3] fp32
        outputs: str = "all",
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        src_coord: Optional[torch.Tensor] = None,          # [B,Nm,3] fp32
        fds_state=None, net_target=None, epoch=0.0, fds_bucket=(0.0, 1.0), gather_rows=None,
    ) -> Dict[str, Any]:
        """MMModel.forward's contract (``outputs`` "all", "train" or
        "logits"; dropout from ``generator``): ``logits`` is [cross | holo]
        [B, Nm, Np + Nm] float32; "train" adds ``pooled`` (the masked mean
        of the last round's complex tokens), ``cls_repr`` (the ligand's BOS
        token) and a zero ``infonce_loss``; "all" adds the two predictions
        apart and the last round's tokens and logits.  The FDS and
        ``gather_rows`` arguments are taken for the train step's sake and
        not read."""
        if outputs not in ("all", "train", "logits"):
            raise ValueError(f"outputs must be 'all', 'train' or 'logits', got {outputs!r}")
        if pocket_src_tokens is None or pocket_src_coord is None:
            raise ValueError("DockingPoseModel requires pocket_src_tokens and pocket_src_coord")
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False needs a generator for the dropout masks")
        mol, mol_pad, _ = unimol_3d_stream(self.mol_model, src_tokens, src_distance,
                                           src_edge_type, src_coord, pair_outputs="logits",
                                           generator=generator)
        x_m, p_m = mark_backward_joint("unimol_bwd", mol["rep"], mol["pair_logits"])
        # the pocket's distances and edge types are always built here, on
        # the device, from its coordinates (ops/pair_feats.py)
        pkt, pkt_pad, _ = unimol_3d_stream(self.pocket_model, pocket_src_tokens, None, None,
                                           pocket_src_coord, pair_outputs="logits",
                                           generator=generator, mark_name="pocket")
        x_p, p_p = mark_backward_joint("pocket_bwd", pkt["rep"], pkt["pair_logits"])
        mark("decoder", src_tokens)
        Nm = src_tokens.shape[1]
        padding_mask = torch.cat([mol_pad, pkt_pad], dim=1)
        x = torch.cat([x_m, x_p.to(x_m.dtype)], dim=1)
        bias = self.assemble(p_m, p_p, padding_mask)
        for _ in range(self.recycling):
            dec = self.concat_decoder(x, bias, padding_mask, pair_outputs="logits",
                                      generator=generator)
            x, bias = dec["rep"], dec["pair_logits"]
        x, bias = mark_backward_joint("decoder_bwd", x, bias)
        mark("dock_head", src_tokens)
        cross, holo = self.heads(x, bias, Nm)
        logits = mark_backward(torch.cat([cross, holo], dim=-1), "dock_head_bwd")
        if outputs == "logits":
            return {"logits": logits}
        real = (~padding_mask)[..., None].float()
        pooled = (x.float() * real).sum(dim=1) / real.sum(dim=1).clamp_min(1.0)
        out = {"logits": logits, "pooled": pooled,
               "infonce_loss": torch.zeros((), dtype=torch.float32, device=logits.device),
               "cls_repr": x[:, 0, :]}
        if outputs == "train":
            return out
        return {**out, "cross_distance": cross, "holo_distance": holo, "decoder_rep": x,
                "decoder_pair_logits": bias, "padding_mask": padding_mask}


def build_docking_model(
    atom_vocab_size: int,
    atom_pad_idx: int,
    pocket_vocab_size: int,
    pocket_pad_idx: int,
    compute_dtype: str = "float32",
    use_kernels: bool = True,
    unimol_overrides: Optional[dict] = None,
    pocket_overrides: Optional[dict] = None,
    decoder_layers: int = 4,
    recycling: int = 3,
    model_group=None,
) -> DockingPoseModel:
    """The docking model of data_type='docking': ``unimol_overrides`` set
    the ligand encoder (and the decoder's widths and dropouts),
    ``pocket_overrides`` the pocket encoder's (the ligand's by default)."""
    mol_cfg = UniMolEncoderConfig(**(unimol_overrides or {}))
    pocket_cfg = (dataclasses.replace(mol_cfg, **pocket_overrides) if pocket_overrides
                  else mol_cfg)
    return DockingPoseModel(
        mol_cfg=mol_cfg, pocket_cfg=pocket_cfg, decoder_layers=decoder_layers,
        recycling=recycling, atom_vocab_size=atom_vocab_size, atom_pad_idx=atom_pad_idx,
        pocket_vocab_size=pocket_vocab_size, pocket_pad_idx=pocket_pad_idx,
        dtype=torch_dtype(compute_dtype), use_kernels=use_kernels, model_group=model_group)
