"""The MOF model family (port of mmdti_tpu/models/mof.py).

GasModel embeds the gas (its id and its six physical attributes), EnvModel
the pressure and temperature (min-max normalized with clipping, an MLP of
both, and one binned embedding each).  MOFModel runs the Uni-Mol 3D stream
of MMModel over the crystal's atoms (models/mm_model.py build_3d_stream:
embed_tokens / gbf / gbf_proj / encoder, so the pair-bias and gbf kernels
and pretrained Uni-Mol ingestion apply unchanged), pools the atoms by a
masked mean, concatenates the gas and environment embeddings, projects
back to the encoder width (fusion_proj), optionally FDS-smooths, and feeds
the task head.  Module names are the flax scopes (gas_model.gas_embed,
env_model.project, ...), so models/convert.py moves weights by its rule.
The output dict is MMModel's, with infonce_loss a constant 0: there is no
SMILES stream, and using_infonce is refused upstream (train/nnmodel.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from mmdti_tpu_torch.configs.architectures import FDSConfig, UniMolEncoderConfig
from mmdti_tpu_torch.losses.fds import fds_smooth
from mmdti_tpu_torch.models.layers import ClassificationHead, Embed, NonLinearHead, tensor_parallel
from mmdti_tpu_torch.models.mm_model import ShardedModel, build_3d_stream, unimol_3d_stream
from mmdti_tpu_torch.models.unimol import torch_dtype
from mmdti_tpu_torch.train.profiler import mark, mark_backward


class GasModel(nn.Module):
    def __init__(self, gas_attr_input_dim: int = 6, gas_dim: int = 32,
                 gas_max_count: int = 500, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.gas_embed = Embed(gas_max_count, gas_dim, dtype)
        self.gas_attr_embed = NonLinearHead(gas_attr_input_dim, gas_dim, "relu", dtype=dtype)

    def forward(self, gas_id: torch.Tensor, gas_attr: torch.Tensor) -> torch.Tensor:
        """gas_id [B] int, gas_attr [B, A] -> [B, 2*gas_dim]."""
        emb = self.gas_embed(gas_id)
        attr = self.gas_attr_embed(gas_attr.to(self.compute_dtype))
        return torch.cat([emb, attr], dim=-1)


class EnvModel(nn.Module):
    """Pressure and temperature, each clipped to its (min, max) and scaled
    to [0, 1]; without ``min_max_key`` both ranges are (0, 1), as in the
    JAX package, so a pressure of 5 bar or a temperature of 298 K clips
    to 1."""

    def __init__(self, hidden_dim: int = 32, bins: int = 32,
                 min_max_key: Optional[Dict[str, Tuple[float, float]]] = None,
                 dtype=torch.float32):
        super().__init__()
        self.bins = bins
        self.min_max_key = min_max_key or {"pressure": (0.0, 1.0), "temperature": (0.0, 1.0)}
        self.compute_dtype = dtype
        self.project = NonLinearHead(2, hidden_dim, "relu", dtype=dtype)
        self.pressure_embed = Embed(bins, hidden_dim, dtype)
        self.temperature_embed = Embed(bins, hidden_dim, dtype)

    def _norm(self, x: torch.Tensor, key: str) -> torch.Tensor:
        lo, hi = self.min_max_key[key]
        return (x.float().clamp(lo, hi) - lo) / max(hi - lo, 1e-12)

    def _bin(self, x: torch.Tensor) -> torch.Tensor:
        return torch.floor(x * self.bins).to(torch.int64).clamp(0, self.bins - 1)

    def forward(self, pressure: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
        """pressure, temperature [B] -> [B, 3*hidden_dim]."""
        p, t = self._norm(pressure, "pressure"), self._norm(temperature, "temperature")
        proj = self.project(torch.stack([p, t], dim=-1).to(self.compute_dtype))
        return torch.cat([proj, self.pressure_embed(self._bin(p)),
                          self.temperature_embed(self._bin(t))], dim=-1)


class MOFModel(ShardedModel, nn.Module):
    def __init__(
        self,
        unimol_cfg: UniMolEncoderConfig,
        fds_cfg: Optional[FDSConfig] = None,
        output_dim: int = 1,
        atom_vocab_size: int = 35,
        atom_pad_idx: int = 1,
        task: str = "regression",
        use_fds: bool = False,
        dtype=torch.float32,
        use_kernels: bool = True,
        gas_attr_input_dim: int = 6,
        gas_dim: int = 32,
        gas_max_count: int = 500,
        env_bins: int = 32,
        env_min_max: Optional[Dict[str, Tuple[float, float]]] = None,
        model_group=None,
    ):
        init_kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        super().__init__()
        self._init_kwargs = init_kwargs
        self.model_group = tensor_parallel(model_group)
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
        build_3d_stream(self, ucfg, atom_vocab_size, dtype, use_kernels, self.model_group)
        self.gas_model = GasModel(gas_attr_input_dim, gas_dim, gas_max_count, dtype)
        self.env_model = EnvModel(gas_dim, env_bins, env_min_max, dtype)
        fused_dim = ucfg.embed_dim + 5 * gas_dim
        self.fusion_proj = NonLinearHead(fused_dim, ucfg.embed_dim, ucfg.activation_fn,
                                         dtype=dtype)
        self.classification_head = ClassificationHead(
            ucfg.embed_dim, ucfg.embed_dim, output_dim, ucfg.pooler_activation_fn, dtype,
            pooler_dropout=ucfg.pooler_dropout,
        )

    def forward(
        self,
        src_tokens: torch.Tensor,                       # [B,N] int atom tokens
        src_distance: Optional[torch.Tensor] = None,    # [B,N,N] fp32
        src_edge_type: Optional[torch.Tensor] = None,   # [B,N,N] int
        gas_id: Optional[torch.Tensor] = None,          # [B] int
        gas_attr: Optional[torch.Tensor] = None,        # [B,A] fp32
        pressure: Optional[torch.Tensor] = None,        # [B] fp32
        temperature: Optional[torch.Tensor] = None,     # [B] fp32
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
        """MMModel.forward's contract (``outputs`` "all", "train" or
        "logits"; dropout from ``generator``; FDS on a train forward) over
        the crystal and its gas and environment.  ``gather_rows`` is taken
        for the train step's sake: there is no InfoNCE to gather for."""
        if outputs not in ("all", "train", "logits"):
            raise ValueError(f"outputs must be 'all', 'train' or 'logits', got {outputs!r}")
        if gas_id is None or gas_attr is None:
            raise ValueError("MOFModel requires gas_id and gas_attr")
        if pressure is None or temperature is None:
            raise ValueError("MOFModel requires pressure and temperature")
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False needs a generator for the dropout masks")
        enc, _, atom_mask = unimol_3d_stream(
            self, src_tokens, src_distance, src_edge_type, src_coord, pair_mode="mof",
            pair_outputs=outputs == "all", generator=generator,
        )
        # the section marks (train/profiler.py): no SMILES stream here
        encoder_rep = mark_backward(enc["rep"], "unimol_bwd")     # [B,N,E]
        mark("head", src_tokens)
        m = atom_mask[..., None].float()
        pooled_atoms = (encoder_rep.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        fused = torch.cat([pooled_atoms.to(self.compute_dtype),
                           self.gas_model(gas_id, gas_attr),
                           self.env_model(pressure, temperature)], dim=-1)
        pooled = self.fusion_proj(fused).float()                  # [B,E] fp32
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
            "infonce_loss": torch.zeros((), dtype=torch.float32, device=logits.device),
            "cls_repr": encoder_rep[:, 0, :],
        }
        if outputs == "train":
            return out
        return {
            **out,
            "encoder_rep": encoder_rep,
            "atom_mask": atom_mask,
            "pair_logits": enc["pair_logits"],
            "x_norm": enc["x_norm"],
            "delta_pair_repr_norm": enc["delta_pair_repr_norm"],
        }


def build_mof_model(
    output_dim: int,
    atom_vocab_size: int,
    atom_pad_idx: int,
    task: str,
    use_fds: bool = False,
    fds_num: int = 20,
    compute_dtype: str = "float32",
    use_kernels: bool = True,
    unimol_overrides: Optional[dict] = None,
    mof_overrides: Optional[dict] = None,
    model_group=None,
) -> MOFModel:
    """The MOF model of data_type='mof' (same options as
    mmdti_tpu.models.mof.build_mof_model; ``mof_overrides`` are MOFModel's
    gas and environment options)."""
    ucfg = UniMolEncoderConfig(**(unimol_overrides or {}))
    return MOFModel(
        unimol_cfg=ucfg,
        fds_cfg=dataclasses.replace(FDSConfig(), bucket_num=fds_num, feature_dim=ucfg.embed_dim),
        output_dim=output_dim,
        atom_vocab_size=atom_vocab_size,
        atom_pad_idx=atom_pad_idx,
        task=task,
        use_fds=use_fds,
        dtype=torch_dtype(compute_dtype),
        use_kernels=use_kernels,
        model_group=model_group,
        **(mof_overrides or {}),
    )
