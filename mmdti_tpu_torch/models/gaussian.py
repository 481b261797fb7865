"""Gaussian distance-kernel pair features (port of mmdti_tpu/models/gaussian.py).

Per-edge-type affine transform of the pairwise distance, expanded through K
Gaussian kernels (pdf with the reference's pi=3.14159 constant), in fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from mmdti_tpu_torch.models.layers import Dense
from mmdti_tpu_torch.ops.hopper_gbf import gaussian_pdf, gbf_pair_bias_fused


class GaussianLayer(nn.Module):
    def __init__(self, kernels: int = 128, edge_types: int = 1024):
        super().__init__()
        self.kernels = kernels
        self.edge_types = edge_types
        self.means = nn.Parameter(torch.empty(kernels))
        self.stds = nn.Parameter(torch.empty(kernels))
        self.mul = nn.Parameter(torch.ones(edge_types, 1))
        self.bias = nn.Parameter(torch.zeros(edge_types, 1))
        self.reset_parameters_like_flax(None)

    @torch.no_grad()
    def reset_parameters_like_flax(self, generator) -> None:
        self.means.uniform_(0.0, 3.0, generator=generator)
        self.stds.uniform_(0.0, 3.0, generator=generator)
        self.mul.fill_(1.0)
        self.bias.zero_()

    def forward(self, dist: torch.Tensor, edge_type: torch.Tensor,
                tokens: torch.Tensor = None, return_affine: bool = False):
        """dist [B,N,N] fp32, edge_type [B,N,N] int -> [B,N,N,K] fp32, or
        with ``return_affine=True`` the affine distance u = mul*dist + bias
        [B,N,N] (the fused kernel's input).

        With ``tokens`` [B,N] the table entry is the one of the token outer
        product t_i*V + t_j, selected as the JAX layer selects it: by two
        one-hot matmuls (exact in fp32), whose backward is two more matmuls.
        A gather's scatter-add backward serialises on the repeated entries
        (every padded pair hits the same one): on an H100 it took a quarter
        of the flagship train step's device time.  At padded rows and columns the
        token entry differs from ``edge_type``, which the collator fills
        with the pad index there.  Without ``tokens`` the entry is gathered
        by ``edge_type``."""
        V = int(round(self.edge_types ** 0.5))
        if tokens is not None and V * V == self.edge_types:
            p = torch.nn.functional.one_hot(tokens.long(), V).float()   # [B,N,V]
            pt = p.transpose(1, 2)

            def select(table):                                          # -> [B,N,N]
                return torch.matmul(torch.matmul(p, table.view(V, V).float()), pt)

            m, b = select(self.mul), select(self.bias)
        else:
            idx = edge_type.long()
            m = self.mul.view(-1)[idx].float()
            b = self.bias.view(-1)[idx].float()
        x = m * dist.float() + b                                   # [B,N,N]
        if return_affine:
            return x
        std = self.stds.float().abs() + 1e-5
        return gaussian_pdf(x[..., None], self.means.float(), std)  # [B,N,N,K]


class FusedGbfProj(nn.Module):
    """Fused twin of the gbf_proj NonLinearHead (K -> K -> H) with the same
    parameters (linear1/linear2), evaluated by ops/hopper_gbf.py: the
    [B,N,N,K] Gaussian features and hidden layer never reach device memory,
    and the output is the encoder's [B,H,N,N] bias with -inf at padded keys."""

    def __init__(self, out_dim: int, kernels: int = 128,
                 activation_fn: str = "gelu_tanh", dtype=torch.float32,
                 pair_dtype=torch.float32):
        super().__init__()
        self.activation_fn = activation_fn
        self.compute_dtype = dtype
        self.pair_dtype = pair_dtype
        self.linear1 = Dense(kernels, kernels, dtype)
        self.linear2 = Dense(kernels, out_dim, dtype)

    def forward(self, u, means, stds, padding_mask):
        return gbf_pair_bias_fused(
            u, means, stds, self.linear1.weight, self.linear1.bias,
            self.linear2.weight, self.linear2.bias, padding_mask,
            activation=self.activation_fn, pair_dtype=self.pair_dtype,
            compute_dtype=self.compute_dtype,
        )
