"""InfoNCE cross-modal alignment loss (port of mmdti_tpu/losses/infonce.py).

Dropout on the query stream (with a ``generator``), per-modality 2-layer
erf-GELU MLP projections (E -> E -> 50), mean-pool over the token axis (all
positions, padding included, matching the reference), unit-normalize,
in-batch similarity matrix with diagonal positives, symmetric cross-entropy
averaged over both directions at temperature 0.1.  Under data parallelism
the two pooled projections of every rank are gathered first
(``gather_rows``), so the negatives span the global batch, as in the JAX
package's jit over global arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmdti_tpu_torch.models.layers import Dense, dropout


def info_nce_loss(query: torch.Tensor, positive: torch.Tensor,
                  temperature: float = 0.1) -> torch.Tensor:
    """query/positive: [B, D] pooled projections."""
    q = query / (torch.linalg.norm(query, dim=-1, keepdim=True) + 1e-12)
    p = positive / (torch.linalg.norm(positive, dim=-1, keepdim=True) + 1e-12)
    logits = (q @ p.t()).float()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits / temperature, labels)
            + F.cross_entropy(logits.t() / temperature, labels)) / 2.0


class InfoNCE(nn.Module):
    def __init__(self, embed_dim: int, proj_dim: int = 50, temperature: float = 0.1,
                 embed_dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.temperature = temperature
        self.embed_dropout = embed_dropout
        self.proj_query_fc1 = Dense(embed_dim, embed_dim, dtype)
        self.proj_query_fc2 = Dense(embed_dim, proj_dim, dtype)
        self.proj_positive_fc1 = Dense(embed_dim, embed_dim, dtype)
        self.proj_positive_fc2 = Dense(embed_dim, proj_dim, dtype)

    def forward(self, query_tokens, positive_tokens,
                generator: Optional[torch.Generator] = None,
                gather_rows: Optional[Callable] = None):
        """query_tokens [B,N,E] (3D-graph stream), positive_tokens [B,L,E]
        (SMILES stream) -> scalar loss; ``gather_rows`` (a data group's)
        gathers the pooled projections of every rank before the loss."""
        q = dropout(query_tokens, self.embed_dropout, generator)
        proj_q = self.proj_query_fc2(F.gelu(self.proj_query_fc1(q)))
        proj_p = self.proj_positive_fc2(F.gelu(self.proj_positive_fc1(positive_tokens)))
        q_mean, p_mean = proj_q.mean(dim=1).float(), proj_p.mean(dim=1).float()
        if gather_rows is not None:
            q_mean, p_mean = gather_rows(q_mean, p_mean)
        return info_nce_loss(q_mean, p_mean, self.temperature)
