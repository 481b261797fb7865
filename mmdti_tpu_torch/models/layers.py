"""Shared building blocks (port of mmdti_tpu/models/layers.py).

Parameters are fp32; a module built with ``dtype=torch.bfloat16`` casts its
input and weights to bf16 for the product, as flax's ``nn.Dense(dtype=...)``
does.  LayerNorm always computes in fp32.

Dropout is explicit, as in flax: every forward that drops takes a
``generator`` (a ``torch.Generator`` on the tensors' device), and None means
deterministic.  ``nn.Dropout`` takes no generator, so ``dropout`` below
draws its own mask (``draw_keep``, then ``apply_keep``); ``draw_seed``
draws the int32 seed of one attention call's keep mask (ops/dropout.py).

Under tensor parallelism (a ModelGroup of parallel/mesh.py with more than
one shard) a column-parallel product is a Dense of this shard's output
features behind ``group.copy`` of its input, and a row-parallel one a
``RowParallelDense``; a mask over a sharded activation is drawn whole and
sliced (``draw_keep(..., columns=)``), so every shard drops what one
process drops.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmdti_tpu_torch.ops.hopper_ln import layer_norm_fused, layer_norm_plain, ln_kernel_enabled

ACT2FN = {
    # exact (erf) gelu: unicore's TransformerEncoderLayer and HF BERT/RoBERTa
    "gelu": F.gelu,
    # tanh-approximated gelu: the Uni-Mol encoder's default in the JAX package
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
    "linear": lambda x: x,
}


def draw_keep(generator: Optional[torch.Generator], rate: float, shape,
              device, columns: Optional[Tuple[int, int]] = None) -> Optional[torch.Tensor]:
    """The keep mask ``dropout`` draws for a tensor of ``shape`` (bool,
    True with probability 1 - rate), or None when nothing drops; with
    ``columns`` (start, stop) the mask is drawn whole and those columns of
    its last axis kept (a tensor-parallel shard's)."""
    if generator is None or rate <= 0.0:
        return None
    keep = torch.rand(shape, generator=generator, device=device) >= rate
    return keep if columns is None else keep[..., columns[0]:columns[1]].contiguous()


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Zero ``x`` where ``keep`` is False and scale the rest by 1/(1 - rate);
    the identity when ``keep`` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate and scale the kept
    values by 1/(1 - rate); the identity when ``generator`` is None."""
    return apply_keep(x, draw_keep(generator, rate, x.shape, x.device), rate)


def draw_seed(generator: Optional[torch.Generator], rate: float) -> Optional[torch.Tensor]:
    """One int32 seed on the generator's device for an attention call's
    dropout, or None when that call does not drop."""
    if generator is None or rate <= 0.0:
        return None
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def get_activation_fn(name: str) -> Callable:
    if name not in ACT2FN:
        raise ValueError(f"Unknown activation {name}")
    return ACT2FN[name]


class Dense(nn.Linear):
    """nn.Linear computing in ``dtype`` (fp32 parameters, cast per call);
    the counterpart of flax ``nn.Dense(dtype=...)``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def tensor_parallel(group):
    """``group`` when it shards (a ModelGroup of more than one shard), else
    None: a layer then runs as without one."""
    return group if group is not None and group.size > 1 else None


class RowParallelDense(Dense):
    """The row-parallel product of tensor parallelism: the weight holds
    this shard's ``in_features`` input columns; every shard's partial
    product (in ``dtype``) is summed in fp32 over ``group`` (its backward
    is the identity), the whole bias added once, and the sum cast to
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, group=None):
        super().__init__(in_features, out_features, dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        return (self.group.reduce(partial) + self.bias.float()).to(dt)


def row_dense(in_features: int, out_features: int, dtype, group) -> Dense:
    """A Dense, or under tensor parallelism (``group``) a RowParallelDense
    of this shard's in_features / size input columns."""
    if group is None:
        return Dense(in_features, out_features, dtype)
    return RowParallelDense(in_features // group.size, out_features, dtype, group)


# tables up to this many rows take the one-hot backward below; past it the
# [tokens, rows] one-hot would outgrow the gradient it replaces
ONE_HOT_BACKWARD_ROWS = 1024


class _OneHotBackwardEmbedding(torch.autograd.Function):
    """A table lookup whose weight gradient is one GEMM, one-hot(ids)^T @
    grad, instead of PyTorch's scatter of the rows: on the card that
    scatter sums a row's contributions in an order that varies from call
    to call once a batch has more than 3,072 indices (MOF's 16 x 528
    atoms), so eager steps, and a CUDA graph against them, would not
    repeat bit for bit.  The forward is the plain gather."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[1]:
            return None, None
        (ids,) = ctx.saved_tensors
        one_hot = F.one_hot(ids.reshape(-1), ctx.rows).to(grad.dtype)        # [T, V]
        return None, one_hot.t() @ grad.reshape(-1, grad.shape[-1])


class Embed(nn.Embedding):
    """nn.Embedding whose lookup is returned in ``dtype`` (flax nn.Embed).
    A table of at most ONE_HOT_BACKWARD_ROWS rows takes its gradient by a
    one-hot GEMM, which repeats bit for bit (_OneHotBackwardEmbedding)."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32):
        super().__init__(num_embeddings, features)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.num_embeddings <= ONE_HOT_BACKWARD_ROWS:
            out = _OneHotBackwardEmbedding.apply(ids.long(), self.weight)
        else:
            out = super().forward(ids.long())
        return out.to(self.compute_dtype)


class FusedLN(nn.Module):
    """fp32 LayerNorm with the fast variance of the JAX package:
    var = max(E[x^2] - E[x]^2, 0), epsilon inside the rsqrt.  A module
    built with ``use_kernels`` runs ops/hopper_ln.py's kernels where
    ``ln_kernel_enabled`` holds for its input (a supported shape; on a CUDA
    tensor unless MMDTI_PALLAS_LN=0, elsewhere only under MMDTI_PALLAS_LN=1;
    read at every call) and the plain formula otherwise."""

    def __init__(self, features: int, epsilon: float = 1e-5, use_kernels: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.use_kernels = use_kernels
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        if ln_kernel_enabled(self.use_kernels, x.shape, x.device):
            return layer_norm_fused(x, self.weight, self.bias, self.epsilon, out_dtype)
        return layer_norm_plain(x, self.weight, self.bias, self.epsilon, out_dtype)


class LayerNormFP32(nn.Module):
    """LayerNorm computed in fp32 regardless of the compute dtype, cast back
    (holds its parameters under ``ln`` like the flax module)."""

    def __init__(self, features: int, epsilon: float = 1e-5, use_kernels: bool = False):
        super().__init__()
        self.ln = FusedLN(features, epsilon, use_kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x, out_dtype=x.dtype)


class NonLinearHead(nn.Module):
    """Two-layer MLP head (reference: models/mm_model.py:86-128).  With a
    sharding ``group`` its output is column-parallel: linear2 holds this
    shard's out_dim / size outputs behind ``group.copy``."""

    def __init__(self, in_dim: int, out_dim: int, activation_fn: str = "gelu",
                 hidden: Optional[int] = None, dtype=torch.float32, group=None):
        super().__init__()
        hidden = hidden or in_dim
        self.act = get_activation_fn(activation_fn)
        self.group = tensor_parallel(group)
        self.linear1 = Dense(in_dim, hidden, dtype)
        self.linear2 = Dense(hidden, out_dim // (self.group.size if self.group else 1), dtype)

    def forward(self, x):
        h = self.act(self.linear1(x))
        return self.linear2(h if self.group is None else self.group.copy(h))


class ClassificationHead(nn.Module):
    """dropout -> dense -> act -> dropout -> out_proj (reference:
    models/mm_model.py:44-84)."""

    def __init__(self, input_dim: int, inner_dim: int, num_classes: int,
                 activation_fn: str = "tanh", dtype=torch.float32,
                 pooler_dropout: float = 0.0):
        super().__init__()
        self.act = get_activation_fn(activation_fn)
        self.pooler_dropout = pooler_dropout
        self.dense = Dense(input_dim, inner_dim, dtype)
        self.out_proj = Dense(inner_dim, num_classes, dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.act(self.dense(dropout(x, self.pooler_dropout, generator)))
        return self.out_proj(dropout(x, self.pooler_dropout, generator))


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter the way the flax modules initialise theirs:
    N(0, 0.02) for Dense kernels and embeddings, zero biases, unit
    LayerNorm scales (the Gaussian layer initialises its own tables)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, FusedLN):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif m is not module and hasattr(m, "reset_parameters_like_flax"):
            m.reset_parameters_like_flax(generator)
