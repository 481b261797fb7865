"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of a train step and of a forward, and the least time a kernel launch could
take (its roofline bound).

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16 on the tensor
cores and 3.35 TB/s of HBM3.  The kernels take bf16 operands (2 bytes an
element) on the cells' paths.

Model FLOPs count the products only (dense layers, the attention's two
products, the Gaussian kernel's two-layer projection), at each molecule's
real atoms and tokens: padding is not model work.  A train step is the
forward and a backward of twice the forward, with no recomputation.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
S = 2   # bytes of a bf16 element


def attn_block(layers: int, tokens: int, e: int, ffn: int, kv_tokens=None) -> float:
    """Forward FLOPs of ``layers`` transformer layers of width ``e`` and
    FFN ``ffn`` over ``tokens`` queries and ``kv_tokens`` keys (default the
    same): q and the output projection on the queries, k and v on the keys,
    QK^T and PV, the two FFN products."""
    kv = tokens if kv_tokens is None else kv_tokens
    qkvo = 2 * tokens * e * e + 2 * 2 * kv * e * e + 2 * tokens * e * e
    scores = 2 * tokens * kv * e * 2
    ffn_flops = 2 * 2 * tokens * e * ffn
    return layers * (qkvo + scores + ffn_flops)


def forward_flops(cfg: dict, n_atoms: int, n_tokens: int = 0) -> float:
    """Forward FLOPs of one molecule (crystal) of ``n_atoms`` atoms, BOS and
    EOS included, and ``n_tokens`` SMILES tokens."""
    u = cfg["unimol"]
    fwd = attn_block(u["encoder_layers"], n_atoms, u["embed_dim"], u["ffn_embed_dim"])
    K, H = u["gaussian_kernels"], u["attention_heads"]
    fwd += 2 * n_atoms * n_atoms * (K * K + K * H)
    if cfg["model"] == "mm_model":
        c, x = cfg["chemberta"], cfg["crossmodal"]
        fwd += attn_block(c["num_hidden_layers"], n_tokens, c["hidden_size"],
                          c["intermediate_size"])
        fwd += attn_block(x["num_layers"], n_atoms, x["hidden_size"], x["intermediate_size"],
                          kv_tokens=n_tokens)
        fwd += attn_block(x["num_layers"], n_tokens, x["hidden_size"], x["intermediate_size"],
                          kv_tokens=n_atoms)
    return float(fwd)


def train_flops(cfg: dict, n_atoms: int, n_tokens: int = 0) -> float:
    """Train FLOPs of one molecule: forward plus a backward of twice it."""
    return 3.0 * forward_flops(cfg, n_atoms, n_tokens)


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and FLOPs over the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pair_bias_fwd_bound(B, N, H, D):
    """Pair-bias attention forward: q, k, v read and the output written
    (4 B N H D), the incoming bias read and the logits written
    (2 B H N^2); QK^T and PV (4 B H N^2 D)."""
    return bound_ms(4 * B * N * H * D * S + 2 * B * H * N * N * S, 4 * B * H * N * N * D)


def pair_bias_bwd_bound(B, N, H, D, logits_grad: bool):
    """Pair-bias attention backward: q, k, v, out, dout read and dq, dk, dv
    written (7 B N H D), the logits read, the bias gradient written and,
    where the next layer's bias has a gradient, that read (2 or 3 B H N^2);
    four products (8 B H N^2 D)."""
    n_pair = 3 if logits_grad else 2
    return bound_ms(7 * B * N * H * D * S + n_pair * B * H * N * N * S, 8 * B * H * N * N * D)


def gbf_fwd_bound(B, N, K, H):
    """Fused Gaussian + projection forward over P = B N^2 pairs: the affine
    distance read (4 bytes) and H bias entries written; K x K and K x H
    products."""
    P = B * N * N
    return bound_ms(P * (4 + H * S), 2 * P * (K * K + K * H))


def gbf_bwd_bound(B, N, K, H):
    """Its backward: the affine distance read and its gradient written
    (8 bytes), the H bias gradients read; the forward's products again and
    the two gradient products of each layer."""
    P = B * N * N
    return bound_ms(P * (8 + H * S), 2 * P * (3 * K * K + 2 * K * H))
