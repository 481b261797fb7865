"""The model FLOPs of a docking train step (models/docking.py), at each
complex's real atoms: the products only (work.py's rule), BOS and EOS
included, padding left out.

A complex of ``n_atoms`` ligand tokens and ``n_pocket`` pocket tokens (each
with BOS and EOS) runs the ligand encoder and the pocket encoder with
their Gaussian kernels at their own lengths, the decoder's layers
``recycling`` times at n_atoms + n_pocket, the cross head's two products
over the n_atoms x n_pocket pairs and the holo head's over the n_atoms^2
ligand pairs; a train step is the forward and a backward of twice it.
"""

from __future__ import annotations

from h100_bench.work import attn_block


def _stream(u: dict, n: int) -> float:
    K, H = u["gaussian_kernels"], u["attention_heads"]
    return (attn_block(u["encoder_layers"], n, u["embed_dim"], u["ffn_embed_dim"])
            + 2 * n * n * (K * K + K * H))


def forward_flops(cfg: dict, n_atoms: int, n_pocket: int) -> float:
    u = cfg["unimol"]
    E, H = u["embed_dim"], u["attention_heads"]
    n_c = n_atoms + n_pocket
    fwd = _stream(u, n_atoms) + _stream(cfg["pocket"], n_pocket)
    fwd += cfg["recycling"] * attn_block(cfg["decoder"]["encoder_layers"], n_c, E,
                                         u["ffn_embed_dim"])
    c = 2 * E + H
    fwd += 2 * n_atoms * n_pocket * (c * c + c)
    h = E + H
    fwd += 2 * n_atoms * n_atoms * (h * h + h)
    return float(fwd)


def train_flops(cfg: dict, n_atoms: int, n_pocket: int) -> float:
    """Train FLOPs of one complex: forward plus a backward of twice it."""
    return 3.0 * forward_flops(cfg, n_atoms, n_pocket)
