"""The plain reference of the benchmark's two configurations: the MM-DTI
model (Uni-Mol 3D encoder with the Gaussian pair kernel, a RoBERTa SMILES
encoder, InfoNCE, bidirectional cross-attention, the regression head) and
the Uni-MOF model (the same 3D encoder, the gas and environment embeddings,
the fusion projection, the head), with their training loss (MSE, InfoNCE,
the ConR-style contrastive term) and plain Adam.

Plain PyTorch on a dict of parameters, under the parameter names of the
flax scopes that the published models' ports use (``encoder.layers_3.in_proj
.weight``), in float32 (reference/numerics.py; the control computes every
product in fp8).  It follows the published descriptions (Uni-Mol,
Zhou et al. 2023; MM-DTI; Uni-MOF, Wang et al. 2024) as the configuration
files state them, with these departures, each the configuration's own:

* the Gaussian kernel's pdf takes pi as 3.14159, as Uni-Mol's code does;
* LayerNorm takes its variance as E[x^2] - E[x]^2 (clamped at 0), with
  epsilon inside the square root;
* the Uni-Mol encoder is pre-LN with no delta-pair norm terms in the loss;
* InfoNCE pools its projections over every position, padding included.

Dropout follows the configurations' rates, and its masks are a pure
function of the run's dropout seed: a keep mask of a tensor is
``torch.rand(shape, generator) >= rate`` and an attention's keep mask the
counter hash below of one int32 seed drawn per attention call, all drawn in
the order the forward meets them, so that one seed gives one set of masks
(the published models draw theirs from the framework's stream; this
benchmark fixes the stream so that the reference can follow a run step by
step).  Nothing here imports the measured package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.numerics import Numerics

SQRT_2PI = (2 * 3.14159) ** 0.5
_M32 = 0xFFFFFFFF


# ---- dropout ---------------------------------------------------------------

def _mul32(x, c):
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x):
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def attention_keep(seed: torch.Tensor, rate: float, B: int, H: int, Nq: int, Nk: int,
                   heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """bool [B, h, Nq, Nk] keep mask of one attention call for heads
    [h0, h1) of H: bits(seed, b*H + h, i*Nk + j) >= rate * 2^32 with
    key = fmix32(seed ^ fmix32(bh + 0x9E3779B9)) and
    bits = fmix32(key ^ fmix32(ij + 0x7F4A7C15)), all mod 2^32."""
    dev = seed.device
    h0, h1 = heads if heads is not None else (0, H)
    seed32 = seed.to(torch.int64).reshape(()) & _M32
    cut = min(int(rate * 4294967296.0), 4294967295)
    ij = torch.arange(Nq * Nk, dtype=torch.int64, device=dev).reshape(Nq, Nk)
    fij = fmix32((ij + 0x7F4A7C15) & _M32)
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    h = torch.arange(h0, h1, dtype=torch.int64, device=dev)[None, :]
    key = fmix32(seed32 ^ fmix32((b * H + h + 0x9E3779B9) & _M32))
    return fmix32(key[:, :, None, None] ^ fij[None, None]) >= cut


class Draws:
    """The dropout draws of one forward, from one generator, in order."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def keep(self, rate: float, shape, device) -> Optional[torch.Tensor]:
        if self.generator is None or rate <= 0.0:
            return None
        return torch.rand(shape, generator=self.generator, device=device) >= rate

    def seed(self, rate: float) -> Optional[torch.Tensor]:
        if self.generator is None or rate <= 0.0:
            return None
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=self.generator,
                             device=self.generator.device, dtype=torch.int32)


def apply_keep(x, keep, rate):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate, draws: Draws):
    return apply_keep(x, draws.keep(rate, x.shape, x.device), rate)


# ---- blocks -----------------------------------------------------------------

ACT = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def layer_norm(x, w, b, eps):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def split_heads(t, H):
    B, L, E = t.shape
    return t.reshape(B, L, H, E // H).transpose(1, 2)


def merge_heads(t):
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D)


def _softmax_drop(logits, seed, rate):
    B, H, Nq, Nk = logits.shape
    probs = torch.softmax(logits, dim=-1)
    if seed is None:
        return probs
    # the mask, a few heads at a time so that its int64 work stays small
    step = max(1, (1 << 24) // max(1, B * Nq * Nk))
    keep = torch.cat([attention_keep(seed, rate, B, H, Nq, Nk, (h, min(h + step, H)))
                      for h in range(0, H, step)], dim=1)
    return torch.where(keep, probs / (1.0 - rate), torch.zeros((), device=probs.device))


class Reference:
    """One configuration's plain model over a parameter dict ``P``."""

    def __init__(self, cfg: dict, nm: Optional[Numerics] = None):
        self.cfg = cfg
        self.nm = nm or Numerics()
        self.u = cfg["unimol"]
        self.kind = cfg["model"]

    # -- the Uni-Mol 3D stream ------------------------------------------------

    def pair_bias(self, P, tokens, coord):
        """[B, H, N, N] Gaussian pair bias, -inf at padded keys, from the
        atom tokens and coordinates (distances among real atoms; for MOF
        crystals among the atoms between BOS and EOS)."""
        cfg, u, nm = self.cfg, self.u, self.nm
        pad, V = cfg["atom_pad_idx"], len(cfg["atom_vocab"])
        real = tokens != pad
        keep = real
        if self.kind == "mof":
            pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            last = real.sum(dim=1, keepdim=True) - 1
            keep = real & (pos != 0) & (pos != last)
        c = coord.float()
        diff = c[:, :, None, :] - c[:, None, :, :]
        dist = torch.sqrt((diff * diff).sum(-1))
        dist = torch.where(keep[:, :, None] & keep[:, None, :], dist,
                           torch.zeros((), device=c.device))
        t = tokens.long()
        pair = t[:, :, None] * V + t[:, None, :]
        x = P["gbf.mul"].view(-1)[pair] * dist + P["gbf.bias"].view(-1)[pair]
        std = P["gbf.stds"].abs() + 1e-5
        g = torch.exp(-0.5 * ((x[..., None] - P["gbf.means"]) / std) ** 2) / (SQRT_2PI * std)
        h = ACT[u["activation_fn"]](nm.linear(g, P["gbf_proj.linear1.weight"],
                                              P["gbf_proj.linear1.bias"]))
        o = nm.linear(h, P["gbf_proj.linear2.weight"], P["gbf_proj.linear2.bias"])
        o = o.permute(0, 3, 1, 2)
        return o.masked_fill(~real[:, None, None, :], float("-inf"))

    def _encoder_layer(self, i, P, x, bias, seed, keep_attn, keep_out):
        u, nm = self.u, self.nm
        p = f"encoder.layers_{i}."
        H = u["attention_heads"]
        residual = x
        h = layer_norm(x, P[p + "self_attn_layer_norm.ln.weight"],
                       P[p + "self_attn_layer_norm.ln.bias"], 1e-5)
        q, k, v = nm.linear(h, P[p + "in_proj.weight"], P[p + "in_proj.bias"]).chunk(3, dim=-1)
        q, k, v = split_heads(q, H), split_heads(k, H), split_heads(v, H)
        logits = nm.matmul(q * (q.shape[-1] ** -0.5), k.transpose(-1, -2)) + bias
        probs = _softmax_drop(logits, seed, u["attention_dropout"])
        attn = merge_heads(nm.matmul(probs, v))
        x = residual + apply_keep(nm.linear(attn, P[p + "out_proj.weight"], P[p + "out_proj.bias"]),
                                  keep_attn, u["dropout"])
        residual = x
        h = layer_norm(x, P[p + "final_layer_norm.ln.weight"], P[p + "final_layer_norm.ln.bias"],
                       1e-5)
        h = ACT[u["activation_fn"]](nm.linear(h, P[p + "fc1.weight"], P[p + "fc1.bias"]))
        h = nm.linear(h, P[p + "fc2.weight"], P[p + "fc2.bias"])
        return residual + apply_keep(h, keep_out, u["dropout"]), logits

    def encoder(self, P, tokens, coord, draws: Draws):
        """The Uni-Mol encoder's token representation [B, N, E]."""
        u = self.u
        if u["activation_dropout"] > 0:
            raise NotImplementedError("activation dropout is not in the reference")
        pad = self.cfg["atom_pad_idx"]
        bias = self.pair_bias(P, tokens, coord)
        x = P["embed_tokens.weight"][tokens.long()]
        x = layer_norm(x, P["encoder.emb_layer_norm.ln.weight"],
                       P["encoder.emb_layer_norm.ln.bias"], 1e-5)
        x = dropout(x, u["emb_dropout"], draws)
        x = x * (tokens != pad)[..., None].float()
        for i in range(u["encoder_layers"]):
            seed = draws.seed(u["attention_dropout"])
            keep_attn = draws.keep(u["dropout"], x.shape, x.device)
            keep_out = draws.keep(u["dropout"], x.shape, x.device)
            args = (i, P, x, bias, seed, keep_attn, keep_out)
            if torch.is_grad_enabled():
                x, bias = checkpoint(self._encoder_layer, *args, use_reentrant=False)
            else:
                x, bias = self._encoder_layer(*args)
        return layer_norm(x, P["encoder.final_layer_norm.ln.weight"],
                          P["encoder.final_layer_norm.ln.bias"], 1e-5)

    # -- MM-DTI ---------------------------------------------------------------

    def _bert_layer(self, P, p, x, kv, key_bias, heads, rate_attn, rate_hidden, act, eps,
                    draws: Draws, qkv_names):
        nm = self.nm
        qn, kn, vn = qkv_names
        q = split_heads(nm.linear(x, P[p + qn + ".weight"], P[p + qn + ".bias"]), heads)
        k = split_heads(nm.linear(kv, P[p + kn + ".weight"], P[p + kn + ".bias"]), heads)
        v = split_heads(nm.linear(kv, P[p + vn + ".weight"], P[p + vn + ".bias"]), heads)
        seed = draws.seed(rate_attn)
        logits = nm.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        logits = logits + key_bias[:, None, None, :]
        ctx = merge_heads(nm.matmul(_softmax_drop(logits, seed, rate_attn), v))
        ctx = dropout(nm.linear(ctx, P[p + "attn_output.weight"], P[p + "attn_output.bias"]),
                      rate_hidden, draws)
        a = layer_norm(ctx + x, P[p + "attn_LayerNorm.weight"], P[p + "attn_LayerNorm.bias"], eps)
        h = ACT[act](nm.linear(a, P[p + "intermediate.weight"], P[p + "intermediate.bias"]))
        h = dropout(nm.linear(h, P[p + "output.weight"], P[p + "output.bias"]), rate_hidden, draws)
        return layer_norm(h + a, P[p + "output_LayerNorm.weight"], P[p + "output_LayerNorm.bias"],
                          eps)

    def smiles_encoder(self, P, ids, mask, draws: Draws):
        c = self.cfg["chemberta"]
        pad = c["pad_token_id"]
        ids = ids.long()
        real = (ids != pad).long()
        pos = torch.cumsum(real, dim=1) * real + pad
        x = (P["bert.embeddings.word_embeddings.weight"][ids]
             + P["bert.embeddings.position_embeddings.weight"][pos]
             + P["bert.embeddings.token_type_embeddings.weight"][torch.zeros_like(ids)])
        x = layer_norm(x, P["bert.embeddings.LayerNorm.weight"],
                       P["bert.embeddings.LayerNorm.bias"], c["layer_norm_eps"])
        x = dropout(x, c["hidden_dropout_prob"], draws)
        key_bias = (1.0 - mask.float()) * torch.finfo(torch.float32).min
        for i in range(c["num_hidden_layers"]):
            x = self._bert_layer(P, f"bert.layer_{i}.", x, x, key_bias, c["num_attention_heads"],
                                 c["attention_probs_dropout_prob"], c["hidden_dropout_prob"],
                                 c["hidden_act"], c["layer_norm_eps"], draws,
                                 ("attn_query", "attn_key", "attn_value"))
        return x

    def infonce(self, P, rep3d, rep1d, draws: Draws):
        c, nm = self.cfg["infonce"], self.nm

        def proj(x, side):
            p = f"infonce.proj_{side}_"
            h = F.gelu(nm.linear(x, P[p + "fc1.weight"], P[p + "fc1.bias"]))
            return nm.linear(h, P[p + "fc2.weight"], P[p + "fc2.bias"]).mean(dim=1)

        q = proj(dropout(rep3d, c["embed_dropout"], draws), "query")
        p = proj(rep1d, "positive")
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
        p = p / (torch.linalg.norm(p, dim=-1, keepdim=True) + 1e-12)
        logits = (q @ p.t()) / c["temperature"]
        labels = torch.arange(logits.shape[0], device=logits.device)
        return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2.0

    def cross_modal(self, P, a, b, a_mask, b_mask, draws: Draws):
        x = self.cfg["crossmodal"]
        rate = x["hidden_dropout_prob"]
        a = dropout(a, rate, draws)
        b = dropout(b, rate, draws)
        outs = []
        for name, s1, s2, mask in (("graph_attention", b, a, a_mask),
                                   ("text_attention", a, b, b_mask)):
            key_bias = (1.0 - mask.float()) * -10000.0
            h = s1
            for i in range(x["num_layers"]):
                h = self._bert_layer(P, f"cross_modal_module.{name}.layer_{i}.", h, s2, key_bias,
                                     x["num_attention_heads"], x["attention_probs_dropout_prob"],
                                     rate, x["hidden_act"], x["layer_norm_eps"], draws,
                                     ("query", "key", "value"))
            outs.append(h)
        b_to_a, a_to_b = outs
        return a_to_b, b_to_a

    def head(self, P, x, draws: Draws):
        u, nm = self.u, self.nm
        r = u["pooler_dropout"]
        h = ACT[u["pooler_activation_fn"]](
            nm.linear(dropout(x, r, draws), P["classification_head.dense.weight"],
                      P["classification_head.dense.bias"]))
        return nm.linear(dropout(h, r, draws), P["classification_head.out_proj.weight"],
                         P["classification_head.out_proj.bias"])

    def _nonlinear_head(self, P, p, x, act):
        nm = self.nm
        h = ACT[act](nm.linear(x, P[p + "linear1.weight"], P[p + "linear1.bias"]))
        return nm.linear(h, P[p + "linear2.weight"], P[p + "linear2.bias"])

    def forward(self, P, batch: Dict[str, torch.Tensor], draws: Draws):
        """(logits [B, 1], pooled [B, E], infonce loss or None)."""
        tokens, coord = batch["src_tokens"], batch["src_coord"]
        atom_mask = (tokens != self.cfg["atom_pad_idx"]).float()
        rep = self.encoder(P, tokens, coord, draws)
        if self.kind == "mof":
            m = atom_mask[..., None]
            atoms = (rep * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            g = self.cfg["gas_env"]
            gas = torch.cat([P["gas_model.gas_embed.weight"][batch["gas_id"].long()],
                             self._nonlinear_head(P, "gas_model.gas_attr_embed.",
                                                  batch["gas_attr"].float(), "relu")], dim=-1)
            lo_p, hi_p = g["env_min_max"]["pressure"]
            lo_t, hi_t = g["env_min_max"]["temperature"]
            pr = (batch["pressure"].float().clamp(lo_p, hi_p) - lo_p) / max(hi_p - lo_p, 1e-12)
            te = (batch["temperature"].float().clamp(lo_t, hi_t) - lo_t) / max(hi_t - lo_t, 1e-12)
            bins = g["env_bins"]

            def binned(x):
                return torch.floor(x * bins).to(torch.int64).clamp(0, bins - 1)

            env = torch.cat([
                self._nonlinear_head(P, "env_model.project.", torch.stack([pr, te], dim=-1),
                                     "relu"),
                P["env_model.pressure_embed.weight"][binned(pr)],
                P["env_model.temperature_embed.weight"][binned(te)]], dim=-1)
            pooled = self._nonlinear_head(P, "fusion_proj.", torch.cat([atoms, gas, env], dim=-1),
                                          self.u["activation_fn"])
            return self.head(P, pooled, draws), pooled, None
        ids, mask = batch["input_ids"], batch["attention_mask"]
        rep1d = self.smiles_encoder(P, ids, mask, draws)
        infonce = self.infonce(P, rep, rep1d, draws)
        a_to_b, b_to_a = self.cross_modal(P, rep, rep1d, atom_mask, mask, draws)
        a_to_b = a_to_b * atom_mask[..., None]
        b_to_a = b_to_a * mask.float()[..., None]
        denom = atom_mask.sum(dim=1, keepdim=True) + mask.float().sum(dim=1, keepdim=True)
        pooled = torch.cat([a_to_b, b_to_a], dim=1).sum(dim=1) / denom
        return self.head(P, pooled, draws), pooled, infonce


# ---- the training loss ------------------------------------------------------

def ct_regress(feature, target, output, w=0.2, t=0.07, e=0.01):
    """The ConR-style contrastive regression term: label-distance positives
    (|dy| <= w), close-but-mispredicted negatives pushed by l_dist * e, a
    per-anchor normalized log-ratio, anchors without negatives left out;
    masked similarities enter the denominator as exp(0) = 1."""
    f = feature.reshape(feature.shape[0], -1).float()
    B = f.shape[0]
    labels = target.reshape(B, -1).float().mean(dim=1, keepdim=True)
    preds = output.reshape(B, -1).float().mean(dim=1, keepdim=True)
    l_dist = (labels - labels.t()).abs()
    p_dist = (preds - preds.t()).abs()
    qn = f / (torch.linalg.norm(f, dim=1, keepdim=True) + 1e-12)
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    close = l_dist <= w
    pos_i = (close & ~eye).float()
    neg_i = (~close & (p_dist <= w)).float()
    prod = (qn @ qn.t()) / t
    push = l_dist * e
    pos, neg = prod * pos_i, prod * neg_i
    z = torch.exp(pos).sum(dim=1) + (push * torch.exp(neg) * neg_i).sum(dim=1)
    per_pair = -(pos - torch.log(z)[:, None])
    loss = (per_pair * pos_i).sum(dim=1) / close.sum(dim=1).float().clamp_min(1.0)
    return (loss * (neg_i.sum(dim=1) > 0).float()).mean()


def train_loss(ref: Reference, P, batch, labels, draws: Draws, loss_cfg: dict):
    """alpha * MSE + beta * InfoNCE + beta * CT of one batch."""
    logits, pooled, infonce = ref.forward(P, batch, draws)
    total = loss_cfg["alpha"] * torch.mean((logits.float() - labels.float()) ** 2)
    if loss_cfg["infonce"] and infonce is not None:
        total = total + loss_cfg["beta"] * infonce
    if loss_cfg["ct"]:
        total = total + loss_cfg["beta"] * ct_regress(pooled, labels, logits, w=loss_cfg["ct_w"])
    return total


# ---- parameters ---------------------------------------------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, initializer) of every parameter, in the order the
    model declares them.  Initializers: "normal" N(0, 0.02) for dense
    kernels and embeddings, "zeros" for biases, "ones" for LayerNorm scales
    and the Gaussian kernel's multipliers, "uniform3" U(0, 3) for the
    Gaussian means and widths (Uni-Mol's init)."""
    u = cfg["unimol"]
    E, F_, K, H = u["embed_dim"], u["ffn_embed_dim"], u["gaussian_kernels"], u["attention_heads"]
    V = len(cfg["atom_vocab"])
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def dense(name, din, dout):
        out.append((name + ".weight", (dout, din), "normal"))
        out.append((name + ".bias", (dout,), "zeros"))

    def ln(name, d):
        out.append((name + ".weight", (d,), "ones"))
        out.append((name + ".bias", (d,), "zeros"))

    out.append(("embed_tokens.weight", (V, E), "normal"))
    out += [("gbf.means", (K,), "uniform3"), ("gbf.stds", (K,), "uniform3"),
            ("gbf.mul", (V * V, 1), "ones"), ("gbf.bias", (V * V, 1), "zeros")]
    dense("gbf_proj.linear1", K, K)
    dense("gbf_proj.linear2", K, H)
    ln("encoder.emb_layer_norm.ln", E)
    for i in range(u["encoder_layers"]):
        p = f"encoder.layers_{i}."
        ln(p + "self_attn_layer_norm.ln", E)
        dense(p + "in_proj", E, 3 * E)
        dense(p + "out_proj", E, E)
        ln(p + "final_layer_norm.ln", E)
        dense(p + "fc1", E, F_)
        dense(p + "fc2", F_, E)
    ln("encoder.final_layer_norm.ln", E)
    if cfg["model"] == "mof":
        g = cfg["gas_env"]
        gd = g["gas_dim"]
        out.append(("gas_model.gas_embed.weight", (g["gas_max_count"], gd), "normal"))
        dense("gas_model.gas_attr_embed.linear1", g["gas_attr_input_dim"], g["gas_attr_input_dim"])
        dense("gas_model.gas_attr_embed.linear2", g["gas_attr_input_dim"], gd)
        dense("env_model.project.linear1", 2, 2)
        dense("env_model.project.linear2", 2, gd)
        out.append(("env_model.pressure_embed.weight", (g["env_bins"], gd), "normal"))
        out.append(("env_model.temperature_embed.weight", (g["env_bins"], gd), "normal"))
        dense("fusion_proj.linear1", E + 5 * gd, E + 5 * gd)
        dense("fusion_proj.linear2", E + 5 * gd, E)
    else:
        c, x, nce = cfg["chemberta"], cfg["crossmodal"], cfg["infonce"]
        Eb, Fb = c["hidden_size"], c["intermediate_size"]
        out.append(("bert.embeddings.word_embeddings.weight", (c["vocab_size"], Eb), "normal"))
        out.append(("bert.embeddings.position_embeddings.weight",
                    (c["max_position_embeddings"], Eb), "normal"))
        out.append(("bert.embeddings.token_type_embeddings.weight",
                    (c["type_vocab_size"], Eb), "normal"))
        ln("bert.embeddings.LayerNorm", Eb)
        for i in range(c["num_hidden_layers"]):
            p = f"bert.layer_{i}."
            for n in ("attn_query", "attn_key", "attn_value", "attn_output"):
                dense(p + n, Eb, Eb)
            ln(p + "attn_LayerNorm", Eb)
            dense(p + "intermediate", Eb, Fb)
            dense(p + "output", Fb, Eb)
            ln(p + "output_LayerNorm", Eb)
        for side in ("query", "positive"):
            dense(f"infonce.proj_{side}_fc1", E, E)
            dense(f"infonce.proj_{side}_fc2", E, nce["proj_dim"])
        Ex, Fx = x["hidden_size"], x["intermediate_size"]
        for name in ("graph_attention", "text_attention"):
            for i in range(x["num_layers"]):
                p = f"cross_modal_module.{name}.layer_{i}."
                for n in ("query", "key", "value", "attn_output"):
                    dense(p + n, Ex, Ex)
                ln(p + "attn_LayerNorm", Ex)
                dense(p + "intermediate", Ex, Fx)
                dense(p + "output", Fx, Ex)
                ln(p + "output_LayerNorm", Ex)
    dense("classification_head.dense", E, E)
    dense("classification_head.out_proj", E, cfg["output_dim"])
    return out


def make_weights(cfg: dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``generator`` on its device, in two large
    calls (all the normal entries, then all the uniform ones), float32."""
    specs = param_specs(cfg)
    dev = generator.device
    sizes = {kind: sum(math.prod(s) for _, s, k in specs if k == kind)
             for kind in ("normal", "uniform3")}
    normal = torch.randn(sizes["normal"], generator=generator, device=dev) * 0.02
    uniform = torch.rand(sizes["uniform3"], generator=generator, device=dev) * 3.0
    offs = {"normal": 0, "uniform3": 0}
    out = {}
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in offs:
            src = normal if kind == "normal" else uniform
            out[name] = src[offs[kind]:offs[kind] + n].view(shape).clone()
            offs[kind] += n
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=dev)
    return out
