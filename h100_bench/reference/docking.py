"""The plain reference of the docking configuration: Uni-Mol binding-pose
prediction (Zhou et al., ICLR 2023; the published DockingPoseModel and its
docking_pose loss) with plain Adam over it.

A ligand encoder and a pocket encoder, each a Uni-Mol encoder over its own
dictionary with its own Gaussian pair kernel, return their tokens after
the final LayerNorm and their last layer's logits (-inf at padded keys).
The complex stacks the tokens and builds the bias with the two logits on
its diagonal, zero cross blocks and -inf at every padded key; a 4-layer
Uni-Mol encoder runs over it ``recycling`` times with the same weights,
each round on the previous round's tokens and logits.  With the last
logits P (-inf set to 0) and tokens x, the cross head reads
[(P[i, Nm+j] + P[Nm+j, i]) / 2 ; x_i ; x_j] through Linear, ReLU, Linear
and elu + 1, the holo head [P[i, j] ; x_i] through Linear, ReLU,
LayerNorm, Linear and (y + y^T) / 2.  The loss is the MSE of the cross
distances whose target is not 0 and under the threshold plus the smooth
L1 (beta 1) of the holo distances whose target is not 0, each over the
entries it keeps (boolean indexing, as the published loss).

Plain PyTorch in float32 with TF32 off (reference/numerics.py; the control
computes every product in fp8), on a dict of parameters under the
program's names (``mol_model.encoder.layers_3.in_proj.weight``); the
encoder layers, the Gaussian kernel, LayerNorm and the dropout draws are
reference/model.py's.  Dropout draws in the order the forward meets them:
the ligand encoder, the pocket encoder, then the decoder's rounds.
Nothing here imports the measured package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.model import Draws, Reference, dropout, layer_norm
from h100_bench.reference.numerics import Numerics, no_tf32
from h100_bench.reference.train import lr_at

STREAMS = (("mol_model.", "atom_vocab", "atom_pad_idx", "unimol"),
           ("pocket_model.", "pocket_vocab", "pocket_pad_idx", "pocket"))


def decoder_cfg(cfg: dict) -> dict:
    """The decoder's encoder settings: the ligand encoder's, at the
    configuration's decoder depth."""
    return {**cfg["unimol"], "encoder_layers": cfg["decoder"]["encoder_layers"]}


def _sub(P: Dict[str, torch.Tensor], prefix: str, rename: str = "") -> Dict[str, torch.Tensor]:
    """The entries of ``P`` under ``prefix``, renamed to ``rename`` + the
    rest (the same tensors)."""
    return {rename + k[len(prefix):]: v for k, v in P.items() if k.startswith(prefix)}


class DockingReference:
    def __init__(self, cfg: dict, nm: Numerics = None):
        self.cfg = cfg
        self.nm = nm or Numerics()
        self.streams = {prefix: Reference({"model": "molecule", "atom_vocab": cfg[vocab],
                                           "atom_pad_idx": cfg[pad], "unimol": cfg[key]},
                                          self.nm)
                        for prefix, vocab, pad, key in STREAMS}
        self.decoder = Reference({"model": "molecule", "unimol": decoder_cfg(cfg)}, self.nm)

    @staticmethod
    def _encode(ref: Reference, P, x, bias, pad, draws: Draws):
        """emb LayerNorm, dropout, pad masking, the layers, the final
        LayerNorm: (tokens, last logits)."""
        u = ref.u
        x = layer_norm(x, P["encoder.emb_layer_norm.ln.weight"],
                       P["encoder.emb_layer_norm.ln.bias"], 1e-5)
        x = dropout(x, u["emb_dropout"], draws)
        x = x * (~pad)[..., None].float()
        for i in range(u["encoder_layers"]):
            seed = draws.seed(u["attention_dropout"])
            keep_attn = draws.keep(u["dropout"], x.shape, x.device)
            keep_out = draws.keep(u["dropout"], x.shape, x.device)
            args = (i, P, x, bias, seed, keep_attn, keep_out)
            if torch.is_grad_enabled():
                x, bias = checkpoint(ref._encoder_layer, *args, use_reentrant=False)
            else:
                x, bias = ref._encoder_layer(*args)
        return layer_norm(x, P["encoder.final_layer_norm.ln.weight"],
                          P["encoder.final_layer_norm.ln.bias"], 1e-5), bias

    def stream(self, P, prefix: str, tokens, coord, draws: Draws):
        ref = self.streams[prefix]
        S = _sub(P, prefix)
        if ref.u["activation_dropout"] > 0:
            raise NotImplementedError("activation dropout is not in the reference")
        bias = ref.pair_bias(S, tokens, coord)
        x = S["embed_tokens.weight"][tokens.long()]
        return self._encode(ref, S, x, bias, tokens == ref.cfg["atom_pad_idx"], draws)

    def forward(self, P, batch: Dict[str, torch.Tensor], draws: Draws):
        """(cross [B, Nm, Np], holo [B, Nm, Nm])."""
        cfg, nm = self.cfg, self.nm
        lig, pkt = batch["src_tokens"], batch["pocket_src_tokens"]
        x_m, p_m = self.stream(P, "mol_model.", lig, batch["src_coord"], draws)
        x_p, p_p = self.stream(P, "pocket_model.", pkt, batch["pocket_src_coord"], draws)
        Nm, Np = lig.shape[1], pkt.shape[1]
        B, H = p_m.shape[:2]
        pad = torch.cat([lig == cfg["atom_pad_idx"], pkt == cfg["pocket_pad_idx"]], dim=1)
        bias = torch.zeros((B, H, Nm + Np, Nm + Np), device=p_m.device)
        bias = torch.cat([torch.cat([p_m, bias[:, :, :Nm, Nm:]], dim=-1),
                          torch.cat([bias[:, :, Nm:, :Nm], p_p], dim=-1)], dim=-2)
        bias = bias.masked_fill(pad[:, None, None, :], float("-inf"))
        x = torch.cat([x_m, x_p], dim=1)
        D = _sub(P, "concat_decoder.", "encoder.")
        for _ in range(cfg["recycling"]):
            x, bias = self._encode(self.decoder, D, x, bias, pad, draws)
        p = torch.where(torch.isneginf(bias), torch.zeros((), device=bias.device), bias)
        p = p.permute(0, 2, 3, 1)                                   # [B, Nc, Nc, H]
        cross = (p[:, :Nm, Nm:] + p[:, Nm:, :Nm].transpose(1, 2)) / 2.0
        xm, xp = x[:, :Nm], x[:, Nm:]
        cross_in = torch.cat([cross, xm[:, :, None, :].expand(-1, -1, Np, -1),
                              xp[:, None, :, :].expand(-1, Nm, -1, -1)], dim=-1)
        c = "cross_distance_project."
        h = F.relu(nm.linear(cross_in, P[c + "linear1.weight"], P[c + "linear1.bias"]))
        y = nm.linear(h, P[c + "linear2.weight"], P[c + "linear2.bias"]).squeeze(-1)
        cross_pred = F.elu(y) + 1.0
        holo_in = torch.cat([p[:, :Nm, :Nm], xm[:, :, None, :].expand(-1, -1, Nm, -1)], dim=-1)
        d = "holo_distance_project."
        h = F.relu(nm.linear(holo_in, P[d + "dense.weight"], P[d + "dense.bias"]))
        h = layer_norm(h, P[d + "layer_norm.ln.weight"], P[d + "layer_norm.ln.bias"], 1e-5)
        y = nm.linear(h, P[d + "out_proj.weight"], P[d + "out_proj.bias"]).squeeze(-1)
        return cross_pred, (y + y.transpose(1, 2)) / 2.0


def docking_loss(cross, holo, cross_target, holo_target, dist_threshold: float):
    """The published docking_pose loss, by boolean indexing."""
    keep = (cross_target != 0) & (cross_target < dist_threshold)
    loss = F.mse_loss(cross[keep].float(), cross_target[keep].float(), reduction="mean")
    keep = holo_target != 0
    return loss + F.smooth_l1_loss(holo[keep].float(), holo_target[keep].float(),
                                   reduction="mean", beta=1.0)


def train_loss(ref: DockingReference, P, batch, labels, draws: Draws):
    """The loss of one batch; ``labels`` [B, Nm, Np + Nm] are the cross and
    holo targets side by side."""
    cross, holo = ref.forward(P, batch, draws)
    Np = cross.shape[-1]
    return docking_loss(cross, holo, labels[..., :Np], labels[..., Np:],
                        ref.cfg["dist_threshold"])


# ---- parameters ---------------------------------------------------------------

def _stream_specs(prefix: str, u: dict, V: int, layers: int, with_pair: bool):
    E, F_, K, H = u["embed_dim"], u["ffn_embed_dim"], u["gaussian_kernels"], u["attention_heads"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def dense(name, din, dout):
        out.append((prefix + name + ".weight", (dout, din), "normal"))
        out.append((prefix + name + ".bias", (dout,), "zeros"))

    def ln(name, d):
        out.append((prefix + name + ".weight", (d,), "ones"))
        out.append((prefix + name + ".bias", (d,), "zeros"))

    enc = "encoder." if with_pair else ""
    if with_pair:
        out.append((prefix + "embed_tokens.weight", (V, E), "normal"))
        out += [(prefix + "gbf.means", (K,), "uniform3"),
                (prefix + "gbf.stds", (K,), "uniform3"),
                (prefix + "gbf.mul", (V * V, 1), "ones"),
                (prefix + "gbf.bias", (V * V, 1), "zeros")]
        dense("gbf_proj.linear1", K, K)
        dense("gbf_proj.linear2", K, H)
    ln(enc + "emb_layer_norm.ln", E)
    for i in range(layers):
        p = f"{enc}layers_{i}."
        ln(p + "self_attn_layer_norm.ln", E)
        dense(p + "in_proj", E, 3 * E)
        dense(p + "out_proj", E, E)
        ln(p + "final_layer_norm.ln", E)
        dense(p + "fc1", E, F_)
        dense(p + "fc2", F_, E)
    ln(enc + "final_layer_norm.ln", E)
    return out


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, initializer) of every parameter in the program's
    order, with reference/model.py's initializers."""
    out = []
    for prefix, vocab, _, key in STREAMS:
        u = cfg[key]
        out += _stream_specs(prefix, u, len(cfg[vocab]), u["encoder_layers"], True)
    u = cfg["unimol"]
    out += _stream_specs("concat_decoder.", u, 0, cfg["decoder"]["encoder_layers"], False)
    E, H = u["embed_dim"], u["attention_heads"]
    for name, din, dout in (("cross_distance_project.linear1", 2 * E + H, 2 * E + H),
                            ("cross_distance_project.linear2", 2 * E + H, 1),
                            ("holo_distance_project.dense", E + H, E + H)):
        out += [(name + ".weight", (dout, din), "normal"), (name + ".bias", (dout,), "zeros")]
    out += [("holo_distance_project.layer_norm.ln.weight", (E + H,), "ones"),
            ("holo_distance_project.layer_norm.ln.bias", (E + H,), "zeros"),
            ("holo_distance_project.out_proj.weight", (1, E + H), "normal"),
            ("holo_distance_project.out_proj.bias", (1,), "zeros")]
    return out


def make_weights(cfg: dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``generator`` on its device, in two large
    calls (the normal entries, then the uniform ones), float32."""
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


# ---- the steps ------------------------------------------------------------------

@no_tf32()
def follow(cfg: dict, mix: dict, weights: Dict[str, torch.Tensor], batches: List[tuple],
           dropout_seed: int, frozen=(), precision: str = "float32",
           half_batch: bool = False) -> dict:
    """reference/train.py follow's readings (losses, first gradients,
    change norms) over ``batches`` for the docking model: the same Adam
    (bfloat16 first moment, the mix's ``betas``, eps 1e-6, global-norm
    clip, the warmup and decay schedule); ``precision`` "fp8" is the control and ``half_batch``
    leaves the second half of every batch out."""
    opt = mix["optimizer"]
    dev = next(iter(weights.values())).device
    ref = DockingReference(cfg, Numerics(precision))
    frozen = set(frozen)
    P = {k: v.detach().clone().float().requires_grad_(k not in frozen) for k, v in weights.items()}
    names = [k for k in P if k not in frozen]
    m = {k: torch.zeros_like(P[k], dtype=torch.bfloat16) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(dropout_seed)
    draws = Draws(gen)
    (b1, b2), eps = opt["betas"], 1e-6
    losses, first = [], None
    for step, (feats, labels) in enumerate(batches):
        if half_batch:
            half = labels.shape[0] // 2
            feats = {k: t[:half] for k, t in feats.items()}
            labels = labels[:half]
        loss = train_loss(ref, P, feats, labels, draws)
        grads = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(P[k]) if g is None else g.float() for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 0:
                first = {k: g.clone() for k, g in zip(names, grads)}
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < opt["max_norm"], torch.ones_like(norm),
                                opt["max_norm"] / norm)
            grads = [g * scale for g in grads]
            count = step + 1
            lr = lr_at(opt, step)
            for k, g in zip(names, grads):
                mu = (1 - b1) * g + m[k] * torch.tensor(b1, dtype=torch.bfloat16)
                m[k].copy_(mu)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                u = (mu / (1 - b1 ** count)) / (torch.sqrt(v[k] / (1 - b2 ** count)) + eps)
                P[k].sub_(lr * u)
    with torch.no_grad():
        change = {k: float(torch.linalg.norm(P[k] - weights[k].float())) for k in names}
    return {"losses": losses, "grads": first, "change_norms": change}


# ---- the reference's own featurization --------------------------------------------

def pocket_tokens(cfg: dict, symbols, coords, max_atoms: int, pad: int):
    """(tokens [pad] int64, coordinates [pad, 3] float32, kept coordinates
    [p, 3] float64) of a raw pocket: the ``max_atoms`` atoms nearest the
    mean of its coordinates, in their order; BOS, the atoms' indices in the
    pocket dictionary ([UNK] for others), EOS; coordinates centred on the
    kept atoms with zero BOS and EOS rows; padded."""
    vocab = cfg["pocket_vocab"]
    symbols = list(symbols)
    xyz = np.asarray(coords, np.float64)
    if len(symbols) > max_atoms:
        dist = np.sqrt(((xyz - xyz.mean(axis=0)) ** 2).sum(axis=1))
        keep = sorted(np.argsort(dist, kind="stable")[:max_atoms].tolist())
        symbols, xyz = [symbols[i] for i in keep], xyz[keep]
    unk = vocab.index("[UNK]")
    n = len(symbols) + 2
    tokens = np.full(pad, cfg["pocket_pad_idx"], np.int64)
    tokens[:n] = [vocab.index("[CLS]"), *(vocab.index(s) if s in vocab else unk
                                          for s in symbols), vocab.index("[SEP]")]
    out = np.zeros((pad, 3), np.float32)
    out[1:n - 1] = xyz - xyz.mean(axis=0)
    return tokens, out, xyz


def complex_batch(cfg: dict, mix: dict, data: dict, rows) -> tuple:
    """(features, labels) of complexes ``rows`` of a dock_traffic set: the
    ligands as generated, the pockets by the reference's own crop, and the
    labels [b, Nm, Np + Nm]: holo-pose distances to the kept pocket atoms
    and among the holo atoms, zero on BOS, EOS and pads."""
    Nm, Np = mix["atom_pad"], mix["pocket_pad"]
    rows = list(rows)
    toks, crds = [], []
    labels = np.zeros((len(rows), Nm, Np + Nm), np.float32)
    for i, r in enumerate(rows):
        t, c, kept = pocket_tokens(cfg, data["pocket_symbols"][r], data["pocket_coord"][r],
                                   mix["max_pocket_atoms"], Np)
        toks.append(t)
        crds.append(c)
        n = int(data["n_atoms"][r]) - 2
        holo = data["holo"][r, 1:n + 1].astype(np.float64)
        labels[i, 1:n + 1, 1:len(kept) + 1] = np.sqrt(
            ((holo[:, None, :] - kept[None, :, :]) ** 2).sum(-1))
        labels[i, 1:n + 1, Np + 1:Np + n + 1] = np.sqrt(
            ((holo[:, None, :] - holo[None, :, :]) ** 2).sum(-1))
    feats = {"src_tokens": data["src_tokens"][rows], "src_coord": data["src_coord"][rows],
             "pocket_src_tokens": np.stack(toks), "pocket_src_coord": np.stack(crds)}
    return feats, labels
