"""One rank of the two-process gloo group of tests/test_torch_dp.py (not a
test module itself): ``python tests/torch_dp_worker.py RANK RENDEZVOUS SPEC``.

It joins the group through parallel/mesh.py::initialize_distributed at
RENDEZVOUS (a ``file://`` URL: the ranks meet through a file, so no port
has to stay free between its choice and its use), with collectives that
wait at most GROUP_TIMEOUT_S, and,
as the spec (JSON) asks, takes the global-batch gradient of one step,
draws dropout masks for rows that are the same on both ranks, checks the
batch-size rounding and the mesh checks of a Trainer under a group, and
runs MolTrain fits (each spec fit: its kwargs, CSVs and, optionally, the
initial weights to start from), recording every file this process opens
for writing under the experiment dirs.  It writes what it found to the
spec's ``out`` path (``{rank}`` filled in) as JSON.  It imports neither
JAX nor the JAX package; torch runs on one thread.
"""

import functools
import json
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mmdti_tpu_torch.models.mm_model as port_mm  # noqa: E402
import mmdti_tpu_torch.train.nnmodel as port_nnmodel  # noqa: E402
from mmdti_tpu_torch.parallel.mesh import (  # noqa: E402
    DataGroup,
    initialize_distributed,
    rank_seed,
)

WRITES = []
# a rank whose peer stopped raises after this long instead of torch's default
GROUP_TIMEOUT_S = 300


def _audit(root):
    """Record every path under ``root`` this process opens to write."""
    def hook(event, args):
        if event == "open" and isinstance(args[0], str) and args[0].startswith(root):
            mode, flags = args[1] or "", args[2] or 0
            if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
                WRITES.append(os.path.relpath(args[0], root))
        elif event == "os.mkdir" and isinstance(args[0], str) and args[0].startswith(root):
            WRITES.append(os.path.relpath(args[0], root) + "/")
    sys.addaudithook(hook)


def _model(spec):
    from mmdti_tpu_torch.models.mm_model import build_model

    model = build_model(output_dim=1, atom_vocab_size=spec["vocab"], atom_pad_idx=spec["pad"],
                        smiles_vocab_size=spec["smiles_vocab"], compute_dtype="float32",
                        unimol_overrides=spec["unimol"], chemberta_overrides=spec["chemberta"])
    return model.reset_parameters_like_flax(torch.Generator().manual_seed(0))


def grad_identity(spec, group):
    """One step's flat gradient on this rank's rows of the spec's batch:
    before the average over the ranks and after it (what the optimizer
    applies)."""
    from mmdti_tpu_torch.losses.registry import resolve_loss
    from mmdti_tpu_torch.train.steps import build_train_loss

    model = _model(spec)
    batch = np.load(spec["batch"])
    feats = {k: group.local_rows(torch.from_numpy(batch[k])) for k in spec["feat_keys"]}
    labels, weights = torch.from_numpy(batch["labels"]), torch.from_numpy(batch["weights"])
    loss = build_train_loss(resolve_loss("regression", None), "regression",
                            data_group=group)
    total, metrics = loss(model, feats, labels, weights, None)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    g = torch.cat([(torch.zeros_like(p) if d is None else d).reshape(-1)
                   for p, d in zip(params, grads)])
    local = g.clone()
    group.average_(g)
    return {"loss": float(total.detach()), "infonce": float(metrics["infonce_loss"]),
            "local": local.tolist(), "averaged": g.tolist()}


def dropout_masks(spec, group):
    """Rows that are the same on both ranks, dropout on: each rank's
    generator (its own stream) draws the attention keep mask of one call
    and runs the model's forward.  Returns the masks and logits."""
    from mmdti_tpu_torch.models.layers import draw_seed
    from mmdti_tpu_torch.ops.dropout import keep_mask

    gen = torch.Generator().manual_seed(rank_seed(42, group.rank))
    seed = draw_seed(gen, 0.1)
    mask = keep_mask(seed, 0.1, 2, 4, 8, 8)
    model = _model(spec)
    batch = np.load(spec["batch"])
    row = {k: torch.from_numpy(batch[k][:1]).repeat(2, *([1] * (batch[k].ndim - 1)))
           for k in spec["feat_keys"]}
    logits = model(**row, outputs="train", deterministic=False, generator=gen)["logits"]
    return {"mask": mask.int().tolist(), "logits": logits.detach().tolist()}


def trainer_checks(group):
    """batch_size rounding under a 2-way data axis (and its warning), the
    mesh a Trainer under this group refuses, and the (1, 2) mesh it runs."""
    from mmdti_tpu_torch.train.trainer import Trainer

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("mmdti_tpu_torch").addHandler(handler)
    out = {"batch_size": Trainer(device="cpu", task="regression", batch_size=7).batch_size,
           "warnings": [r.getMessage() for r in records if r.levelno == logging.WARNING]}
    logging.getLogger("mmdti_tpu_torch").removeHandler(handler)
    try:
        Trainer(device="cpu", task="regression", mesh_shape=(1, 1))
        out["data_1"] = None
    except (ValueError, NotImplementedError) as e:
        out["data_1"] = f"{type(e).__name__}: {e}"
    # the two processes as one model row: the model axis runs
    t = Trainer(device="cpu", task="regression", mesh_shape=(1, 2))
    out["model_2"] = {"data": [t.data_group.rank, t.data_group.size],
                      "model": [t.model_group.index, t.model_group.size]}
    return out


def run_fit(fit):
    from mmdti_tpu_torch import MolTrain

    mp = []
    # InfoNCE's query dropout has no config knob; the spec may zero it
    if fit.get("infonce_dropout_off"):
        mp.append((port_mm, "InfoNCE", port_mm.InfoNCE))
        port_mm.InfoNCE = functools.partial(port_mm.InfoNCE, embed_dropout=0.0)
    if fit.get("init"):
        sd = torch.load(fit["init"], weights_only=True)
        mp.append((port_nnmodel.NNModel, "_init_params", port_nnmodel.NNModel._init_params))
        port_nnmodel.NNModel._init_params = lambda self, params: self.model.load_state_dict(sd)
    try:
        clf = MolTrain(**fit["kwargs"], device="cpu").fit(*fit["data"])
    finally:
        for obj, name, value in mp:
            setattr(obj, name, value)
    with open(os.path.join(fit["kwargs"]["save_path"], "history_0.json")) as f:
        hist = json.load(f)
    return {"cv_pred": np.asarray(clf.cv_pred, np.float64).tolist(), "hist": hist,
            "batch_size": clf.trainer.batch_size}


def main(rank: int, rendezvous: str, spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    _audit(spec["exp_root"])
    initialize_distributed(rendezvous, 2, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    group = DataGroup()
    out = {"rank": group.rank, "size": group.size, "backend": group.backend}
    if "batch" in spec:
        out["grad"] = grad_identity(spec, group)
        out["dropout"] = dropout_masks(spec, group)
    out["trainer"] = trainer_checks(group)
    out["fits"] = {name: run_fit(fit) for name, fit in spec["fits"].items()}
    out["writes"] = sorted(set(WRITES))
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
