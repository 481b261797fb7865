"""One rank of the gloo groups of tests/test_torch_tp.py (not a test
module itself): ``python tests/torch_tp_worker.py RANK WORLD RENDEZVOUS SPEC``.

It joins a group of WORLD processes through
parallel/mesh.py::initialize_distributed at RENDEZVOUS (a ``file://`` URL),
with collectives that wait at most GROUP_TIMEOUT_S, and, as the spec
(JSON) asks: takes one step's gradient of a tensor-parallel model on the
kernel path (gbf fused; the kernels' plain versions on the CPU) and
gathers it whole; checks the meshes a Trainer under the group takes; and
runs MolTrain fits (each: its kwargs with its ``mesh_shape``, CSVs and,
optionally, the initial weights), recording every file this process opens
for writing under the experiment dirs and a digest of the replicated
parameters after each fit.  It writes what it found to the spec's ``out``
path (``{rank}`` filled in) as JSON, and the gradient with torch.save.
It imports neither JAX nor the JAX package; torch runs on one thread.
"""

import functools
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mmdti_tpu_torch.models.mm_model as port_mm  # noqa: E402
import mmdti_tpu_torch.train.nnmodel as port_nnmodel  # noqa: E402
from mmdti_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed,
    load_model_state,
    make_mesh,
    mesh_groups,
    tp_rule,
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


def grad_model(spec, group=None):
    """The spec's tensor-parallel model (the kernel path at a width whose
    shards pass the gbf gate), initialized whole from seed 0."""
    from mmdti_tpu_torch.models.mm_model import build_model

    model = build_model(output_dim=1, atom_vocab_size=spec["vocab"], atom_pad_idx=spec["pad"],
                        smiles_vocab_size=spec["smiles_vocab"], compute_dtype="float32",
                        use_kernels=True, unimol_overrides=spec["grad_unimol"],
                        chemberta_overrides=spec["grad_chemberta"], model_group=group)
    return model.reset_parameters_like_flax(torch.Generator().manual_seed(0))


def step_gradient(spec, data_group, model_group):
    """One step's loss and its gradient by parameter name, gathered over
    the model group into the whole model's tensors."""
    from mmdti_tpu_torch.losses.registry import resolve_loss
    from mmdti_tpu_torch.train.steps import build_train_loss

    model = grad_model(spec, model_group)
    batch = np.load(spec["batch"])
    feats = {k: data_group.local_rows(torch.from_numpy(batch[k])) for k in spec["feat_keys"]}
    loss = build_train_loss(resolve_loss("regression", None), "regression",
                            data_group=data_group)
    total, _ = loss(model, feats, torch.from_numpy(batch["labels"]),
                    torch.from_numpy(batch["weights"]), None)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    local = {n: (torch.zeros_like(p) if g is None else g)
             for (n, p), g in zip(model.named_parameters(), grads)}
    whole = model_group.gather_state_dict(local)
    return float(total.detach()), {n: whole[n] for n in names}


def trainer_checks():
    """The mesh a Trainer under this group takes, and one it refuses."""
    from mmdti_tpu_torch.train.trainer import Trainer

    world = torch.distributed.get_world_size()
    t = Trainer(device="cpu", task="regression", mesh_shape=(1, world), batch_size=7)
    out = {"shape": t.mesh.shape, "data": [t.data_group.rank, t.data_group.size],
           "model": [t.model_group.index, t.model_group.size], "batch_size": t.batch_size}
    try:
        Trainer(device="cpu", task="regression", mesh_shape=(1, 1))
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def replicated_digest(model):
    """sha256 over the replicated parameters (every model rank must hold
    the same bytes) and over this rank's shards."""
    rep, shard = hashlib.sha256(), hashlib.sha256()
    for n, p in sorted(model.state_dict().items()):
        (shard if tp_rule(n) else rep).update(p.detach().cpu().contiguous().numpy().tobytes())
    return rep.hexdigest(), shard.hexdigest()


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
        port_nnmodel.NNModel._init_params = lambda self, params: load_model_state(self.model, sd)
    try:
        clf = MolTrain(**fit["kwargs"], device="cpu").fit(*fit["data"])
    finally:
        for obj, name, value in mp:
            setattr(obj, name, value)
    with open(os.path.join(fit["kwargs"]["save_path"], "history_0.json")) as f:
        hist = json.load(f)
    rep, shard = replicated_digest(clf.model.model)
    return {"cv_pred": np.asarray(clf.cv_pred, np.float64).tolist(), "hist": hist,
            "replicated": rep, "shards": shard}


def main(rank: int, world: int, rendezvous: str, spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    _audit(spec["exp_root"])
    initialize_distributed(rendezvous, world, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    out = {"rank": rank, "world": world}
    if spec.get("grad"):
        data_group, model_group = mesh_groups(make_mesh((1, world)))
        loss, grads = step_gradient(spec, data_group, model_group)
        out["loss"] = loss
        if rank == 0:
            torch.save(grads, spec["grad_out"])
        out["trainer"] = trainer_checks()
    out["fits"] = {name: run_fit(fit) for name, fit in spec["fits"].items()}
    out["writes"] = sorted(set(WRITES))
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
