"""Where the port's LayerNorm runs, decided without a card
(mmdti_tpu_torch/ops/hopper_ln.py ``ln_kernels_on`` / ``ln_kernel_enabled``):

* on a CUDA device the kernels are the default: MMDTI_PALLAS_LN unset or
  ``1`` engages them at a supported shape of a ``use_kernels`` module,
  ``0`` keeps the plain path;
* on the CPU, and where no device is given, the answer is the JAX gate's
  opt-in (tests/test_torch_ln.py holds the shape-only gate to it);
* the CUDA graphs of ``TrainPrograms`` and ``MolServe`` are keyed by the
  setting in force on their device, so flipping the variable between calls
  records a new graph where the setting changes and replays the old one
  where it does not.
"""

import numpy as np
import pytest
import torch

import mmdti_tpu_torch.train.steps as steps
from mmdti_tpu_torch.api.serve_api import MolServe
from mmdti_tpu_torch.models.layers import FusedLN
from mmdti_tpu_torch.ops import hopper_ln as hl
from tests.test_torch_marks import _model, _programs, _resident

SUPPORTED = [(32, 64, 512), (8448, 512), (2, 3, 8, 256)]
# the E=64 head LayerNorm, serving buckets with T % 8 != 0, no rows, rank 1
UNSUPPORTED = [(32, 64), (4, 6, 64), (3, 128), (1, 7, 512), (0, 128), (128,)]


def _set(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MMDTI_PALLAS_LN", raising=False)
    else:
        monkeypatch.setenv("MMDTI_PALLAS_LN", env)


@pytest.mark.parametrize("device", ["cpu", "cuda", None])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_gate_by_device_and_variable(monkeypatch, env, device):
    _set(monkeypatch, env)
    dev = None if device is None else torch.device(device)
    on = env == "1" or (env is None and device == "cuda")
    assert hl.ln_kernels_on(dev) is on
    assert hl.ln_kernels_on(device) is on
    for shape in SUPPORTED:
        assert hl.ln_kernel_enabled(True, shape, dev) is on, shape
        assert not hl.ln_kernel_enabled(False, shape, dev), shape
    for shape in UNSUPPORTED:
        assert not hl.ln_kernel_enabled(True, shape, dev), shape


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_module_on_a_cpu_tensor_engages_only_when_opted_in(monkeypatch, env):
    _set(monkeypatch, env)
    calls = []
    real = hl.LayerNormFn.apply
    monkeypatch.setattr(hl.LayerNormFn, "apply", lambda *a: calls.append(1) or real(*a))
    x = torch.randn(4, 16, 512, generator=torch.Generator().manual_seed(0))
    y = FusedLN(512, use_kernels=True)(x)
    assert calls == ([1] if env == "1" else [])
    torch.testing.assert_close(y, hl.layer_norm_plain(x, torch.ones(512), torch.zeros(512), 1e-5),
                               atol=2e-5, rtol=2e-5)


class _Recorded:
    """A capture that records nothing: its replay leaves the output of the
    capture's own run in place."""

    def replay(self):
        pass


def test_train_graphs_are_keyed_by_the_setting_in_force(monkeypatch):
    captured = []

    def capture(fn, generator=None, state=(), **kw):
        captured.append(hl.ln_kernels_on(torch.device("cuda")))
        return _Recorded(), fn()

    monkeypatch.setattr(steps, "capture_graph", capture)
    progs, _ = _programs(_model("mmdti"), "mmdti")
    # the programs' device as a card's: the key reads the setting there
    progs.use_graphs, progs.device = True, torch.device("cuda")
    res = _resident("mmdti")
    idx = torch.arange(8).view(2, 4)
    for env in (None, "1", "0", None, "0", "1"):
        _set(monkeypatch, env)
        progs.feed(res, idx)
    assert captured == [True, False]
    assert sorted(key[-1] for key in progs.graphs) == [False, True]


def test_serve_graphs_are_keyed_by_the_setting_in_force(monkeypatch):
    arrays = {"src_tokens": np.zeros((4, 16), np.int64), "input_ids": np.zeros((4, 8), np.int64)}
    keys = {}
    for env in (None, "0", "1"):
        _set(monkeypatch, env)
        keys[env] = {d: MolServe._graph_key("predict", arrays, torch.device(d))
                     for d in ("cpu", "cuda")}
    assert keys[None]["cuda"] == keys["1"]["cuda"] != keys["0"]["cuda"]
    assert keys[None]["cpu"] == keys["0"]["cpu"] != keys["1"]["cpu"]
    assert keys[None]["cuda"][:-1] == keys["0"]["cuda"][:-1] == ("predict", 4, 16, 8)
