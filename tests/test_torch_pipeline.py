"""The port's async input pipeline (mmdti_tpu_torch/data/pipeline.py): the
twins of tests/test_pipeline.py's eight cases, StreamPut on the CPU, and a
host-branch fit (device_feed=False) fed through prefetch_to_device bit-equal
to the same fit fed batch by batch."""

import os
import time

import numpy as np
import pytest
import torch

from mmdti_tpu_torch.data import pipeline
from mmdti_tpu_torch.data.pipeline import (
    AsyncLoader,
    StreamPut,
    device_prefetch,
    prefetch_to_device,
)
from tests.conftest import SMILES_20
from tests.torch_task_parity import one_thread


class SlowLoader:
    def __init__(self, n, delay=0.01):
        self.n = n
        self.delay = delay

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.delay)
            yield i


class TestAsyncLoader:
    def test_order_and_completeness(self):
        assert list(AsyncLoader(SlowLoader(10, 0.001))) == list(range(10))

    def test_exception_propagates(self):
        class Bad:
            def __iter__(self):
                yield 1
                raise RuntimeError("boom")

        with pytest.raises(RuntimeError, match="boom"):
            list(AsyncLoader(Bad()))

    def test_abandoned_consumer_stops_worker(self):
        consumed = [0]

        class Counting:
            def __iter__(self):
                for i in range(10_000):
                    consumed[0] = i
                    yield i

        gen = iter(AsyncLoader(Counting(), depth=2))
        assert next(gen) == 0
        gen.close()
        time.sleep(0.5)
        seen = consumed[0]
        time.sleep(0.5)
        assert consumed[0] == seen
        assert consumed[0] < 100

    def test_overlap_speedup(self):
        delay, n = 0.005, 20
        t0 = time.perf_counter()
        for _ in AsyncLoader(SlowLoader(n, delay), depth=4):
            time.sleep(delay)
        assert time.perf_counter() - t0 < 2 * n * delay * 0.9


class TestDevicePrefetch:
    def test_put_applied_and_order(self):
        calls = []

        def put(x):
            calls.append(x)
            return x * 10

        assert list(device_prefetch(range(5), put, depth=2)) == [0, 10, 20, 30, 40]
        assert calls == list(range(5))

    def test_prefetch_ahead(self):
        seen = []

        def put(x):
            seen.append(x)
            return x

        gen = device_prefetch(range(6), put, depth=3)
        next(gen)
        assert len(seen) >= 4

    def test_short_iterables(self):
        assert list(device_prefetch([1], lambda x: x, depth=4)) == [1]
        assert list(device_prefetch([], lambda x: x, depth=2)) == []

    def test_composed(self):
        assert list(prefetch_to_device(SlowLoader(5, 0.001), lambda x: -x)) == [0, -1, -2, -3, -4]


def test_stream_put_on_the_cpu():
    put = StreamPut("cpu")
    assert put.stream is None
    batch = ({"a": np.arange(6, dtype=np.int32).reshape(2, 3)}, np.ones(2, np.float32), None)
    feats, labels, weights = put(batch).take()
    assert feats["a"].dtype == torch.int32 and feats["a"].device.type == "cpu"
    np.testing.assert_array_equal(feats["a"].numpy(), batch[0]["a"])
    assert labels.dtype == torch.float32 and weights is None


def _fit(tmp_path, name):
    from mmdti_tpu_torch import MolTrain

    y = np.random.RandomState(0).randn(len(SMILES_20))
    train, val = str(tmp_path / "train.csv"), str(tmp_path / "val.csv")
    for path, rows in ((train, slice(0, 16)), (val, slice(16, 20))):
        with open(path, "w") as f:
            f.write("smiles,y\n")
            f.writelines(f"{s},{v}\n" for s, v in zip(SMILES_20[rows], y[rows]))
    exp = str(tmp_path / name)
    # batch 4: 4 train batches an epoch, stacked K=2 a dispatch
    clf = MolTrain(task="regression", epochs=2, batch_size=4, metrics="mse",
                   smiles_col="smiles", target_cols=["y"], save_path=exp, seed=7,
                   compute_dtype="float32", use_pallas=False, device="cpu",
                   device_feed=False, steps_per_call=2, use_weight=True,
                   unimol_overrides=dict(encoder_layers=1, embed_dim=16, ffn_embed_dim=32,
                                         attention_heads=2),
                   chemberta_overrides=dict(hidden_size=16, num_hidden_layers=1,
                                            num_attention_heads=2, intermediate_size=32))
    clf.fit(train, val)
    return clf


def test_host_branch_fit_through_prefetch_equals_direct_feed(tmp_path, monkeypatch):
    threads = one_thread()
    try:
        calls = []
        real = pipeline.prefetch_to_device

        def counting(loader, put_fn, *a, **k):
            calls.append(len(loader))
            return real(loader, put_fn, *a, **k)

        from mmdti_tpu_torch.train import fit_loop

        monkeypatch.setattr(fit_loop, "prefetch_to_device", counting)
        fed = _fit(tmp_path, "prefetched")
        assert calls == [4, 4]   # both epochs' train batches came through it
        # the same batches, one at a time on this thread
        monkeypatch.setattr(fit_loop, "prefetch_to_device",
                            lambda loader, put_fn: map(put_fn, loader))
        direct = _fit(tmp_path, "direct")
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(fed.cv_pred, direct.cv_pred)
    for (n, a), (_, b) in zip(fed.model.model.state_dict().items(),
                              direct.model.model.state_dict().items()):
        assert torch.equal(a, b), n
    with open(os.path.join(fed.save_path, "history_0.json")) as f1, open(
            os.path.join(direct.save_path, "history_0.json")) as f2:
        import json

        strip = lambda h: [{k: v for k, v in r.items() if "seconds" not in k} for r in h]  # noqa: E731
        assert strip(json.load(f1)) == strip(json.load(f2))
