"""mmdti_tpu_torch's HTTP front and dynamic batcher on the CPU (ported from
tests/test_serve.py's TestHTTPFront and TestDynamicBatching), over an
experiment dir the port writes directly from a seeded small model (no fit):
health, predict and embed round trips, concurrent clients, 400 / 404 /
413 / 429, latency stats, coalescing, error propagation, a bad rider that
fails only its own request, the host/device pipeline, and the batcher's
in-flight accounting: a batch that fails after resolving some riders
retries only the others, and every slot is released exactly once.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmdti_tpu_torch.api.serve_api import MolServe
from mmdti_tpu_torch.api.serve_batcher import DynamicBatcher, OverloadedError
from mmdti_tpu_torch.chem.dictionary import Dictionary
from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
from mmdti_tpu_torch.configs.config import default_config, save_yaml
from mmdti_tpu_torch.models.convert import state_dict_to_flax_params
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.checkpointing import save_checkpoint
from tests.conftest import SMALL_ARCH


def write_experiment(path, task="regression", target_cols="measured", folds=1, seed=0,
                     **config):
    """An experiment dir as MolTrain.fit leaves it (config.yaml and
    model_{fold}.ckpt for fold < folds), fp32 SMALL_ARCH weights drawn from
    ``seed + fold``; no scaler, no threshold.dat."""
    cfg = default_config()
    cfg.update(task=task, target_cols=target_cols, compute_dtype="float32", use_scaler=False,
               model_folds=folds, num_classes=1, **SMALL_ARCH, **config)
    os.makedirs(path, exist_ok=True)
    save_yaml(cfg, os.path.join(path, "config.yaml"))
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    for fold in range(folds):
        model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                            compute_dtype="float32",
                            unimol_overrides=SMALL_ARCH["unimol_overrides"],
                            chemberta_overrides=SMALL_ARCH["chemberta_overrides"])
        model.reset_parameters_like_flax(torch.Generator().manual_seed(seed + fold))
        save_checkpoint(path, fold, state_dict_to_flax_params(model.state_dict()))
    return str(path)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    exp = write_experiment(tmp_path_factory.mktemp("exp_http"))
    yield MolServe(exp, device="cpu")
    torch.set_num_threads(threads)


def _post(url, payload=None, data=None):
    req = urllib.request.Request(
        url, data=data if data is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def http_server(server):
    srv = server.make_server(port=0)  # OS-assigned port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


class TestHTTPFront:
    def test_health(self, http_server):
        with urllib.request.urlopen(http_server + "/health", timeout=30) as r:
            body = json.loads(r.read())
        assert r.status == 200
        assert body["status"] == "ok"
        assert body["task"] == "regression"
        assert body["serve_folds"] == 1
        assert body["mesh"] is None  # single-device server

    def test_predict_roundtrip(self, http_server, server):
        code, body = _post(http_server + "/predict", {"smiles": ["CCO", "CCN"]})
        assert code == 200
        assert body["target_cols"] == ["measured"]
        assert body["valid"] == [True, True]
        want = server.predict(["CCO", "CCN"])["predict"]
        np.testing.assert_allclose(np.asarray(body["predict"]), want, rtol=1e-5)

    def test_embed_roundtrip(self, http_server, server):
        code, body = _post(http_server + "/embed", {"smiles": ["CCO"]})
        assert code == 200
        cls_r, pooled = server.embed(["CCO"])
        np.testing.assert_allclose(np.asarray(body["cls_repr"]), cls_r, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(body["pooled"]), pooled, rtol=1e-5)

    def test_concurrent_clients(self, http_server):
        """8 threads x 3 requests: all 200 with the right shapes (requests
        serialize through the server's lock; no deadlock, no 500)."""
        codes = []
        lock = threading.Lock()

        def client():
            for _ in range(3):
                code, body = _post(http_server + "/predict", {"smiles": ["CCO", "CCN"]})
                with lock:
                    codes.append((code, np.asarray(body.get("predict")).shape
                                  if code == 200 else None))

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        assert len(codes) == 24
        assert all(c == 200 and shape == (2, 1) for c, shape in codes)

    def test_bad_request(self, http_server):
        code, _ = _post(http_server + "/predict", {"nope": 1})
        assert code == 400
        code, _ = _post(http_server + "/predict", data=b"{not json")
        assert code == 400
        code, _ = _post(http_server + "/elsewhere", {"smiles": ["C"]})
        assert code == 404

    def test_oversized_body_rejected(self, http_server):
        """A Content-Length beyond the cap gets 413 without being read."""
        req = urllib.request.Request(
            http_server + "/predict", data=b"{}",
            headers={"Content-Type": "application/json",
                     "Content-Length": str(64 << 20)}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        except urllib.error.URLError:
            # some stacks abort the send once the server replies early:
            # either way the request must not succeed
            code = 413
        assert code == 413

    def test_health_latency_stats(self, http_server, server):
        server.predict(["CCO"])  # at least one sample in the window
        with urllib.request.urlopen(http_server + "/health", timeout=30) as r:
            body = json.loads(r.read())
        lat = body["latency"]
        assert lat["count"] >= 1
        assert lat["p50_ms"] > 0 and lat["p95_ms"] >= lat["p50_ms"]

    def test_overload_answers_429(self, server, monkeypatch):
        """With the batcher's one in-flight slot taken, /predict answers
        429; the admitted request still completes."""
        gate = threading.Event()
        orig = type(server)._dispatch_forward

        def stalled(self, smiles):
            gate.wait(60)
            return orig(self, smiles)

        monkeypatch.setattr(type(server), "_dispatch_forward", stalled)
        srv = server.make_server(port=0, dynamic_batch_window_ms=1.0)
        srv.batcher.max_pending = 1
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{srv.server_port}/predict"
        first = {}
        rider = threading.Thread(target=lambda: first.update(
            zip(("code", "body"), _post(url, {"smiles": ["CCO"]}))))
        try:
            rider.start()
            deadline = time.monotonic() + 30.0
            while srv.batcher._inflight < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            code, body = _post(url, {"smiles": ["CCN"]})
            assert code == 429 and "max_pending=1" in body["error"]
            gate.set()
            rider.join(timeout=120)
            assert first["code"] == 200
        finally:
            gate.set()
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)


class _FakeServe:
    """The staged-forward surface of MolServe with the stages faked: rows
    encode their batch position; ``predict`` (the retry path) counts its
    calls."""

    batch_buckets = (1, 2, 4, 8)
    target_cols = ["y"]

    def __init__(self):
        self.predicted = []

    def _dispatch_forward(self, smiles):
        return [(list(smiles), len(smiles))], None

    def _finalize_forward(self, chunks, feats, t0):
        n = sum(c[1] for c in chunks)
        return {"predict": np.arange(n, dtype=np.float64).reshape(n, 1), "proba": None,
                "target_cols": self.target_cols, "valid": np.ones(n, bool)}

    def predict(self, smiles):
        self.predicted.append(list(smiles))
        return {"predict": np.full((len(smiles), 1), -1.0), "proba": None,
                "target_cols": self.target_cols, "valid": np.ones(len(smiles), bool)}


class TestDynamicBatching:
    def test_concurrent_requests_coalesce(self, server):
        """N concurrent single-SMILES submits ride fewer device batches than
        N, and every rider gets exactly its own rows back."""
        batcher = DynamicBatcher(server, window_ms=200.0)
        smiles = ["CCO", "CCN", "c1ccccc1", "CC(C)O", "CCCC", "CCS"]
        want = {s: server.predict(s)["predict"] for s in smiles}
        results, errors = {}, []

        def fire(s):
            try:
                results[s] = batcher.submit([s])["predict"]
            except Exception as e:  # surfaced to the main thread below
                errors.append(e)

        threads = [threading.Thread(target=fire, args=(s,)) for s in smiles]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batcher.stop()
        assert not errors
        assert batcher.requests_served == len(smiles)
        assert batcher.batches_run < len(smiles)  # actually coalesced
        for s in smiles:
            np.testing.assert_allclose(results[s], want[s], rtol=1e-4, atol=1e-5)

    def test_batcher_propagates_errors(self, server):
        batcher = DynamicBatcher(server, window_ms=1.0)
        with pytest.raises(ValueError):
            batcher.submit([])
        batcher.stop()

    def test_bad_rider_does_not_fail_shared_batch(self, server):
        """An unparseable SMILES from one rider fails only that rider: the
        batch is retried per rider."""
        batcher = DynamicBatcher(server, window_ms=200.0)
        results = {}

        def good():
            results["good"] = batcher.submit(["CCO"])

        def bad():
            try:
                batcher.submit(["not_a_smiles((("])
                results["bad"] = "no error"
            except Exception as e:
                results["bad"] = e

        threads = [threading.Thread(target=good), threading.Thread(target=bad)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batcher.stop()
        assert isinstance(results["bad"], Exception)
        assert np.isfinite(results["good"]["predict"]).all()
        assert batcher._inflight == 0

    def test_finalize_error_retries_per_rider(self, server, monkeypatch):
        """A failure of the pull stage also falls back to per-rider retries."""
        real_finalize = type(server)._finalize_forward
        calls = {"n": 0}

        def flaky(self, chunks, feats, t0):
            calls["n"] += 1
            if calls["n"] == 1:  # only the first (shared) batch fails
                raise RuntimeError("injected pull failure")
            return real_finalize(self, chunks, feats, t0)

        monkeypatch.setattr(type(server), "_finalize_forward", flaky)
        batcher = DynamicBatcher(server, window_ms=200.0)
        results = {}

        def fire(name, smi):
            results[name] = batcher.submit([smi])

        threads = [threading.Thread(target=fire, args=("a", "CCO")),
                   threading.Thread(target=fire, args=("b", "CCN"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batcher.stop()
        assert calls["n"] >= 1
        assert np.isfinite(results["a"]["predict"]).all()
        assert np.isfinite(results["b"]["predict"]).all()

    def test_pipeline_overlaps_host_and_device(self, monkeypatch):
        """With the host stage and the pull faked at H and D seconds, K
        single-rider batches take about K*H + D, not K*(H+D)."""
        H = D = 0.08
        K = 4
        serve = _FakeServe()

        def fake_dispatch(smiles):
            time.sleep(H)
            return [(list(smiles), len(smiles))], None

        real_finalize = serve._finalize_forward

        def fake_finalize(chunks, feats, t0):
            time.sleep(D)
            return real_finalize(chunks, feats, t0)

        monkeypatch.setattr(serve, "_dispatch_forward", fake_dispatch)
        monkeypatch.setattr(serve, "_finalize_forward", fake_finalize)
        batcher = DynamicBatcher(serve, window_ms=1.0, max_batch=1)
        threads = [threading.Thread(target=batcher.submit, args=(["CCO"],))
                   for _ in range(K)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        wall = time.perf_counter() - t0
        batcher.stop()
        assert wall < K * (H + D) - 0.5 * D, (wall, K * (H + D), K * H + D)
        assert batcher.batches_run == K

    def test_sustained_mixed_bucket_slo(self, monkeypatch):
        """Sustained mixed-size concurrent load: every rider gets its own
        consecutive rows, the stages overlap across batches, and each
        rider's latency is bounded by the pipeline depth (stage times
        injected, 40 ms each)."""
        H = D = 0.04
        serve = _FakeServe()
        calls = {"n": 0}

        def fake_dispatch(smiles):
            time.sleep(H)
            calls["n"] += 1
            return [(list(smiles), len(smiles))], None

        real_finalize = serve._finalize_forward

        def fake_finalize(chunks, feats, t0):
            time.sleep(D)
            return real_finalize(chunks, feats, t0)

        monkeypatch.setattr(serve, "_dispatch_forward", fake_dispatch)
        monkeypatch.setattr(serve, "_finalize_forward", fake_finalize)
        sizes = [1, 3, 1, 5, 2, 1, 4, 1]
        batcher = DynamicBatcher(serve, window_ms=5.0, max_batch=6)
        lat, rows = {}, {}

        def ride(key, smi):
            s = time.perf_counter()
            out = batcher.submit(list(smi))
            lat[key] = time.perf_counter() - s
            rows[key] = np.asarray(out["predict"]).reshape(-1)

        rounds = 3
        t0 = time.perf_counter()
        for rnd in range(rounds):
            threads = [threading.Thread(target=ride, args=((rnd, i), ["CCO"] * s))
                       for i, s in enumerate(sizes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        wall = time.perf_counter() - t0
        batcher.stop()
        assert len(lat) == rounds * len(sizes)
        for (_, i), got in rows.items():
            assert got.shape == (sizes[i],)
            np.testing.assert_allclose(np.diff(got), 1.0)
        assert wall < calls["n"] * (H + D) * 0.9 + 0.2, (wall, calls["n"])
        p95 = sorted(lat.values())[int(0.95 * len(lat))]
        assert p95 < 5 * (H + D) + 0.5, (p95, sorted(lat.values())[-3:])

    def test_overload_shedding(self, server, monkeypatch):
        """Past max_pending riders in flight (queued, dispatched or parked
        for retry), submit raises OverloadedError; admitted riders finish
        and every slot is released."""
        gate = threading.Event()
        orig = type(server)._dispatch_forward

        def stalled(self, smiles):
            gate.wait(60)
            return orig(self, smiles)

        monkeypatch.setattr(type(server), "_dispatch_forward", stalled)
        batcher = DynamicBatcher(server, window_ms=1.0, max_pending=2, max_batch=1)
        results = []

        def ride():
            try:
                batcher.submit(["CCO"])
                results.append("ok")
            except OverloadedError:
                results.append("shed")

        riders = [threading.Thread(target=ride) for _ in range(2)]
        for t in riders:
            t.start()
        deadline = time.monotonic() + 30.0
        while batcher._inflight < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher._inflight == 2, "riders never backed up"
        with pytest.raises(OverloadedError):
            batcher.submit(["CCN"])
        gate.set()
        for t in riders:
            t.join(timeout=120)
        batcher.stop()
        assert results == ["ok", "ok"]
        assert batcher._inflight == 0

    def test_stop_makes_submit_fail_loudly(self):
        batcher = DynamicBatcher(_FakeServe(), window_ms=1.0)
        batcher.stop()
        batcher._thread.join(timeout=30)
        assert not batcher._thread.is_alive()
        with pytest.raises(RuntimeError, match="not running"):
            batcher.submit(["CCO"])
        assert batcher._inflight == 0

    def test_server_close_stops_batcher(self, server):
        srv = server.make_server(port=0, dynamic_batch_window_ms=10.0)
        assert srv.batcher._thread.is_alive()
        srv.server_close()
        srv.batcher._thread.join(timeout=30)
        assert not srv.batcher._thread.is_alive()

    def test_http_with_batching_window(self, server):
        srv = server.make_server(port=0, dynamic_batch_window_ms=20.0)
        assert srv.batcher is not None
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            code, body = _post(f"http://127.0.0.1:{srv.server_port}/predict",
                               {"smiles": ["CCO"]})
            assert code == 200 and np.asarray(body["predict"]).shape == (1, 1)
            assert srv.batcher.batches_run >= 1
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)


class TestInflightAccounting:
    """A rider's in-flight slot is released exactly once (the JAX
    package's serve_batcher.py:136 releases it twice in both cases)."""

    def test_partial_distribute_retries_only_unresolved_riders(self, monkeypatch):
        """_distribute resolves the first rider, then raises: the batch goes
        to the retry worker, which answers the second rider alone and leaves
        the first as it was; the in-flight count returns to 0."""
        serve = _FakeServe()
        batcher = DynamicBatcher(serve, window_ms=500.0)
        real = batcher._distribute

        def distribute_then_fail(pending, out):
            real(pending[:1], out)
            raise RuntimeError("injected failure after the first rider")

        monkeypatch.setattr(batcher, "_distribute", distribute_then_fail)
        results = {}

        def fire(name, smi):
            results[name] = batcher.submit(smi)

        threads = [threading.Thread(target=fire, args=("a", ["CCO"])),
                   threading.Thread(target=fire, args=("b", ["CCN", "CCS"]))]
        for t in threads:
            t.start()
            time.sleep(0.05)   # a rides first, b joins its batch
        for t in threads:
            t.join(timeout=60)
        batcher.stop()
        assert not any(t.is_alive() for t in threads)
        assert batcher.batches_run == 1
        first, second = sorted(results.values(), key=lambda o: len(o["predict"]))
        np.testing.assert_array_equal(first["predict"], [[0.0]])  # its batch rows
        np.testing.assert_array_equal(second["predict"], [[-1.0], [-1.0]])  # the retry
        assert serve.predicted == [["CCN", "CCS"]]
        assert batcher._inflight == 0

    def test_dead_batcher_releases_a_slot_once(self, monkeypatch):
        """A rider whose submit gave up on a dead batcher (its slot
        released there) and whose batch then completes is not released
        again."""
        serve = _FakeServe()
        gate = threading.Event()
        real_finalize = serve._finalize_forward

        def held(chunks, feats, t0):
            gate.wait(60)
            return real_finalize(chunks, feats, t0)

        monkeypatch.setattr(serve, "_finalize_forward", held)
        alive = {"v": True}
        monkeypatch.setattr(DynamicBatcher, "_alive",
                            property(lambda self: alive["v"]))
        batcher = DynamicBatcher(serve, window_ms=1.0)
        errors = []

        def ride():
            try:
                batcher.submit(["CCO"])
            except RuntimeError as e:
                errors.append(e)

        rider = threading.Thread(target=ride)
        rider.start()
        deadline = time.monotonic() + 30.0
        while batcher.batches_run < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        alive["v"] = False            # submit's liveness check gives up
        rider.join(timeout=30)
        assert not rider.is_alive() and len(errors) == 1
        assert batcher._inflight == 0
        gate.set()                    # the batch completes after all
        batcher.stop()                # the completion thread exits after it
        batcher._cthread.join(timeout=30)
        assert not batcher._cthread.is_alive()
        assert batcher._inflight == 0


def test_cli_refuses_a_mesh(server):
    """The CLI takes --mesh as the JAX package's does: a model axis above 1
    serves tensor-parallel shards (tests/test_torch_tp.py), and this
    model's 2 heads a shard are refused by the fused gbf kernel's gate
    before anything is served."""
    from mmdti_tpu_torch.api.serve_http import main

    with pytest.raises(ValueError, match="gbf kernel's gate"):
        main([server.load_model, "--mesh", "1", "2", "--device", "cpu", "--port", "0"])
