"""The port's micro-batching ANN endpoint, on the CPU: results equal the
index's own batch_search, overload sheds with the port's typed error, and
stats() and the metric names are those of the JAX package's endpoint."""

import threading
import time

import numpy as np
import pytest

from lakesoul_tpu_torch.errors import OverloadedError, TransientError
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.vector import AnnEndpoint, IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.analysis.arm import armed

STATS_FIELDS = {"requests", "rejected", "pending", "max_pending", "batches", "mean_batch",
                "latency_p50", "latency_p99"}


@pytest.fixture(scope="module")
def index_and_queries():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 32)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 8, 2000)] + rng.normal(size=(2000, 32))).astype(np.float32)
    idx = IvfRabitqIndex.train(x, np.arange(2000), VectorIndexConfig("v", 32, nlist=8),
                               device="cpu")
    idx.enable_device_cache()
    return idx, x


class _SlowIndex:
    """Stand-in ANN index: fixed per-batch latency, deterministic result."""

    class config:
        dim = 4

    def batch_search(self, queries, params):
        time.sleep(0.02)
        n = len(queries)
        return np.tile(np.arange(3), (n, 1)), np.zeros((n, 3), dtype=np.float32)


def test_endpoint_results_equal_batch_search(index_and_queries):
    idx, x = index_and_queries
    # a deep shortlist: at dim 32 the 1-bit estimate alone may rank a row's
    # own vector below the default 4·top_k shortlist
    p = SearchParams(top_k=5, nprobe=4, rerank_depth=200)
    want_ids, want_d = idx.batch_search(x[:32], p)
    with AnnEndpoint(idx, p, max_wait_ms=1.0, name="port-eq") as ep:
        futs = [ep.submit(x[i]) for i in range(32)]
        for i, f in enumerate(futs):
            ids, dists = f.result(timeout=30)
            # the same arithmetic per query column; only the batch it rode in
            # differs, which float32 matmul blocking may round in the last ulp
            np.testing.assert_array_equal(ids, want_ids[i])
            np.testing.assert_allclose(dists, want_d[i], rtol=1e-5, atol=1e-5)
            assert int(ids[0]) == i  # self nearest neighbour
        stats = ep.stats()
    assert set(stats) == STATS_FIELDS
    assert stats["requests"] == 32 and stats["batches"] >= 1
    assert stats["latency_p99"] >= stats["latency_p50"] >= 0.0


def test_concurrent_clients_are_batched(index_and_queries):
    idx, x = index_and_queries
    p = SearchParams(top_k=1, nprobe=8, rerank_depth=200)
    errors = []

    def client(lo):
        try:
            for i in range(lo, lo + 10):
                ids, _ = ep.search(x[i], timeout=30)
                assert int(ids[0]) == i
        except Exception as e:  # surfaced below
            errors.append(e)

    with AnnEndpoint(idx, p, max_wait_ms=5.0, name="port-conc") as ep:
        threads = [threading.Thread(target=client, args=(lo,)) for lo in range(0, 80, 10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        stats = ep.stats()
    assert not errors
    assert stats["requests"] == 80
    assert stats["mean_batch"] > 1.0


def test_overload_sheds_with_typed_error():
    key = 'lakesoul_ann_request_seconds{endpoint="port-overload"}'
    ep = AnnEndpoint(_SlowIndex(), max_batch=4, max_wait_ms=1.0, max_pending=8,
                     name="port-overload")
    results = {"ok": 0, "shed": 0}
    guard = threading.Lock()
    gate = threading.Event()

    def client():
        gate.wait()
        try:
            ids, _ = ep.submit(np.zeros(4, dtype=np.float32)).result(timeout=30.0)
            assert list(ids) == [0, 1, 2]
            with guard:
                results["ok"] += 1
        except OverloadedError:
            with guard:
                results["shed"] += 1

    threads = [threading.Thread(target=client) for _ in range(64)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(60.0)
    try:
        stats = ep.stats()
        assert results["ok"] + results["shed"] == 64
        assert results["shed"] > 0 and results["ok"] > 0, stats
        assert stats["rejected"] == results["shed"]
        assert stats["pending"] <= stats["max_pending"] == 8
        snap = registry().snapshot()
        assert snap[key]["count"] == results["ok"]
        assert snap["lakesoul_ann_requests_total"] >= results["ok"]
        assert snap["lakesoul_ann_rejected_total"] >= results["shed"]
        assert "lakesoul_ann_pending" in snap
    finally:
        ep.close()
    assert issubclass(OverloadedError, TransientError)


def test_bad_queries_and_closed_endpoint_raise(index_and_queries):
    idx, x = index_and_queries
    ep = AnnEndpoint(idx, SearchParams(top_k=1), name="port-closed")
    with pytest.raises(ValueError, match="dim"):
        ep.submit(np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="single"):
        ep.submit(np.zeros((2, 32), np.float32))
    ep.close()
    with pytest.raises(RuntimeError, match="closed"):
        ep.submit(x[0])


def test_batch_failure_reaches_every_waiter_and_the_worker_survives():
    class FailsOnce(_SlowIndex):
        failed = False

        def batch_search(self, queries, params):
            if not self.failed:
                self.failed = True
                raise RuntimeError("device lost")
            return super().batch_search(queries, params)

    with AnnEndpoint(FailsOnce(), max_wait_ms=20.0, name="port-broken") as ep:
        futs = [ep.submit(np.zeros(4, np.float32)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=10)
        ids, _ = ep.search(np.zeros(4, np.float32), timeout=10)
        assert list(ids) == [0, 1, 2]


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
