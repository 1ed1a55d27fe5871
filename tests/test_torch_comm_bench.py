"""The port's transport microbenchmark (``comm_bench.py``) on the CPU, at a
tiny size: every backend round-trips its payload and reports positive
times and rates, a mixed state dict (f32, bf16, int64) comes back bit for
bit over each backend (the bench checks its warmup round trip), and the
bench's payload defaults to the card and raises without one."""

import importlib.util

import pytest
import torch

from fedml_tpu_torch.core.distributed.communication import comm_bench

HAVE_GRPC = importlib.util.find_spec("grpc") is not None
BACKENDS = [b for b in comm_bench.BACKENDS if b != "GRPC" or HAVE_GRPC]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_backend_at_a_tiny_size():
    results = comm_bench.main(backends=BACKENDS, sizes=[10_000], device="cpu", reps=3)
    assert [r["backend"] for r in results] == BACKENDS
    for r in results:
        assert r["payload_bytes"] == 10_000 and r["device"] == "cpu"
        assert 0 < r["rtt_ms_min_max"][0] <= r["rtt_ms_median"] <= r["rtt_ms_min_max"][1]
        assert r["mb_per_sec"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_payload_integrity(backend):
    g = torch.Generator().manual_seed(0)
    payload = {"w": torch.randn(1000, 1000, generator=g),
               "h": torch.randn(64, 33, generator=g).bfloat16(),
               "steps": torch.arange(7, dtype=torch.int64)}
    r = comm_bench.bench_backend(backend, payload=payload, reps=2)
    assert r["payload_bytes"] == 4_000_000 + 64 * 33 * 2 + 7 * 8
    assert r["mb_per_sec"] > 0


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        comm_bench.bench_backend("CARRIER_PIGEON", 100, device="cpu")


def test_payload_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm_bench.make_payload(100)
