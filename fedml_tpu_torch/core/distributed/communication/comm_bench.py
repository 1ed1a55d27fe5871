"""Message-plane transport microbenchmark: the port's counterpart of
``fedml_tpu/core/distributed/communication/comm_bench.py``.

Reference parity: ``python/tests/grpc_benchmark/`` (gRPC vs torch.rpc
transfer benchmarks). The backends compared are the ones the port ships:
INMEMORY (payloads by reference), GRPC (the codec's npz frame) and TRPC
(tensor-native raw frames), measured as ping-pong round-trip latency
between two in-process manager instances, so the numbers isolate
serialization and transport from scheduling noise. ``mb_per_sec`` counts
the payload twice per round trip (the ping and the pong both carry it).

The payload is a flat float32 tensor of the asked size on ``device`` (the
card unless the caller asks for the CPU), or any state dict (``payload=``)
on the device it is on: from the card, the copy to the host
is part of every ping (the pong comes back from the host). The first round
trip is a warmup, checked bit for bit against what was sent.

Each pair binds a block of free ports (``ip_config.free_port_block``),
never fixed ones, and retries on ``EADDRINUSE``.

Run: ``python -m fedml_tpu_torch.core.distributed.communication.comm_bench
[--device cuda] [--sizes 1000 1000000]`` (one JSON line per backend and
size; GRPC needs the ``grpc`` package).
"""

from __future__ import annotations

import argparse
import errno
import json
import queue
import threading
import time
from typing import Dict, List, Mapping, Optional

import torch

from ....device import resolve_device
from .ip_config import free_port_block
from .message import Message

PING, PONG = 101, 102
BACKENDS = ("INMEMORY", "GRPC", "TRPC")


def make_payload(nbytes: int, device: str = "cuda") -> Dict[str, torch.Tensor]:
    n = max(1, nbytes // 4)
    return {"w": torch.arange(n, dtype=torch.float32, device=resolve_device(device))}


def payload_nbytes(payload: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in payload.values())


class _Echo:
    """Observer that pongs every ping back through its manager."""

    def __init__(self, manager, me: int, peer: int):
        self.manager = manager
        self.me, self.peer = me, peer

    def receive_message(self, msg_type, msg):
        if msg_type == PING:
            reply = Message(PONG, self.me, self.peer)
            reply.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS))
            try:
                self.manager.send_message(reply)
            except Exception:
                pass  # peer tearing down between reps; the bench ignores late pongs


class _Collector:
    def __init__(self):
        self.q: "queue.Queue" = queue.Queue()

    def receive_message(self, msg_type, msg):
        if msg_type == PONG:
            self.q.put(msg)


def _make_pair(backend: str, base_port: int):
    """Two managers (rank 0 pings, rank 1 echoes) and their teardown."""
    if backend == "INMEMORY":
        from .inmemory.broker import InMemoryBroker
        from .inmemory.inmemory_comm_manager import InMemoryCommManager

        run_id = f"commbench_{base_port}"
        InMemoryBroker.reset(run_id)
        m0 = InMemoryCommManager(run_id, 0, 2)
        m1 = InMemoryCommManager(run_id, 1, 2)
    elif backend in ("GRPC", "TRPC"):
        if backend == "GRPC":
            from .grpc.grpc_comm_manager import GRPCCommManager as cls
        else:
            from .trpc.trpc_comm_manager import TRPCCommManager as cls
        m0 = cls(client_id=0, client_num=1, base_port=base_port)
        try:
            m1 = cls(client_id=1, client_num=1, base_port=base_port)
        except OSError:
            m0.stop_receive_message()
            raise
    else:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")

    def teardown():
        m0.stop_receive_message()
        m1.stop_receive_message()

    return m0, m1, teardown


def _bound_pair(backend: str, tries: int = 5):
    for attempt in range(tries):
        try:
            return _make_pair(backend, free_port_block(2))
        except OSError as e:
            # a port taken between the probe and the bind (gRPC reports it
            # without an errno)
            if attempt == tries - 1 or e.errno not in (errno.EADDRINUSE, None):
                raise


def _same(got: Mapping, sent: Mapping) -> bool:
    return sorted(got) == sorted(sent) and all(
        got[k].dtype == sent[k].dtype and torch.equal(got[k].cpu(), sent[k].cpu()) for k in sent)


def bench_backend(backend: str, payload_bytes: int = 0, reps: int = 20,
                  payload: Optional[Mapping[str, torch.Tensor]] = None,
                  device: str = "cuda") -> Dict:
    """Round trips of ``payload`` (or a flat float32 tensor of
    ``payload_bytes`` on ``device``) between two managers of ``backend``."""
    payload = dict(payload) if payload is not None else make_payload(payload_bytes, device)
    nbytes = payload_nbytes(payload)
    m0, m1, teardown = _bound_pair(backend)
    collector = _Collector()
    m0.add_observer(collector)
    m1.add_observer(_Echo(m1, 1, 0))
    t0 = threading.Thread(target=m0.handle_receive_message, daemon=True)
    t1 = threading.Thread(target=m1.handle_receive_message, daemon=True)
    t0.start()
    t1.start()
    try:
        def rt_once() -> tuple:
            msg = Message(PING, 0, 1)
            msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, payload)
            t = time.perf_counter()
            m0.send_message(msg)
            back = collector.q.get(timeout=120)
            dt = time.perf_counter() - t
            got = back.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
            if payload_nbytes(got) != nbytes:
                raise AssertionError(f"{backend}: payload corrupted in flight")
            return dt, got

        _, got = rt_once()  # warmup (connection setup, first-path costs)
        if not _same(got, payload):
            raise AssertionError(f"{backend}: the payload came back changed")
        times = sorted(rt_once()[0] for _ in range(reps))
        median = times[len(times) // 2]
        return {
            "backend": backend,
            "payload_bytes": nbytes,
            "payload_mb": nbytes / 1e6,
            "device": str(next(iter(payload.values())).device),
            "reps": reps,
            "rtt_ms_median": median * 1e3,
            "rtt_ms_min_max": [times[0] * 1e3, times[-1] * 1e3],
            # ping + pong both carry the payload: 2x payload per round trip
            "mb_per_sec": 2 * nbytes / median / 1e6,
        }
    finally:
        teardown()
        t0.join(timeout=5)
        t1.join(timeout=5)


def main(backends: Optional[List[str]] = None, sizes: Optional[List[int]] = None,
         device: str = "cuda", reps: int = 20) -> List[Dict]:
    out = []
    for backend in backends or list(BACKENDS):
        for size in sizes or [1_000, 1_000_000, 16_000_000]:
            res = bench_backend(backend, size, reps=reps, device=device)
            print(json.dumps(res), flush=True)
            out.append(res)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backends", nargs="*", default=None)
    ap.add_argument("--sizes", nargs="*", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    main(a.backends, a.sizes, a.device, a.reps)
