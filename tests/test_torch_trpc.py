"""The port's TRPC backend against the JAX package's, on the CPU.

- the frame: a port frame byte-equal to JAX's ``encode_frame`` of the same
  message (before any trace context is injected), with f32 and bf16 leaves;
  each package's ``recv_frame`` reads the other's over a socketpair, exactly
  (same dtype, shape and bits); the header cap raises ValueError in both;
- managers: a JAX manager and a port manager exchange both ways, the
  trace context riding along; a send survives the peer's restart on the
  same port;
- federations (LR, 2 clients, 2 rounds, tests/test_torch_cross_silo.py's
  shape): a JAX server with two port clients, and a port server (from the
  JAX initial params) with two JAX clients, each final params within 1e-5
  of their scale of the all-JAX run's (the socket-broker tolerance of
  tests/test_torch_cross_silo.py); a port federation over TRPC equal to the
  same run over INMEMORY, bit for bit.

No test binds a fixed port: each takes a block that was free a moment
before (``ip_config.free_port_block``) and starts again on another block if
a bind fails. Every party is a thread joined within JOIN_S. The helpers
here (``on_free_ports``, ``mixed_federation``, ``port_equals_inmemory``) serve
the other backends' tests too.
"""

import errno
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.distributed.communication.message import Message as JMessage
from fedml_tpu.core.distributed.communication.trpc import trpc_comm_manager as jtrpc
from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
from fedml_tpu_torch.core.distributed.communication.message import Message as TMessage
from fedml_tpu_torch.core.distributed.communication.mqtt_s3.mqtt_transport import LocalMqttBroker
from fedml_tpu_torch.core.distributed.communication.trpc import trpc_comm_manager as ttrpc
from fedml_tpu_torch.core.distributed.fedml_comm_manager import _run_id_offset
from fedml_tpu_torch.core.telemetry import trace_context as ttc
from tests.test_torch_cross_silo import (LR, Federation, _from_jax_params, _global, _jax_p0,
                                         _max_err_of_scale, _record_evals, _run_jax, _run_port)

JOIN_S = 60
MIXED_TOL = 1e-5  # tests/test_torch_cross_silo.py's socket-broker limit
PORT_KEY = {"TRPC": "trpc_base_port", "GRPC": "grpc_base_port", "MPI": "grpc_base_port"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- shared helpers: ports, federations ---------------------------------------

def _bind_failed(e: OSError) -> bool:
    # TRPC reports EADDRINUSE; the gRPC backend an OSError without an errno
    return e.errno in (errno.EADDRINUSE, None)


def on_free_ports(build, n_ports, tries=5):
    """``build(base)`` on a block of ``n_ports`` free ports, again on a
    fresh block when a bind fails (the block was free when probed, not
    necessarily when bound). ``build`` cleans up after itself."""
    for attempt in range(tries):
        try:
            return build(free_port_block(n_ports))
        except OSError as e:
            if attempt == tries - 1 or not _bind_failed(e):
                raise


def _manager(runner):
    inner = runner.runner
    return getattr(inner, "server_manager", None) or inner.client_manager


class Fed(Federation):
    """tests/test_torch_cross_silo.py's Federation, whose parties' comm
    managers are stopped if building a later party fails."""

    def __init__(self, *a, **kw):
        try:
            super().__init__(*a, **kw)
        except BaseException:
            self.stop()
            raise

    def stop(self):
        for runner in getattr(self, "runners", {}).values():
            _manager(runner).com_manager.stop_receive_message()


def port_kw(backend, run_id, kw, base):
    """``kw`` with the backend's base port set so that rank r listens at
    ``base + r`` (both packages add the run id's offset)."""
    key = PORT_KEY.get(backend)
    return dict(kw) if key is None else dict(kw, **{key: base - _run_id_offset(run_id)})


def mixed_federation(server_pkg, backend, run_id, kw, n_ports=3):
    """A server of ``server_pkg`` with two clients of the other package over
    ``backend``; returns the server's final params in the flax layout.
    A port server starts from the JAX initial params of the config."""
    client_pkg = fedml_tpu_torch if server_pkg is fedml_tpu else fedml_tpu
    prepare = _from_jax_params(_jax_p0(kw)) if server_pkg is fedml_tpu_torch else None

    def build(base):
        kw2 = port_kw(backend, run_id, kw, base)
        server = Fed(server_pkg, run_id, kw2, backend=backend, roles={1: None, 2: None},
                     prepare=prepare)
        try:
            clients = Fed(client_pkg, run_id, kw2, backend=backend, roles={0: None})
        except BaseException:
            server.stop()
            raise
        return server, clients

    LocalMqttBroker.reset(run_id)
    server, clients = on_free_ports(build, n_ports)
    assert sorted(server.runners) == [0] and sorted(clients.runners) == [1, 2]
    threads = [threading.Thread(target=clients._party, args=(r,), daemon=True, name=f"client-{r}")
               for r in clients.runners]
    server.run(others=threads)
    assert not clients.errors, clients.errors
    LocalMqttBroker.reset(run_id)
    w = server.server.aggregator.get_global_model_params()
    if server_pkg is fedml_tpu_torch:
        from fedml_tpu_torch.models.convert import params_to_jax

        return params_to_jax(w)
    return jax.device_get(w)


def assert_mixed_tracks_jax(backend, run_id, kw=LR, n_ports=3):
    """Both mixed federations over ``backend`` against the all-JAX INMEMORY
    run of the same config."""
    _, _, ref_w = _run_jax(f"{run_id}_ref", kw)
    for server_pkg, tag in ((fedml_tpu, "jsrv"), (fedml_tpu_torch, "tsrv")):
        got = mixed_federation(server_pkg, backend, f"{run_id}_{tag}", kw, n_ports)
        assert _max_err_of_scale(got, ref_w) <= MIXED_TOL, tag


def port_equals_inmemory(backend, run_id, kw=LR, n_ports=3):
    """The same seeded port federation over ``backend`` and over INMEMORY:
    equal metrics and params, bit for bit. Returns the backend's federation."""
    _, hist_a, wa = _run_port(f"{run_id}_mem", kw)
    LocalMqttBroker.reset(run_id)
    fed = on_free_ports(lambda base: Fed(fedml_tpu_torch, run_id, port_kw(backend, run_id, kw, base),
                                         backend=backend), n_ports)
    hist_b = _record_evals(fed)
    fed.run()
    LocalMqttBroker.reset(run_id)
    wb = _global(fed)
    assert hist_a == hist_b
    assert list(wa) == list(wb) and all(torch.equal(wa[k], wb[k]) for k in wa)
    return fed


# --- the frame ----------------------------------------------------------------

def _payload(dtype):
    """(JAX tree, port tree) of the same values: a flax-layout dict with a
    tuple, a list and None, leaves of ``dtype`` plus an int64 and an int32."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    if dtype == "bfloat16":
        bits = [(x.view(np.uint32) >> 16).astype(np.uint16) for x in (w, b)]
        jw, jb = (x.view(ml_dtypes.bfloat16) for x in bits)
        tw, tb = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) for x in bits)
    else:
        jw, jb, tw, tb = w, b, torch.from_numpy(w), torch.from_numpy(b)
    steps = np.arange(3, dtype=np.int64)
    ids = np.array([[1, 2]], dtype=np.int32)
    jtree = {"layer": {"kernel": jnp.asarray(jw), "bias": jb},
             "extra": (steps, None), "more": [ids]}
    ttree = {"layer": {"kernel": tw, "bias": tb},
             "extra": (torch.from_numpy(steps), None), "more": [torch.from_numpy(ids)]}
    return jtree, ttree


def _messages(dtype):
    jtree, ttree = _payload(dtype)
    out = []
    for cls, tree in ((JMessage, jtree), (TMessage, ttree)):
        m = cls(3, 2, 0)
        m.add_params("num_samples", 17)
        m.add_params(cls.MSG_ARG_KEY_MODEL_PARAMS, tree)
        out.append(m)
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return str(x.dtype).replace("torch.", ""), tuple(x.shape), t.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for item in tree for v in _leaves(item)]
    return [tree]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_frame_is_byte_equal_to_jax(dtype):
    jm, tm = _messages(dtype)
    jh, jbufs = jtrpc.encode_frame(jm)
    th, tbufs = ttrpc.encode_frame(tm)
    assert th == jh
    assert len(tbufs) == len(jbufs) == 4
    for t, j in zip(tbufs, jbufs):
        assert memoryview(t).cast("B").tobytes() == memoryview(j).cast("B").tobytes()
    header = th[4:].decode()
    assert f'"dtype": "{dtype}"' in header


def _over_socketpair(encode, recv, msg):
    a, b = socket.socketpair()
    try:
        header, bufs = encode(msg)
        a.sendall(header)
        for t in bufs:
            a.sendall(memoryview(t).cast("B"))
        return recv(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_frame(direction, dtype):
    jm, tm = _messages(dtype)
    if direction == "jax_to_port":
        back = _over_socketpair(jtrpc.encode_frame, ttrpc.recv_frame, jm)
        sent = jm
        assert all(isinstance(v, torch.Tensor) for v in
                   _leaves(back.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)) if v is not None)
    else:
        back = _over_socketpair(ttrpc.encode_frame, jtrpc.recv_frame, tm)
        sent = tm
    assert back.get_type() == 3 and back.get_sender_id() == 2 and back.get("num_samples") == 17
    got = back.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)
    ref = sent.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)
    assert got["extra"][1] is None and isinstance(got["extra"], tuple)
    assert isinstance(got["more"], list)
    g, r = _leaves(got), [v for v in _leaves(ref)]
    assert len(g) == len(r) == 5
    for x, y in zip(g, r):
        assert (x is None and y is None) or _bits(x) == _bits(y)


def test_frame_without_payload_both_ways():
    for cls, enc, rec in ((JMessage, jtrpc.encode_frame, ttrpc.recv_frame),
                          (TMessage, ttrpc.encode_frame, jtrpc.recv_frame)):
        back = _over_socketpair(enc, rec, cls(1, 0, 3))
        assert back.get_type() == 1 and back.get_receiver_id() == 3
        assert back.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS) is None


@pytest.mark.parametrize("recv", [jtrpc.recv_frame, ttrpc.recv_frame], ids=["jax", "port"])
def test_oversized_header_raises_value_error(recv):
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", 256 * 1024 * 1024 + 1))
        with pytest.raises(ValueError, match="exceeds cap"):
            recv(b)
    finally:
        a.close()
        b.close()


# --- managers -----------------------------------------------------------------

class _Inbox:
    def __init__(self):
        self.got = []
        self.ctx = []

    def receive_message(self, msg_type, msg):
        self.got.append(msg)
        self.ctx.append(ttc.current())


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.02)
    assert cond()


def _start(m, inbox):
    m.add_observer(inbox)
    t = threading.Thread(target=m.handle_receive_message, daemon=True)
    t.start()
    return t


def test_jax_and_port_managers_exchange_both_ways():
    """JAX rank 0 and port rank 1 on one block: a payload each way, the
    port's trace context read on the way back."""
    def build(base):
        m0 = jtrpc.TRPCCommManager(client_id=0, client_num=1, base_port=base)
        try:
            m1 = ttrpc.TRPCCommManager(client_id=1, client_num=1, base_port=base)
        except OSError:
            m0.stop_receive_message()
            raise
        return m0, m1

    m0, m1 = on_free_ports(build, 2)
    in0, in1 = _Inbox(), _Inbox()
    threads = [_start(m0, in0), _start(m1, in1)]
    try:
        msg = JMessage(7, 0, 1)
        msg.add_params(JMessage.MSG_ARG_KEY_MODEL_PARAMS, {"x": np.full((1024,), 3.0, np.float32)})
        m0.send_message(msg)
        _wait(lambda: in1.got)
        got = in1.got[0].get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)["x"]
        assert isinstance(got, torch.Tensor) and torch.equal(got, torch.full((1024,), 3.0))
        ctx = ttc.TraceContext(ttc.new_trace_id(), parent_span_id=5, round_idx=2)
        reply = TMessage(8, 1, 0)
        reply.add_params(TMessage.MSG_ARG_KEY_MODEL_PARAMS,
                         {"x": torch.full((16,), 4.0).bfloat16()})
        with ttc.activated(ctx):
            m1.send_message(reply)
        _wait(lambda: in0.got)
        back = in0.got[0]
        assert back.get_type() == 8
        assert back.get(JMessage.MSG_ARG_KEY_MODEL_PARAMS)["x"].dtype.name == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(back.get(JMessage.MSG_ARG_KEY_MODEL_PARAMS)["x"], np.float32), 4.0)
        assert ttc.extract(back) == ctx
    finally:
        m0.stop_receive_message()
        m1.stop_receive_message()
        for t in threads:
            t.join(10)


def test_send_survives_peer_restart():
    """A dead cached socket is dropped and the send retried on a fresh
    connection: the peer comes back on the same port."""
    def build(base):
        m0 = ttrpc.TRPCCommManager(client_id=0, client_num=1, base_port=base)
        try:
            m1 = ttrpc.TRPCCommManager(client_id=1, client_num=1, base_port=base)
        except OSError:
            m0.stop_receive_message()
            raise
        return base, m0, m1

    base, m0, m1 = on_free_ports(build, 2)
    inbox = _Inbox()
    try:
        t1 = _start(m1, inbox)
        m0.send_message(TMessage(1, 0, 1))
        _wait(lambda: inbox.got)
        m1.stop_receive_message()
        t1.join(10)
        m1b = ttrpc.TRPCCommManager(client_id=1, client_num=1, base_port=base)
        t1b = _start(m1b, inbox)
        try:
            msg = TMessage(2, 0, 1)
            msg.add_params(TMessage.MSG_ARG_KEY_MODEL_PARAMS, {"x": torch.ones(16)})
            m0.send_message(msg)  # the cached socket is dead: it reconnects
            _wait(lambda: len(inbox.got) == 2)
            assert inbox.got[1].get_type() == 2
        finally:
            m1b.stop_receive_message()
            t1b.join(10)
    finally:
        m0.stop_receive_message()


def test_a_taken_port_raises_naming_the_backend():
    def build(base):
        m0 = ttrpc.TRPCCommManager(client_id=0, client_num=1, base_port=base)
        return base, m0

    base, m0 = on_free_ports(build, 1)
    try:
        with socket.socket() as s:
            s.bind(("0.0.0.0", base + 1))
            s.listen(1)
            with pytest.raises(OSError) as info:
                ttrpc.TRPCCommManager(client_id=1, client_num=1, base_port=base)
            assert info.value.errno == errno.EADDRINUSE
    finally:
        m0.stop_receive_message()


# --- federations --------------------------------------------------------------

def test_mixed_federations_over_trpc_track_jax():
    assert_mixed_tracks_jax("TRPC", "ttrpc_mixed")


def test_port_federation_over_trpc_equals_inmemory():
    fed = port_equals_inmemory("TRPC", "ttrpc_det")
    cm = _manager(fed.runners[0]).com_manager
    assert type(cm).__name__ == "TRPCCommManager"


def test_a_bad_frame_drops_its_connection_and_the_manager_serves_on():
    """A stray connection that sends a hostile header is dropped (JAX's
    reader loop); a good frame on a fresh connection is still received."""
    def build(base):
        return base, ttrpc.TRPCCommManager(client_id=0, client_num=1, base_port=base)

    base, m0 = on_free_ports(build, 1)
    inbox = _Inbox()
    t0 = _start(m0, inbox)
    try:
        with socket.create_connection(("127.0.0.1", base), timeout=10) as s:
            s.sendall(struct.pack(">I", 256 * 1024 * 1024 + 1))
            s.settimeout(10)
            assert s.recv(1) == b""  # the manager closed it
        msg = TMessage(5, 1, 0)
        msg.add_params(TMessage.MSG_ARG_KEY_MODEL_PARAMS, {"x": torch.arange(4.0)})
        with socket.create_connection(("127.0.0.1", base), timeout=10) as s:
            header, bufs = ttrpc.encode_frame(msg)
            s.sendall(header)
            for b in bufs:
                s.sendall(memoryview(b).cast("B"))
            _wait(lambda: inbox.got)
        assert torch.equal(inbox.got[0].get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)["x"],
                           torch.arange(4.0))
    finally:
        m0.stop_receive_message()
        t0.join(10)


def test_ip_config_reads_as_jax_reads_it(tmp_path):
    from fedml_tpu.core.distributed.communication.grpc.grpc_comm_manager import (
        read_ip_config as jread)
    from fedml_tpu_torch.core.distributed.communication.ip_config import read_ip_config

    path = tmp_path / "ipconfig.csv"
    path.write_text("receiver_id,receiver_ip\n0,10.0.0.1\n2, 10.0.0.3 \nbad,row\n")
    assert read_ip_config(str(path), 4) == jread(str(path), 4) == \
        {0: "10.0.0.1", 1: "127.0.0.1", 2: "10.0.0.3", 3: "127.0.0.1"}
    assert read_ip_config(None, 2) == {0: "127.0.0.1", 1: "127.0.0.1"}


def test_free_port_block_is_bindable_and_below_the_ephemeral_range():
    base = free_port_block(3)
    assert 13000 <= base and base + 3 <= 19000
    socks = []
    try:
        for p in range(base, base + 3):
            s = socket.socket()
            socks.append(s)
            s.bind(("0.0.0.0", p))
    finally:
        for s in socks:
            s.close()
