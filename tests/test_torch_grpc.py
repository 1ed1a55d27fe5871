"""The port's GRPC (and MPI) backend against the JAX package's, on the CPU.

Needs the ``grpc`` package (skipped without it). Every party is a thread of
this process: the JAX package's multi-process gRPC federation has been seen
to idle forever in its receive loops.

- managers: a JAX manager and a port manager exchange a payload both ways,
  over the native wire (the codec's frame) and over the reference wire
  (``wire="fedml"``: a pickled ``CommRequest``), f32 and bf16 leaves,
  exactly; a port server refuses a port that is taken (no SO_REUSEPORT);
- the factory: MPI maps onto the gRPC manager;
- federations (LR, 2 clients, 2 rounds): a JAX server with two port clients
  and a port server (from the JAX initial params) with two JAX clients over
  GRPC, each final params within 1e-5 of their scale of the all-JAX run's
  (tests/test_torch_cross_silo.py's socket-broker tolerance), and the same
  over ``grpc_wire='fedml'``; port federations over GRPC, MPI and GRPC with
  the reference wire equal to INMEMORY, bit for bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("grpc")

import fedml_tpu_torch  # noqa: E402
from fedml_tpu.core.distributed.communication.grpc import grpc_comm_manager as jgrpc  # noqa: E402
from fedml_tpu.core.distributed.communication.message import Message as JMessage  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.grpc import grpc_comm_manager as tgrpc  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.message import Message as TMessage  # noqa: E402
from tests.test_torch_trpc import (LR, _bits, _Inbox, _manager, _payload, _start,  # noqa: E402
                                   _wait, assert_mixed_tracks_jax, on_free_ports,
                                   port_equals_inmemory)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(wire):
    def build(base):
        m0 = jgrpc.GRPCCommManager(client_id=0, client_num=1, base_port=base, wire=wire)
        try:
            m1 = tgrpc.GRPCCommManager(client_id=1, client_num=1, base_port=base, wire=wire)
        except OSError:
            m0.stop_receive_message()
            raise
        return m0, m1

    return on_free_ports(build, 2)


def _flat(tree):
    return [tree["layer"]["kernel"], tree["layer"]["bias"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["native", "fedml"])
def test_jax_and_port_managers_exchange_both_ways(wire, dtype):
    jtree, ttree = _payload(dtype)
    jtree = {"layer": jtree["layer"]}
    ttree = {"layer": ttree["layer"]}
    m0, m1 = _pair(wire)
    in0, in1 = _Inbox(), _Inbox()
    threads = [_start(m0, in0), _start(m1, in1)]
    try:
        msg = JMessage(7, 0, 1)
        msg.add_params("num_samples", 5)
        msg.add_params(JMessage.MSG_ARG_KEY_MODEL_PARAMS, jtree)
        m0.send_message(msg)
        _wait(lambda: in1.got)
        got = in1.got[0]
        assert got.get_type() == 7 and got.get("num_samples") == 5
        for x, y in zip(_flat(got.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)), _flat(ttree)):
            assert isinstance(x, torch.Tensor) and _bits(x) == _bits(y)
        reply = TMessage(8, 1, 0)
        reply.add_params(TMessage.MSG_ARG_KEY_MODEL_PARAMS, ttree)
        m1.send_message(reply)
        _wait(lambda: in0.got)
        back = in0.got[0].get(JMessage.MSG_ARG_KEY_MODEL_PARAMS)
        for x, y in zip(_flat(back), _flat(jtree)):
            assert _bits(np.asarray(x)) == _bits(y)
    finally:
        m0.stop_receive_message()
        m1.stop_receive_message()
        for t in threads:
            t.join(10)


def test_a_taken_port_is_refused():
    """No SO_REUSEPORT: a second server on a taken port fails to bind
    instead of sharing the port and taking some of its peer's messages."""
    def build(base):
        return base, tgrpc.GRPCCommManager(client_id=0, client_num=1, base_port=base)

    base, m0 = on_free_ports(build, 1)
    try:
        with pytest.raises(OSError, match="cannot bind"):
            tgrpc.GRPCCommManager(client_id=0, client_num=1, base_port=base)
    finally:
        m0.stop_receive_message()


def test_mpi_maps_onto_grpc():
    fed = port_equals_inmemory("MPI", "tgrpc_mpi")
    for runner in fed.runners.values():
        assert type(_manager(runner).com_manager).__name__ == "GRPCCommManager"


def test_mixed_federations_over_grpc_track_jax():
    assert_mixed_tracks_jax("GRPC", "tgrpc_mixed")


def test_mixed_federations_over_the_grpc_reference_wire_track_jax():
    assert_mixed_tracks_jax("GRPC", "tgrpc_refmix", kw=dict(LR, grpc_wire="fedml"))


@pytest.mark.parametrize("wire", ["native", "fedml"])
def test_port_federation_over_grpc_equals_inmemory(wire):
    fed = port_equals_inmemory("GRPC", f"tgrpc_det_{wire}", kw=dict(LR, grpc_wire=wire))
    assert all(_manager(r).com_manager.wire == wire for r in fed.runners.values())



def test_an_unknown_wire_is_refused():
    with pytest.raises(ValueError, match="grpc_wire"):
        tgrpc.GRPCCommManager(client_id=0, client_num=1, base_port=1, wire="protobuf")
