"""The port's reference pickle wire against the JAX package's, on the CPU.

- the two-field protobuf codec: ``encode_comm_request`` byte-equal to
  JAX's, and each package decodes the other's;
- the pickled message: each package decodes the other's
  ``encode_ref_message`` (f32 and bf16 leaves) to equal arrays, as torch
  tensors on the port's side; the top of the pickled payload is an
  OrderedDict from both encoders; the reference ``Message`` shim is one class in a process that loads
  both packages;
- the MQTT_S3 reference bucket: each package reads what the other wrote;
- the restricted unpickler refuses the same gadget globals as JAX's
  (``os.system``, ``builtins.eval``, ``torch.load``);
- federations over ``mqtt_s3_wire='fedml'`` (LR, 2 clients, 2 rounds, one
  shared bucket): a JAX server with two port clients and a port server
  (from the JAX initial params) with two JAX clients over a JAX socket
  broker, each final params within 1e-5 of their scale of the all-JAX run's
  (tests/test_torch_cross_silo.py's socket-broker tolerance); a port
  federation equal to INMEMORY, bit for bit. The gRPC reference wire's
  federations are in tests/test_torch_grpc.py.
"""

import collections
import io
import os
import pickle

import numpy as np
import pytest
import torch

import fedml_tpu_torch

from fedml_tpu.core.distributed.communication.grpc import ref_wire as jref
from fedml_tpu.core.distributed.communication.message import Message as JMessage
from fedml_tpu.core.distributed.communication.mqtt_s3.ref_bucket import RefBucketStore as JBucket
from fedml_tpu.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker
from fedml_tpu_torch.core.distributed.communication.grpc import ref_wire as tref
from fedml_tpu_torch.core.distributed.communication.message import Message as TMessage
from fedml_tpu_torch.core.distributed.communication.mqtt_s3.ref_bucket import RefBucketStore as TBucket
from tests.test_torch_trpc import (LR, _bits, _leaves, _manager, _payload,
                                   assert_mixed_tracks_jax, port_equals_inmemory)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("client_id,size", [(0, 0), (1, 5), (3, 200), (300, 70_000)])
def test_comm_request_bytes_equal_jax(client_id, size):
    body = bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8))
    data = tref.encode_comm_request(client_id, body)
    assert data == jref.encode_comm_request(client_id, body)
    assert tref.decode_comm_request(data) == jref.decode_comm_request(data) == (client_id, body)


def _tree(dtype, pkg):
    jtree, ttree = _payload(dtype)
    return {"layer": (jtree if pkg == "jax" else ttree)["layer"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_message(direction, dtype):
    src = "jax" if direction == "jax_to_port" else "port"
    cls, enc, dec = (JMessage, jref.encode_ref_message, tref.decode_ref_message) if src == "jax" \
        else (TMessage, tref.encode_ref_message, jref.decode_ref_message)
    msg = cls(3, 2, 0)
    msg.add_params("num_samples", 11)
    msg.add_params(cls.MSG_ARG_KEY_MODEL_PARAMS, _tree(dtype, src))
    data = enc(msg, 2)
    client_id, body = tref.decode_comm_request(data)
    assert client_id == 2
    # the pickled payload's top is an OrderedDict, from either encoder
    raw = tref._RefUnpickler(io.BytesIO(body)).load().msg_params
    assert isinstance(raw[TMessage.MSG_ARG_KEY_MODEL_PARAMS], collections.OrderedDict)
    back = dec(data)
    assert back.get_type() == 3 and back.get_sender_id() == 2 and back.get("num_samples") == 11
    got = back.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS)
    ref = _tree(dtype, "port")
    if src == "jax":
        assert all(isinstance(x, torch.Tensor) for x in _leaves(got))
        assert [_bits(x) for x in _leaves(got)] == [_bits(x) for x in _leaves(ref)]
    else:
        assert [_bits(np.asarray(x)) for x in _leaves(got)] == \
            [_bits(np.asarray(x)) for x in _leaves(_tree(dtype, "jax"))]


def test_the_reference_message_shim_is_one_class():
    assert tref._ensure_ref_message_class() is jref._ensure_ref_message_class()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ref_bucket_round_trips_both_ways(direction, dtype, tmp_path):
    writer, reader = (JBucket, TBucket) if direction == "jax_to_port" else (TBucket, JBucket)
    src = "jax" if direction == "jax_to_port" else "port"
    url = writer(str(tmp_path)).write_model("fedml_0_1_abc", _tree(dtype, src))
    assert url.startswith("file://") and os.path.exists(url[len("file://"):])
    got = reader(str(tmp_path)).read_model("fedml_0_1_abc")
    if reader is TBucket:
        assert isinstance(got, collections.OrderedDict)
        assert all(isinstance(x, torch.Tensor) for x in _leaves(got))
    # _bits names numpy's and torch's dtypes alike, so the two trees compare
    assert [_bits(x if isinstance(x, torch.Tensor) else np.asarray(x)) for x in _leaves(got)] \
        == [_bits(x) for x in _leaves(_tree(dtype, "port"))]


class _Gadget:
    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg

    def __reduce__(self):
        return self.fn, (self.arg,)


@pytest.mark.parametrize("gadget", [(os.system, "true"), (eval, "1 + 1"),
                                    (torch.load, "/nonexistent")],
                         ids=["os.system", "builtins.eval", "torch.load"])
def test_the_unpickler_refuses_the_gadgets_jax_refuses(gadget):
    blob = pickle.dumps({"w": _Gadget(*gadget)})
    msgs = []
    for ref in (jref, tref):
        with pytest.raises(pickle.UnpicklingError) as info:
            ref._RefUnpickler(io.BytesIO(blob)).load()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(pickle.UnpicklingError):
        tref.decode_ref_message(tref.encode_comm_request(1, blob))


def test_mixed_federations_over_the_mqtt_reference_wire_track_jax(tmp_path):
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(LR, mqtt_socket=broker.address, mqtt_s3_wire="fedml",
                  mqtt_s3_bucket_dir=str(tmp_path / "bucket"))
        assert_mixed_tracks_jax("MQTT_S3", "tref_mixed", kw=kw)
    finally:
        broker.stop()


def test_port_federation_over_the_mqtt_reference_wire_equals_inmemory(tmp_path):
    kw = dict(LR, mqtt_s3_wire="fedml", mqtt_s3_bucket_dir=str(tmp_path / "bucket"))
    fed = port_equals_inmemory("MQTT_S3", "tref_det", kw=kw)
    assert isinstance(_manager(fed.runners[0]).com_manager.store, TBucket)
    # 2 rounds x (2 downloads + 2 uploads), each a pickle under its own key
    assert len(list((tmp_path / "bucket").iterdir())) == 2 * (2 + 2)


def test_the_mqtt_reference_wire_needs_a_bucket():
    args = fedml_tpu_torch.default_config("cross_silo", **dict(
        LR, run_id="tref_nobucket", rank=0, role="server", backend="MQTT_S3", using_gpu=False,
        mqtt_s3_wire="fedml"))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    with pytest.raises(ValueError, match="mqtt_s3_bucket_dir"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
