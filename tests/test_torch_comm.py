"""The port's message plane against the JAX package's, on the CPU.

- the codec both ways: a tree of f32, bf16, int32 and int64 leaves with a
  tuple, a list and None, and a ResNet payload in the wire layout (flax
  names, kernels [in, out] / HWIO), written by either package and read by
  the other: equal dtype, shape and bits (exact: the framing is the same
  npz);
- frame errors: the port raises ValueError, with JAX's message, wherever
  JAX does;
- the brokers: INMEMORY's per-rank FIFO and stop, the local MQTT broker's
  retained backlog (the same deliveries as JAX's), and the socket broker
  between two port transports and between a JAX and a port transport on
  one JAX broker;
- the send retry's schedule, the cross-silo default config and the silo
  samplers: equal to JAX's.
"""

import json
import queue
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.distributed.communication import codec as jcodec
from fedml_tpu.core.distributed.communication import serialization as jser
from fedml_tpu.core.distributed.communication.message import Message as JMessage
from fedml_tpu.core.distributed.communication.mqtt_s3 import mqtt_transport as jmqtt
from fedml_tpu.core.distributed.communication.mqtt_s3 import socket_broker as jsock
from fedml_tpu.core.engine import round_engine as jengine
from fedml_tpu.core.resilience import retry as jretry
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models.model_hub import FedModel as JFedModel
from fedml_tpu_torch.core.distributed.communication import codec as tcodec
from fedml_tpu_torch.core.distributed.communication import serialization as tser
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.distributed.communication.inmemory.inmemory_comm_manager import (
    InMemoryCommManager)
from fedml_tpu_torch.core.distributed.communication.message import Message as TMessage
from fedml_tpu_torch.core.distributed.communication.mqtt_s3 import mqtt_transport as tmqtt
from fedml_tpu_torch.core.distributed.communication.mqtt_s3 import socket_broker as tsock
from fedml_tpu_torch.core.distributed.fedml_comm_manager import from_wire_layout, to_wire_layout
from fedml_tpu_torch.core.engine import round_engine as tengine
from fedml_tpu_torch.core.resilience import retry as tretry
from fedml_tpu_torch.models import resnet as tresnet
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

JOIN_S = 60


def _bits(x):
    """(dtype name, shape, raw bytes) of a numpy array, JAX array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return name, tuple(t.shape), raw
    a = np.ascontiguousarray(np.asarray(x))
    return a.dtype.name, a.shape, a.tobytes()


def _same_tree(got, ref):
    assert type(got) is type(ref) or (isinstance(got, dict) and isinstance(ref, dict)), \
        (type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            _same_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same_tree(g, r)
    elif ref is None:
        assert got is None
    else:
        assert _bits(got) == _bits(ref)


def _trees():
    """The same tree for both packages: JAX arrays and torch tensors."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 2)).astype(np.float32)
    i32 = rng.integers(-9, 9, (6,)).astype(np.int32)
    i64 = rng.integers(-2**40, 2**40, (2, 2)).astype(np.int64)
    scal = np.asarray([1.5], np.float32)  # 0-d leaves travel as [1] in both packages
    jtree = {"layer": {"w": jnp.asarray(f32), "b": jnp.asarray(bf, jnp.bfloat16)},
             "ints": (jnp.asarray(i32), np.asarray(i64)), "lst": [jnp.asarray(scal), None],
             "none": None}
    ttree = {"layer": {"w": torch.from_numpy(f32), "b": torch.from_numpy(bf).bfloat16()},
             "ints": (torch.from_numpy(i32), torch.from_numpy(i64)),
             "lst": [torch.from_numpy(scal), None], "none": None}
    return jtree, ttree


def test_codec_reads_jax_frames_and_jax_reads_the_ports():
    jtree, ttree = _trees()
    _same_tree(tser.deserialize_pytree(jser.serialize_pytree(jtree)), ttree)
    _same_tree(jax.device_get(jser.deserialize_pytree(tser.serialize_pytree(ttree))),
               jax.device_get(jtree))
    # whole frames, header fields and payload
    jm = JMessage(3, 1, 0)
    jm.add_params("num_samples", 42)
    jm.add_params(JMessage.MSG_ARG_KEY_MODEL_PARAMS, jtree)
    tm = tcodec.message_from_bytes(jcodec.message_to_bytes(jm))
    assert (tm.get_type(), tm.get_sender_id(), tm.get_receiver_id(), tm.get("num_samples")) == \
        (3, 1, 0, 42)
    _same_tree(tm.get(TMessage.MSG_ARG_KEY_MODEL_PARAMS), ttree)
    tm2 = TMessage(2, 0, 1)
    tm2.add_params("round_idx", 7)
    tm2.add_params(TMessage.MSG_ARG_KEY_MODEL_PARAMS, ttree)
    jm2 = jcodec.message_from_bytes(tcodec.message_to_bytes(tm2))
    assert (jm2.get_type(), jm2.get("round_idx")) == (2, 7)
    _same_tree(jax.device_get(jm2.get(JMessage.MSG_ARG_KEY_MODEL_PARAMS)), jax.device_get(jtree))


def test_a_tensor_on_any_device_goes_to_the_host_in_the_codec_only():
    """A non-contiguous tensor that requires grad serialises as its values."""
    w = torch.arange(12.0).reshape(3, 4).requires_grad_()
    back = tser.deserialize_pytree(tser.serialize_pytree({"w": w.T}))
    assert torch.equal(back["w"], w.detach().T) and back["w"].is_contiguous()


def test_resnet_payload_in_the_wire_layout_both_ways():
    """JAX's ResNet-8 params on the wire read by the port equal the port's
    state dict of the same params (params_from_jax), and the port's state
    dict sent in the wire layout reads in JAX as JAX's own params."""
    jfm = JFedModel(module=jresnet.ResNetCifar(depth=8), params=None, input_shape=(1, 32, 32, 3))
    p0 = jax.device_get(jfm.init_params(1))
    module = tresnet.ResNetCifar(depth=8)
    module.load_state_dict(params_from_jax(p0))
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    got = from_wire_layout(tser.deserialize_pytree(jser.serialize_pytree(p0)))
    assert sorted(got) == sorted(state)  # flax orders keys by name, torch by registration
    for k in state:
        assert _bits(got[k]) == _bits(state[k]) and got[k].is_contiguous(), k
    back = jax.device_get(jser.deserialize_pytree(tser.serialize_pytree(to_wire_layout(state))))
    _same_tree(back, p0)


def test_bf16_lora_adapters_convert_to_the_flax_layout_and_back_bit_exactly():
    """params_to_jax on a bf16 LoRA adapter subtree (numpy has no bf16 here:
    those leaves stay CPU tensors) and back through params_from_jax; through
    the wire, JAX reads the same bf16 bits in the same layout."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq_len=32, remat=False, lora_rank=4)
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    adapters = {k: torch.randn(v.shape, generator=gen).bfloat16()
                for k, v in model.state_dict().items() if "lora_" in k}
    assert len(adapters) == 2 * 4 * cfg.n_layers
    flax = params_to_jax(adapters)
    leaf = flax["layer_0"]["attn"]["q_proj"]
    assert set(leaf) == {"lora_a", "lora_b"} and leaf["lora_a"].dtype == torch.bfloat16
    back = params_from_jax(flax)
    for k, v in adapters.items():
        assert _bits(back[k]) == _bits(v), k
    jtree = jser.deserialize_pytree(tser.serialize_pytree(flax))
    ja = np.asarray(jtree["layer_0"]["attn"]["q_proj"]["lora_a"])
    assert ja.dtype.name == "bfloat16" and ja.shape == tuple(adapters["layer_0.attn.q_proj.lora_a"].shape)
    assert ja.view(np.uint16).tobytes() == _bits(adapters["layer_0.attn.q_proj.lora_a"])[2]
    # and a kernel in bf16 transposes like an f32 one
    w = torch.randn(5, 3).bfloat16()
    assert _bits(params_to_jax({"d.weight": w})["d"]["kernel"]) == _bits(w.T)


def _frame(header: bytes, payload: bytes = b"") -> bytes:
    return struct.pack(">I", len(header)) + header + payload


FRAMES = {
    "truncated_length": b"\x00\x01",
    "truncated_header": struct.pack(">I", 100) + b"{}",
    "corrupt_json": _frame(b"{abc:"),
    "non_object_header": _frame(b"[1, 2]"),
    "corrupt_payload": _frame(json.dumps({"msg_type": 3, "sender": 1, "receiver": 0}).encode(),
                              b"PK\x03\x04 not an npz"),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_frame_errors_raise_value_error_as_jax_does(case):
    data = FRAMES[case]
    with pytest.raises(ValueError) as ref:
        jcodec.message_from_bytes(data)
    with pytest.raises(ValueError) as got:
        tcodec.message_from_bytes(data)
    assert str(got.value) == str(ref.value)


# --- brokers -------------------------------------------------------------------

def test_inmemory_keeps_fifo_order_per_rank_and_stop_ends_the_loop():
    run_id = "test_torch_comm_fifo"
    InMemoryBroker.reset(run_id)
    seen = {1: [], 2: []}

    class Obs:
        def __init__(self, rank):
            self.rank = rank

        def receive_message(self, msg_type, msg):
            seen[self.rank].append((msg.get_sender_id(), msg.get("i")))

    managers = {r: InMemoryCommManager(run_id, r, 3) for r in (1, 2)}
    for r, m in managers.items():
        m.add_observer(Obs(r))
    sender = InMemoryCommManager(run_id, 0, 3)
    for i in range(50):
        for r in (1, 2):
            msg = TMessage(3, 0, r)
            msg.add_params("i", i)
            sender.send_message(msg)
    threads = [threading.Thread(target=m.handle_receive_message, daemon=True)
               for m in managers.values()]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_S
    while any(len(v) < 50 for v in seen.values()) and time.monotonic() < deadline:
        time.sleep(0.01)
    for m in managers.values():
        m.stop_receive_message()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "stop did not end the receive loop"
    assert seen == {r: [(0, i) for i in range(50)] for r in (1, 2)}
    InMemoryBroker.reset(run_id)


def _broker_script(mod, broker_id):
    """Publish before and after subscribing (and past the backlog cap); the
    deliveries each subscriber saw, in order."""
    mod.LocalMqttBroker.reset(broker_id)
    a = mod.LocalMqttTransport(broker_id, "a")
    b = mod.LocalMqttTransport(broker_id, "b")
    got = {"t1": [], "t2": []}
    for i in range(3):
        a.publish("t1", b"early%d" % i)
    for i in range(300):
        a.publish("t2", b"%d" % i)
    b.subscribe("t1", lambda topic, p: got[topic].append(p))
    a.publish("t1", b"late")
    b.subscribe("t2", lambda topic, p: got[topic].append(p))
    a.set_last_will("will", b"gone")
    b.subscribe("will", lambda topic, p: got.setdefault(topic, []).append(p))
    a.disconnect(graceful=False)
    mod.LocalMqttBroker.reset(broker_id)
    return got


def test_local_mqtt_broker_replays_retained_messages_as_jax_does():
    got = _broker_script(tmqtt, "test_torch_comm_local")
    assert got == _broker_script(jmqtt, "test_torch_comm_local")
    assert got["t1"] == [b"early0", b"early1", b"early2", b"late"]
    assert got["t2"] == [b"%d" % i for i in range(44, 300)] and got["will"] == [b"gone"]


def _round_trip(broker, pub_mod, sub_mod):
    inbox: "queue.Queue" = queue.Queue()
    sub = sub_mod.SocketMqttTransport(broker.address, client_id="sub")
    pub = pub_mod.SocketMqttTransport(broker.address, client_id="pub")
    try:
        sub.subscribe("fedml_x_0_1", lambda topic, p: inbox.put((topic, p)))
        time.sleep(0.2)  # the subscription reaches the broker
        payload = bytes(range(256)) * 40
        pub.publish("fedml_x_0_1", payload)
        assert inbox.get(timeout=JOIN_S) == ("fedml_x_0_1", payload)
        # the will of a connection that drops without a graceful goodbye
        sub.subscribe("will", lambda topic, p: inbox.put((topic, p)))
        time.sleep(0.2)
        pub.set_last_will("will", b"OFFLINE")
        time.sleep(0.2)
        pub._sock.shutdown(2)
        assert inbox.get(timeout=JOIN_S) == ("will", b"OFFLINE")
    finally:
        pub.disconnect(graceful=True)
        sub.disconnect(graceful=True)


def test_socket_broker_between_port_transports():
    broker = tsock.SocketMqttBroker(port=0)
    try:
        _round_trip(broker, tsock, tsock)
    finally:
        broker.stop()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_socket_broker_between_a_jax_and_a_port_transport(direction):
    broker = jsock.SocketMqttBroker(port=0)
    try:
        pub, sub = (jsock, tsock) if direction == "jax_to_port" else (tsock, jsock)
        _round_trip(broker, pub, sub)
    finally:
        broker.stop()


# --- the plumbing around the wire ----------------------------------------------

def test_send_retry_follows_jax_schedule():
    """The same policy from the same args, and the same retries, sleeps and
    final raise under the same injected clock and RNG."""
    args = fedml_tpu_torch.default_config("cross_silo", comm_retry_max_attempts=4,
                                          comm_retry_base_delay_s=0.1)
    jp, tp = jretry.RetryPolicy.from_args(args), tretry.RetryPolicy.from_args(args)
    assert jp == jretry.RetryPolicy(**vars(tp))
    assert tretry.RetryPolicy.from_args(
        fedml_tpu_torch.default_config("cross_silo", comm_retry_max_attempts=1)) is None

    def run(mod, policy, fail_times, exc):
        import random

        calls, sleeps = [], []

        def fn():
            calls.append(1)
            if len(calls) <= fail_times:
                raise exc
            return "ok"

        try:
            out = mod.retry_call(fn, policy=policy, label="t", sleep=sleeps.append,
                                 clock=lambda: 0.0, rng=random.Random(3))
        except type(exc) as e:
            out = f"raised {e!r}"
        return out, len(calls), sleeps

    for fails, exc in ((2, ConnectionError("x")), (9, ValueError("frame")), (1, KeyError("k"))):
        assert run(tretry, tp, fails, exc) == run(jretry, jp, fails, exc)


def test_cross_silo_default_config_is_jax_s():
    over = dict(run_id="7", rank=2, role="client", backend="MQTT_S3")
    ref = vars(fedml_tpu.default_config("cross_silo", **over))
    got = vars(fedml_tpu_torch.default_config("cross_silo", **over))
    assert got == ref


@pytest.mark.parametrize("total,per_round", [(2, 2), (10, 4), (16, 16), (5, 7), (100, 10)])
def test_silo_and_pool_sampling_are_bit_identical(total, per_round):
    pool = list(range(1, total + 1))
    for r in range(5):
        assert tengine.sample_silos(r, total, per_round) == jengine.sample_silos(r, total, per_round)
        assert tengine.sample_from_pool(r, pool, per_round) == \
            jengine.sample_from_pool(r, pool, per_round)
