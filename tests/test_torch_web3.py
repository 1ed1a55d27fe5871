"""The port's MQTT_WEB3 and MQTT_THETASTORE backends against the JAX
package's, on the CPU.

- the content-addressed store: the same params written by a JAX party and
  a port party get the same cid (the port's wire-layout tree serializes to
  JAX's bytes, flax's key order included), and each package reads the
  other's object; identical content dedupes; a corrupted object fails its
  integrity check in both; the remote stores refuse clearly, with JAX's
  messages; a web3 manager refuses the MQTT_S3 reference wire;
- federations (LR, 2 clients, 2 rounds, one shared ``cas_root``): a JAX
  server with two port clients and a port server (from the JAX initial
  params) with two JAX clients over a JAX socket broker, on both backends,
  each final params within 1e-5 of their scale of the all-JAX run's
  (tests/test_torch_cross_silo.py's socket-broker tolerance); port
  federations over each backend equal to INMEMORY, bit for bit, with 6
  objects for 8 payloads (the two copies of each round's global dedupe).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker
from fedml_tpu.core.distributed.communication.web3 import distributed_storage as jcas
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models.model_hub import FedModel as JFedModel
from fedml_tpu_torch.core.distributed.communication.web3 import distributed_storage as tcas
from fedml_tpu_torch.core.distributed.fedml_comm_manager import to_wire_layout
from fedml_tpu_torch.models.convert import params_from_jax
from tests.test_torch_trpc import (LR, _bits, _leaves, _manager, assert_mixed_tracks_jax,
                                   port_equals_inmemory)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resnet8_params():
    """JAX's ResNet-8 params as a JAX tree operation leaves them (keys
    sorted at every level, as any round's global is), and the port's state
    dict of the same values."""
    jfm = JFedModel(module=jresnet.ResNetCifar(depth=8), params=None, input_shape=(1, 32, 32, 3))
    p = jax.device_get(jax.tree.map(lambda x: x, jfm.init_params(1)))
    return p, params_from_jax(p)


def test_cids_are_equal_between_the_packages(tmp_path):
    jparams, state = _resnet8_params()
    jstore, tstore = jcas.LocalCASStore(str(tmp_path / "j")), tcas.LocalCASStore(str(tmp_path / "t"))
    jurl = jstore.write_model("k", jparams)
    turl = tstore.write_model("k", to_wire_layout(state))
    assert jurl == turl and jurl.startswith("cas://")
    assert (tmp_path / "j" / jurl[6:]).read_bytes() == (tmp_path / "t" / turl[6:]).read_bytes()
    # each reads the other's object
    back = tcas.LocalCASStore(str(tmp_path / "j")).read_model(jurl)
    assert [_bits(x) for x in _leaves(back)] == [_bits(np.asarray(x)) for x in _leaves(jparams)]
    jback = jcas.LocalCASStore(str(tmp_path / "t")).read_model(turl)
    assert [_bits(np.asarray(x)) for x in _leaves(jback)] == \
        [_bits(np.asarray(x)) for x in _leaves(jparams)]


def test_identical_content_dedupes_to_one_cid(tmp_path):
    store = tcas.LocalCASStore(str(tmp_path))
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    url1 = store.write_model("k1", tree)
    url2 = store.write_model("completely_different_key", {"w": tree["w"].clone()})
    assert url1 == url2 and len(list(tmp_path.iterdir())) == 1
    assert torch.equal(store.read_model(url1)["w"], tree["w"])


@pytest.mark.parametrize("pkg", [jcas, tcas], ids=["jax", "port"])
def test_a_corrupted_object_fails_its_integrity_check(pkg, tmp_path):
    store = pkg.LocalCASStore(str(tmp_path))
    url = store.write_model("k", {"w": np.ones(3, np.float32)})
    with open(store._path(url[len("cas://"):]), "ab") as f:
        f.write(b"corruption")
    with pytest.raises(IOError, match="integrity"):
        store.read_model(url)


@pytest.mark.parametrize("store", ["Web3Storage", "ThetaStorage"])
def test_remote_stores_refuse_as_jax_does(store):
    msgs = []
    for pkg in (jcas, tcas):
        with pytest.raises(RuntimeError) as info:
            getattr(pkg, store)(SimpleNamespace())
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert isinstance(tcas.create_cas_store(SimpleNamespace(distributed_storage="local",
                                                            cas_root=None)), tcas.LocalCASStore)
    with pytest.raises(RuntimeError, match="theta_store_url"):
        tcas.create_cas_store(SimpleNamespace(distributed_storage="theta"))


@pytest.mark.parametrize("backend", ["MQTT_WEB3", "MQTT_THETASTORE"])
def test_web3_managers_refuse_the_reference_wire(backend, tmp_path):
    args = fedml_tpu_torch.default_config("cross_silo", **dict(
        LR, run_id=f"tweb3_refuse_{backend}", rank=0, role="server", backend=backend,
        using_gpu=False, cas_root=str(tmp_path), mqtt_s3_wire="fedml"))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    with pytest.raises(ValueError, match="content id"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)


@pytest.mark.parametrize("backend", ["MQTT_WEB3", "MQTT_THETASTORE"])
def test_mixed_federations_track_jax(backend, tmp_path):
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(LR, mqtt_socket=broker.address, cas_root=str(tmp_path / "cas"))
        assert_mixed_tracks_jax(backend, f"tweb3_mixed_{backend.lower()}", kw=kw)
    finally:
        broker.stop()
    assert any((tmp_path / "cas").iterdir())


@pytest.mark.parametrize("backend", ["MQTT_WEB3", "MQTT_THETASTORE"])
def test_port_federation_equals_inmemory(backend, tmp_path):
    kw = dict(LR, cas_root=str(tmp_path / "cas"))
    fed = port_equals_inmemory(backend, f"tweb3_det_{backend.lower()}", kw=kw)
    cm = _manager(fed.runners[0]).com_manager
    assert isinstance(cm.store, tcas.LocalCASStore)
    # 2 rounds x (2 downloads of one global + 2 uploads): the downloads dedupe
    assert len(list((tmp_path / "cas").iterdir())) == 2 * (1 + 2)


def test_a_thetastore_party_with_a_remote_store_refuses(tmp_path):
    """MQTT_THETASTORE takes the local CAS store only when no
    ``distributed_storage`` is set; a remote store raises, naming its
    endpoint, before the party starts."""
    args = fedml_tpu_torch.default_config("cross_silo", **dict(
        LR, run_id="tweb3_theta_remote", rank=0, role="server", backend="MQTT_THETASTORE",
        using_gpu=False, distributed_storage="theta"))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    with pytest.raises(RuntimeError, match="theta_store_url"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
