"""MQTT + decentralized-storage comm managers: the port's counterpart of
``fedml_tpu/core/distributed/communication/web3/mqtt_web3_comm_manager.py``.

Reference: ``communication/mqtt_web3/mqtt_web3_comm_manager.py`` and
``mqtt_thetastore/mqtt_thetastore_comm_manager.py``: the control plane of
MQTT_S3, payloads in a content-addressed store instead of S3. Here that is
the MQTT_S3 manager with its payload store swapped (``_create_store``), so
the topic scheme, last will and queueing stay in one place.
"""

from __future__ import annotations

from ..mqtt_s3.mqtt_s3_comm_manager import MqttS3MultiClientsCommManager
from .distributed_storage import LocalCASStore, create_cas_store


def _refuse_ref_wire(manager) -> None:
    # the reference pickle wire addresses payloads by bucket key, which a
    # content-addressed store cannot resolve
    if manager.ref_wire:
        raise ValueError("mqtt_s3_wire='fedml' is the MQTT_S3 backend's reference wire; "
                         f"{type(manager).__name__} addresses payloads by content id")


class MqttWeb3CommManager(MqttS3MultiClientsCommManager):
    """Reference: mqtt_web3_comm_manager.py MqttWeb3CommManager."""

    def _create_store(self, args):
        _refuse_ref_wire(self)
        return create_cas_store(args)


class MqttThetastoreCommManager(MqttS3MultiClientsCommManager):
    """Reference: mqtt_thetastore_comm_manager.py MqttThetastoreCommManager.
    Without a configured store the local content-addressed store stands in
    (the same cid semantics)."""

    def _create_store(self, args):
        _refuse_ref_wire(self)
        if not getattr(args, "distributed_storage", None):
            return LocalCASStore(getattr(args, "cas_root", None))
        return create_cas_store(args)
