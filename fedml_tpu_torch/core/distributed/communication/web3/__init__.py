"""Decentralized-storage comm backends (reference: communication/mqtt_web3,
mqtt_thetastore + core/distributed/distributed_storage/): the port's
counterpart of ``fedml_tpu/core/distributed/communication/web3/``."""

from .distributed_storage import LocalCASStore, ThetaStorage, Web3Storage, create_cas_store
from .mqtt_web3_comm_manager import MqttThetastoreCommManager, MqttWeb3CommManager

__all__ = [
    "LocalCASStore",
    "Web3Storage",
    "ThetaStorage",
    "create_cas_store",
    "MqttWeb3CommManager",
    "MqttThetastoreCommManager",
]
