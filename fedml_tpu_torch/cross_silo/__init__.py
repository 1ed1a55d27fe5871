"""cross_silo: the cross-silo front ("Octopus"), the counterpart of
``fedml_tpu/cross_silo``: the synchronous FedAvg server and client managers
over the message plane, sync and async, with windowed SecAgg and accounted
DP (``privacy``), and the round-barrier SecAgg and LightSecAgg fronts
(``secure_aggregation``: ``secagg/``, ``lightsecagg/``)."""

from .fedml_client import Client, FedMLCrossSiloClient
from .fedml_server import FedMLCrossSiloServer, Server

__all__ = ["Client", "Server", "FedMLCrossSiloClient", "FedMLCrossSiloServer"]
