"""Collective (device-grouped) FL simulation (reference: simulation/nccl/)."""

from .collective_sim import CollectiveSimulator, FedML_Collective_init

__all__ = ["CollectiveSimulator", "FedML_Collective_init"]
