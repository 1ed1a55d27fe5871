"""DP noise mechanisms: counterpart of ``fedml_tpu/core/dp/mechanisms``."""

from .gaussian import DeviceGenerators, Gaussian, add_gaussian_noise
from .laplace import Laplace


def create_mechanism(name: str, *, epsilon: float, delta: float = 0.0, sensitivity: float = 1.0):
    """The mechanism ``name`` names (reference core/dp/common/utils.py
    check_params and each frame's construction)."""
    name = str(name).lower()
    if name == "gaussian":
        return Gaussian(epsilon=epsilon, delta=delta, sensitivity=sensitivity)
    if name == "laplace":
        return Laplace(epsilon=epsilon, sensitivity=sensitivity)
    raise ValueError(f"unknown DP mechanism {name!r}")


__all__ = ["DeviceGenerators", "Gaussian", "Laplace", "add_gaussian_noise", "create_mechanism"]
