"""Secure multi-party computation: the finite-field toolbox (counterpart of
``fedml_tpu/core/mpc``). SecAgg and LightSecAgg's round-barrier protocols
(``secagg.py``, ``lightsecagg.py``) are not ported (ROADMAP.md, Queue 1)."""

from .finite_field import (
    DEFAULT_PRIME,
    dequantize,
    dh_public_key,
    dh_shared_key,
    field_div,
    lagrange_coeffs,
    mod_inverse,
    quantize,
    shamir_reconstruct,
    shamir_share,
)

__all__ = [
    "DEFAULT_PRIME",
    "dequantize",
    "dh_public_key",
    "dh_shared_key",
    "field_div",
    "lagrange_coeffs",
    "mod_inverse",
    "quantize",
    "shamir_reconstruct",
    "shamir_share",
]
