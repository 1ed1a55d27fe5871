"""Secure multi-party computation: the finite-field toolbox, SecAgg and
LightSecAgg (counterpart of ``fedml_tpu/core/mpc``).

Reference parity: python/fedml/core/mpc/{secagg.py,lightsecagg.py} plus the
cross_silo/{secagg,lightsecagg} protocol managers.
"""

from .finite_field import (
    DEFAULT_PRIME,
    additive_shares,
    dequantize,
    dh_public_key,
    dh_shared_key,
    field_div,
    flatten_finite,
    lagrange_coeffs,
    lcc_decode,
    lcc_encode,
    mod_inverse,
    quantize,
    shamir_reconstruct,
    shamir_share,
    tree_dimensions,
    tree_from_finite,
    tree_to_finite,
    unflatten_finite,
)
from .lightsecagg import (
    ClientMaskState,
    LightSecAggConfig,
    aggregate_encoded_mask,
    decode_aggregate_mask,
    encode_mask,
    exchange_shares,
    mask_vector,
    unmask_aggregate,
)
from .secagg import SecAggClient, SecAggConfig, SecAggServer, prg_mask, run_secagg_round

__all__ = [
    "DEFAULT_PRIME",
    "additive_shares",
    "dequantize",
    "dh_public_key",
    "dh_shared_key",
    "field_div",
    "flatten_finite",
    "lagrange_coeffs",
    "lcc_decode",
    "lcc_encode",
    "mod_inverse",
    "quantize",
    "shamir_reconstruct",
    "shamir_share",
    "tree_dimensions",
    "tree_from_finite",
    "tree_to_finite",
    "unflatten_finite",
    "ClientMaskState",
    "LightSecAggConfig",
    "aggregate_encoded_mask",
    "decode_aggregate_mask",
    "encode_mask",
    "exchange_shares",
    "mask_vector",
    "unmask_aggregate",
    "SecAggClient",
    "SecAggConfig",
    "SecAggServer",
    "prg_mask",
    "run_secagg_round",
]
