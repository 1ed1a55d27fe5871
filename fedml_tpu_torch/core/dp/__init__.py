"""Differential privacy: the DP middleware (``fedml_differential_privacy.py``
with its ``frames`` and ``mechanisms``, turned on by ``enable_dp``) and the
RDP budget accountant it shares with the accounted DP fold
(``core/privacy/dp.py``, ``privacy: dp``). The two knobs are independent, as
in the JAX package."""
