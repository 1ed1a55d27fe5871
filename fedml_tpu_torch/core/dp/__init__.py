"""Differential privacy: the RDP budget accountant behind the accounted DP
fold (``core/privacy/dp.py``). The DP middleware of the JAX package's
``fedml_tpu/core/dp`` (``fedml_differential_privacy.py``, ``frames``,
``mechanisms``) is not ported (ROADMAP.md, Queue 1)."""
