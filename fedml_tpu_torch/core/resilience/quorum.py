"""Quorum verdicts and counters: the part of
``fedml_tpu/core/resilience/quorum.py`` the async buffer returns.

The buffer (``core/aggregation/async_buffer.py``) judges each arrival with
this vocabulary, and the counter names render as the JAX package's
Prometheus series (``fedml_quorum_stale_accepted_total``, ...). The
synchronous quorum rounds themselves (``QuorumPolicy``, ``RoundQuorum``,
deadlines and over-provisioning) are not ported (ROADMAP.md, Queue 1).
"""

# counter names (prom.py renders fedml_<name with dots as _>_total)
STALE_ACCEPTED_COUNTER = "quorum.stale_accepted"
STALE_REJECTED_COUNTER = "quorum.stale_rejected"

ACCEPT = "accept"
# async-mode verdicts: an arrival trained on an older model version is either
# admitted with a decayed weight or refused past the admission cut
STALE_ACCEPTED = "stale_accepted"
STALE_REJECTED = "stale_rejected"
# modelwatch quarantine's verdict (a robust-z delta-norm outlier or a NaN
# delta); the port's buffer never returns it while modelwatch is not ported
OUTLIER_REJECTED = "outlier_rejected"
