"""core.resilience: the send retry policy (counterpart of
``fedml_tpu/core/resilience``; quorum rounds, round deadlines and durable
round state are not ported: ROADMAP.md, Queue 1)."""
