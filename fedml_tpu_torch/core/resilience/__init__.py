"""core.resilience: the send retry policy and the async buffer's quorum
verdicts (counterpart of ``fedml_tpu/core/resilience``; quorum rounds, round
deadlines and durable round state are not ported: ROADMAP.md, Queue 1)."""
