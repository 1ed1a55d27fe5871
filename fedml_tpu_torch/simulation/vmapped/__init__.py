"""The client-batched simulator (counterpart of ``fedml_tpu/simulation/vmapped``):
``VmapFedAvgAPI``. The async driver is not ported yet (ROADMAP.md, Queue 1)."""
