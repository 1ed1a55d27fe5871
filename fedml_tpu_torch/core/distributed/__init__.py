"""core.distributed: the message plane (counterpart of
``fedml_tpu/core/distributed``): the INMEMORY and MQTT_S3 backends,
``FedMLCommManager`` and the in-process edge->regional->root aggregation
tree (``hierarchy.py``). The other backends, meshes and link probing are not
ported (ROADMAP.md, Queue 1)."""
