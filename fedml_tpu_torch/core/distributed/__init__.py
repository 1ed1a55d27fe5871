"""core.distributed: the message plane (counterpart of
``fedml_tpu/core/distributed``): the INMEMORY and MQTT_S3 backends and
``FedMLCommManager``. The other backends, meshes, link probing and the
hierarchy are not ported (ROADMAP.md, Queue 1)."""
