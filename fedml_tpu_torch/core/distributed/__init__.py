"""core.distributed: the message plane (counterpart of
``fedml_tpu/core/distributed``): the INMEMORY, MQTT_S3, MQTT_WEB3,
MQTT_THETASTORE, TRPC and GRPC (and MPI) backends, ``FedMLCommManager`` and
the in-process edge->regional->root aggregation tree (``hierarchy.py``).
Meshes and link probing are not ported (ROADMAP.md, Queue 1)."""
