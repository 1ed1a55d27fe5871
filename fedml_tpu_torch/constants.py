"""Platform / backend / algorithm constants.

A copy of ``fedml_tpu/constants.py`` (reference ``python/fedml/constants.py``):
the same vocabulary, so a config written for the JAX package drives the port
unchanged. Of the simulation backends the port runs ``sp`` and ``vmap``; the
others raise (ROADMAP.md, Queue 1).
"""

# --- training types (reference: constants.py FEDML_TRAINING_PLATFORM_*) ---
FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"
FEDML_TRAINING_PLATFORM_CROSS_SILO = "cross_silo"
FEDML_TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"
FEDML_TRAINING_PLATFORM_CROSS_CLOUD = "cross_cloud"
FEDML_TRAINING_PLATFORM_SERVING = "model_serving"

# --- simulation backends (reference: Parrot sp / MPI / NCCL) ---
FEDML_SIMULATION_TYPE_SP = "sp"            # single-process, device-resident
FEDML_SIMULATION_TYPE_VMAP = "vmap"        # TPU-native: vmap over the client dim
FEDML_SIMULATION_TYPE_MPI = "MPI"          # multi-process over the message plane
FEDML_SIMULATION_TYPE_NCCL = "NCCL"        # collective sim -> jax collectives

# --- cross-silo scenarios (reference: __init__.py:330-420) ---
CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

# --- communication backends (reference: core/distributed §2.b) ---
COMM_BACKEND_INMEMORY = "INMEMORY"   # deterministic test seam (new; SURVEY §4)
COMM_BACKEND_GRPC = "GRPC"
COMM_BACKEND_MQTT_S3 = "MQTT_S3"
COMM_BACKEND_MPI = "MPI"
COMM_BACKEND_TRPC = "TRPC"
COMM_BACKEND_MQTT_WEB3 = "MQTT_WEB3"
COMM_BACKEND_MQTT_THETASTORE = "MQTT_THETASTORE"

# --- federated optimizers (reference: ml/aggregator/agg_operator.py) ---
FEDML_FEDERATED_OPTIMIZER_FEDAVG = "FedAvg"
FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ = "FedAvg_seq"
FEDML_FEDERATED_OPTIMIZER_FEDPROX = "FedProx"
FEDML_FEDERATED_OPTIMIZER_FEDOPT = "FedOpt"
FEDML_FEDERATED_OPTIMIZER_FEDNOVA = "FedNova"
FEDML_FEDERATED_OPTIMIZER_FEDDYN = "FedDyn"
FEDML_FEDERATED_OPTIMIZER_SCAFFOLD = "SCAFFOLD"
FEDML_FEDERATED_OPTIMIZER_MIME = "Mime"
FEDML_FEDERATED_OPTIMIZER_FEDGAN = "FedGAN"
FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG = "Async_FedAvg"
FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL = "HierarchicalFL"
FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE = "TA"
FEDML_FEDERATED_OPTIMIZER_DECENTRALIZED_FL = "decentralized_fl"
FEDML_FEDERATED_OPTIMIZER_VERTICAL_FL = "classical_vertical"
FEDML_FEDERATED_OPTIMIZER_SPLIT_NN = "split_nn"
FEDML_FEDERATED_OPTIMIZER_FEDGKT = "FedGKT"
FEDML_FEDERATED_OPTIMIZER_FEDNAS = "FedNAS"
FEDML_FEDERATED_OPTIMIZER_FEDSEG = "FedSeg"

# --- roles ---
ROLE_SERVER = "server"
ROLE_CLIENT = "client"

# --- message-plane defaults (reference: communication/constants.py) ---
GRPC_BASE_PORT = 8890
TRPC_BASE_PORT = 9890
