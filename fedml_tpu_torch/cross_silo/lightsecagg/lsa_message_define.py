"""LightSecAgg message vocabulary: a copy of
``fedml_tpu/cross_silo/lightsecagg/lsa_message_define.py``.

Reference: ``cross_silo/lightsecagg/lsa_message_define.py`` — protocol order:

   1 S2C_INIT (model)
-> 5 C2S_SEND_ENCODED_MASK (client i's share for client j, routed via server)
-> 2 S2C_ENCODED_MASK_TO_CLIENT (server forwards the share)
   ... clients train ...
-> 6 C2S_SEND_MODEL (masked, finite-field flat vector)
-> 4 S2C_SEND_TO_ACTIVE_CLIENT (server asks actives for aggregate masks)
-> 7 C2S_SEND_MASK (aggregate encoded mask over the active set)
   ... server reconstructs & aggregates ...
-> 3 S2C_SYNC_MODEL_TO_CLIENT
"""


class MyMessage:
    MSG_TYPE_CONNECTION_IS_READY = 0

    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT = 2
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 3
    MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT = 4
    MSG_TYPE_S2C_FINISH = 10

    # client -> server
    MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER = 5
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 6
    MSG_TYPE_C2S_SEND_MASK_TO_SERVER = 7
    MSG_TYPE_C2S_CLIENT_STATUS = 8

    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_ENCODED_MASK = "encoded_mask"
    MSG_ARG_KEY_ACTIVE_CLIENTS = "active_clients"
    MSG_ARG_KEY_AGGREGATE_ENCODED_MASK = "aggregate_encoded_mask"
    MSG_ARG_KEY_CLIENT_ID = "client_id"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"

    MSG_CLIENT_STATUS_ONLINE = "ONLINE"
