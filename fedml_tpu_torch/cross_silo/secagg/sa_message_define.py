"""SecAgg (Bonawitz) message vocabulary: a copy of
``fedml_tpu/cross_silo/secagg/sa_message_define.py``.

Reference: ``cross_silo/secagg/sa_message_define.py``. Round order:

   1 S2C_INIT (model)
-> 5 C2S_PK (advertise fresh DH public key + commit to self-seed)
-> 2 S2C_KEY_DIRECTORY (all public keys)
-> 6 C2S_SHARE (Shamir shares of sk_i and b_i, one per peer, routed via server)
-> 3 S2C_SHARE_TO_CLIENT (forwarded share)
   ... clients train ...
-> 7 C2S_MASKED_MODEL (x + self mask + signed pairwise masks, GF(p))
-> 4 S2C_UNMASK_REQUEST (survivor/dropout lists)
-> 8 C2S_REVEAL (b-shares of survivors, sk-shares of dropouts)
-> 9 S2C_SYNC_MODEL_TO_CLIENT
"""


class MyMessage:
    MSG_TYPE_CONNECTION_IS_READY = 0

    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_KEY_DIRECTORY = 2
    MSG_TYPE_S2C_SHARE_TO_CLIENT = 3
    MSG_TYPE_S2C_UNMASK_REQUEST = 4
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 9
    MSG_TYPE_S2C_FINISH = 10

    # client -> server
    MSG_TYPE_C2S_PK = 5
    MSG_TYPE_C2S_SHARE = 6
    MSG_TYPE_C2S_MASKED_MODEL = 7
    MSG_TYPE_C2S_REVEAL = 8
    MSG_TYPE_C2S_CLIENT_STATUS = 11

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_PUBLIC_KEY = "public_key"
    MSG_ARG_KEY_KEY_DIRECTORY = "key_directory"
    MSG_ARG_KEY_CLIENT_ID = "client_id"
    MSG_ARG_KEY_SK_SHARE = "sk_share"
    MSG_ARG_KEY_B_SHARE = "b_share"
    MSG_ARG_KEY_SURVIVORS = "survivors"
    MSG_ARG_KEY_DROPOUTS = "dropouts"
    MSG_ARG_KEY_REVEAL = "reveal"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"

    MSG_CLIENT_STATUS_ONLINE = "ONLINE"
