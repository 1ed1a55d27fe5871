"""Cross-silo message vocabulary: a copy of
``fedml_tpu/cross_silo/message_define.py``. The type numbers and key strings
are the JAX package's, so a JAX party and a port party speak one protocol;
the port's managers handle the synchronous FedAvg types (link probing,
split learning and SecAgg are not ported: ROADMAP.md, Queue 1).

Reference: ``cross_silo/client/message_define.py`` + ``server/message_define.py``
(MyMessage). Same protocol constants so the §3.2 state machine is
recognizable: ONLINE -> INIT -> (MODEL <-> SYNC)* -> FINISH.
"""


class MyMessage:
    # connection
    MSG_TYPE_CONNECTION_IS_READY = 0

    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_S2C_CHECK_CLIENT_STATUS = 6
    MSG_TYPE_S2C_FINISH = 7

    # client -> server
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
    MSG_TYPE_C2S_CLIENT_STATUS = 5

    # link probing (core/distributed/link_probe.py drives, netlink records):
    # the server sends PROBE with an opaque monotonic timestamp + optional
    # pad; the client echoes both back so the originator measures RTT on its
    # own clock and bandwidth from the padded round trip
    MSG_TYPE_LINK_PROBE = 8
    MSG_TYPE_LINK_PROBE_ECHO = 9

    # split learning (fedml_tpu/split): the server owns the round — it opens
    # it with a version-stamped INIT_CONFIG, the client streams forward
    # activations as micro-batches (ACT), the server answers each with the
    # activation gradient (GRAD), and the client closes its round with DONE
    # after the local backward completes
    MSG_TYPE_S2C_SPLIT_INIT_CONFIG = 10
    MSG_TYPE_C2S_SPLIT_ACT = 11
    MSG_TYPE_S2C_SPLIT_GRAD = 12
    MSG_TYPE_C2S_SPLIT_DONE = 13

    # windowed async SecAgg (core/privacy): the server ANNOUNCEs a masking
    # window (id, nonce, cohort, grid spec) per async publish cohort; members
    # answer with their window DH public key; the server broadcasts the full
    # DIRECTORY once every key is in; members deal Shamir shares of their
    # window secret key through the server's SHARE_RELAY (a production
    # deployment encrypts each share under the recipient's pair key — the
    # relay never needs to read it). Masked uploads ride the normal
    # C2S_SEND_MODEL_TO_SERVER as a SECAGG payload dict. When the window
    # deadline fires with members missing, the server asks survivors to
    # REVEAL their shares of the dropped members' keys (mask-share reveal),
    # reconstructs, subtracts the stray masks, and publishes the partial
    # window under the quorum's partial-close discipline.
    MSG_TYPE_S2C_SECAGG_ANNOUNCE = 14
    MSG_TYPE_C2S_SECAGG_PUBKEY = 15
    MSG_TYPE_S2C_SECAGG_DIRECTORY = 16
    MSG_TYPE_C2S_SECAGG_SHARES = 17
    MSG_TYPE_S2C_SECAGG_SHARE_RELAY = 18
    MSG_TYPE_S2C_SECAGG_REVEAL_REQUEST = 19
    MSG_TYPE_C2S_SECAGG_REVEAL = 20

    # arg keys (routing lives in Message's own envelope fields; the old
    # TYPE/SENDER/RECEIVER duplicates were dead vocabulary and are gone)
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_CLIENT_OS = "client_os"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"
    # async (non-barrier) rounds: the server stamps every model sync with the
    # published model version; clients echo the version they trained on so
    # the async buffer's staleness policy can weight/admit the delta
    MSG_ARG_KEY_MODEL_VERSION = "model_version"
    # link probes: sequence number, originator send time (opaque to the
    # peer — echoed verbatim), declared pad size, and the pad itself
    MSG_ARG_KEY_PROBE_SEQ = "probe_seq"
    MSG_ARG_KEY_PROBE_T_SEND_NS = "probe_t_send_ns"
    MSG_ARG_KEY_PROBE_NBYTES = "probe_nbytes"
    MSG_ARG_KEY_PROBE_PAD = "probe_pad"
    # split learning: activations / targets travel C2S per micro-batch, the
    # activation gradient travels S2C; mb_idx keys reassembly (the broker's
    # throttle timers may reorder deliveries) and mb_count closes the window
    # windowed SecAgg: window identity + key-agreement material + the
    # mask-share reveal. COHORT/SPEC/THRESHOLD ride the ANNOUNCE; DIRECTORY
    # carries {rank: pk}; SHARES carries {peer_rank: share_ints} (dealer =
    # sender); SHARE_RELAY carries one (dealer, share) pair; REVEAL carries
    # {dropped_rank: share_ints}
    MSG_ARG_KEY_SECAGG_WINDOW_ID = "secagg_window_id"
    MSG_ARG_KEY_SECAGG_NONCE = "secagg_nonce"
    MSG_ARG_KEY_SECAGG_COHORT = "secagg_cohort"
    MSG_ARG_KEY_SECAGG_SPEC = "secagg_spec"
    MSG_ARG_KEY_SECAGG_THRESHOLD = "secagg_threshold"
    MSG_ARG_KEY_SECAGG_PUBKEY = "secagg_pubkey"
    MSG_ARG_KEY_SECAGG_SHARES = "secagg_shares"
    MSG_ARG_KEY_SECAGG_DEALER = "secagg_dealer"
    MSG_ARG_KEY_SECAGG_SHARE = "secagg_share"
    MSG_ARG_KEY_SECAGG_DROPPED = "secagg_dropped"
    MSG_ARG_KEY_SECAGG_REVEALS = "secagg_reveals"
    MSG_ARG_KEY_SPLIT_ACTS = "split_acts"
    MSG_ARG_KEY_SPLIT_TARGETS = "split_targets"
    MSG_ARG_KEY_SPLIT_GRADS = "split_grads"
    MSG_ARG_KEY_SPLIT_MB_IDX = "split_mb_idx"
    MSG_ARG_KEY_SPLIT_MB_COUNT = "split_mb_count"

    # statuses
    MSG_CLIENT_STATUS_OFFLINE = "OFFLINE"
    MSG_CLIENT_STATUS_IDLE = "IDLE"
    MSG_CLIENT_STATUS_ONLINE = "ONLINE"
    MSG_CLIENT_STATUS_FINISHED = "FINISHED"
