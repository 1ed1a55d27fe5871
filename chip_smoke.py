#!/usr/bin/env python3
"""Chip smoke for fedml_tpu_torch: the FedLLM LoRA train step, LLM serving,
the sp and vmapped FedAvg rounds, the FedNova, SCAFFOLD, FedDyn and Mime
algorithms, the cross-silo front, async federation with the compressed
uplink, durable round state, quorum rounds and the chaos drills, private
aggregation (windowed SecAgg and accounted DP), the round-barrier SecAgg
and LightSecAgg fronts, and the edge->regional->root aggregation tree with
its tier-masked SecAgg, the message plane's other backends (TRPC, GRPC
and MPI, MQTT_WEB3, the reference wire), the trust middleware (DP,
attacks and defenses, contribution), FHE's ciphertext leaves with the
sp simulator's other APIs (TurboAggregate, FedAvg_seq, split NN, FedGKT,
decentralized and vertical FL), FedGAN, FedNAS, FedSeg with the rest
of the model hub (MobileNet, EfficientNet-lite, the LSTMs, the text
classifier), a user's own files (the dataset readers, the C++ data
plane, HF llama checkpoints), serving's front door (the HTTP runner,
subprocess replicas behind the gateway, int8 decode through the int8
GEMM), and the LoRA step at Phi-3-mini's and Gemma-2B's attention widths
(head dims 96 and 256) and JAX's own test geometry (16) in f32 and
float16, on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; no phase swallows an
exception):

1. device: the card's name and power limit (nvidia-smi) and the versions;
2. build: the three flash-attention kernels and the int8 GEMM from
   ops/csrc with nvcc, at first use, with the build time and ptxas's
   registers and spills of every kernel; every wgmma kernel (bf16 and f16
   at the padded widths 64, 128 and 256: six a flash kernel) and every
   tensor-core instance of the int8 GEMM must build without spills, and no
   kernel with a ptxas performance advisory (C75xx, such as "wgmma
   serialized");
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice shapes (B=2, T=2048, Hq=32, D=128, bf16; causal, dense, GQA with
   Hkv=8, ragged T=2000, f32) and then every compiled instance
   (instance_sweep: head dims SWEEP_DIMS, among them 8 and 16 below a
   64-column tile, 80 and 96 inside a 128-column one and 136 with a
   sub-tile wholly past d, in bf16, float16 and f32, every tile pair of
   ops/flash_attention.py's TILES at each padded width, causal and dense,
   GQA 8/2 and MQA 8/1 at T=200 and, for the 16-bit kernels, T=96, below
   one tile; and B*Hq=65,536 in each dtype), checking O, lse, dQ, dK and dV
   row by row; then timings of each kernel, its plain version and torch's
   scaled_dot_product_attention as a yardstick (the port never calls it),
   at the slice shape, of dQ and dK/dV at the GQA shape, and of all three at
   phase 22's attention shapes (B=2, T=2048, bf16, causal: Hq=Hkv=32 at
   D=96, Hq=8 Hkv=1 at D=256), each the mean over back-to-back calls
   (fedml_tpu_torch/tools/compare_kernels.py cuda_ms), the bound from the
   real head dim;
4. train step: LLMTrainer.train for 3 steps at Llama-2-7B widths (d_model
   4096, 32 heads, d_ff 11008, vocab 32000) cut to 2 layers, bf16 compute,
   f32 params, LoRA rank 8 on q/k/v/o, seq_len 2048, batch 2: finite loss,
   adapters moved, base weights bit-unchanged;
5. client round: LLMClientTrainer set_model_params -> train -> get_model_params;
   adapter keys equal split_lora's paths and the round moves them.
   Launch counts are zeroed before phase 4 and read after phase 5: each kernel
   must have run exactly as often as those steps imply, and every launch on
   the design KERNELS names, as the kernels' C entry points count them by
   design (all three bf16 kernels on their wgmma/TMA designs);
6. serve: Llama-2-7B's widths cut to SERVE_LAYERS (4) of its 32 layers
   (max_seq_len 4096), bf16 weights drawn on the card from a seed, through
   every serving entry point.
   (a) the keystone: prefill 128 tokens at B=2, then 32 single-token steps,
   each row of logits within KEY_RTOL of the full non-cached forward, and the
   same gate refusing a cache whose write index is off by one either way;
   (b) 8 greedy requests of 17-300 tokens (two share a system prompt of at
   least 4 pages, one stops on an EOS id) and 2 sampled ones through
   generate, generate_batch, LLMPredictor.predict / predict_many and the slot
   (8 slots, chunk 8) and paged (page 16, 1024 pages) engines: every greedy
   token within GREEDY_TOL of its row's max logit, teacher-forced; the prefix
   hit counted; no page leaked; a seeded sampled request the same twice; no
   flash launch in the phase; (c) prefill ms (B=1, P=512), decode ms per
   token at B=1 and 8 (generate_batch, and the engines' chunks), the
   engines' tokens/s and the peak memory of each part;
7. FedAvg: the sp simulator's round through the user's entry points (init,
   get_device, data.load, model.create, FedMLRunner). (a) Parrot config 1
   (examples/quick_start/parrot/fedml_config.yaml: LR, MNIST surrogate, 2
   clients, 10 rounds) on the card and on the CPU from the same seeded
   params, every eval round and the final params within PARROT_* of each
   other; (b) ResNet-56 at full width on the CIFAR-10 surrogate: one
   client's local round on the card against the CPU with cuDNN's TF32 off
   (R56_*), then 16 clients, all in every round, for 3 rounds on the card in
   the port's documented precision (PyTorch's defaults: TF32 convolutions,
   f32 matmuls): finite losses, w_global moved, the last round's fold within
   FOLD_TOL of the float64 weighted mean of its 16 w_locals; round seconds,
   rounds/hr, local steps/s, images/s (over the round), the round's split from the fedavg.*
   spans, peak memory and test_acc per round (reported, not gated); no flash
   launch in the phase;
8. vmapped FedAvg: the same ResNet-56 x 16 clients through the client-batched
   simulator (backend "vmap", FedMLRunner -> SimulatorVmap -> VmapFedAvgAPI),
   3 rounds in the port's documented precision. (c) first, with cuDNN's TF32
   off: the vmapped local round of 4 clients over their first 2 steps, the
   last client's second step padded as _stack_clients pads a short shard,
   against the same functional step run client by client without vmap on
   the card (VMAP_LOGITS_TOL on the first batch's logits, VMAP_UPDATE_TOL
   on each client's update); then (a) finite losses and w_global moved, (b)
   the last round's stacked fold within FOLD_TOL of the float64 weighted
   mean of its 16 rows, (d) round seconds, rounds/hr, batched steps/s,
   images/s (real images, over the round), the fedavg.* split (the staging
   inside client_train) and peak memory, (e) no flash launch;
9. algorithm zoo: FedNova, SCAFFOLD, FedDyn and Mime, each 2 rounds of
   Parrot config 1's shape on the card and on the CPU from the same seeded
   params: each eval's test_loss (PARROT_LOSS_RTOL + ZOO_LOSS_ATOL), the
   final params and the server state (SCAFFOLD's c, FedDyn's h, Mime's s)
   within PARROT_PARAM_TOL of their scale; no flash launch;
10. cross-silo: BASELINE.md config 2, the cross-silo front over the message
   plane through FedMLRunner for each role. (a) ResNet-56 x 16 silos, all
   in every round, over INMEMORY (the server and 16 client threads in this
   process): first, with cuDNN deterministic and TF32 off, round 1's 16
   uploads and the server's fold against the sp simulator's round 1 of the
   same config from the same w_global (CS_UPLOAD_TOL, CS_FOLD_TOL), the fold
   within CS_MEAN_TOL of the float64 weighted mean of its arrivals; then 3
   rounds in the port's documented precision: round seconds, rounds/hr, the
   split from the server.* and client.train spans, peak memory, beside
   phase 7's sp round, and the same federation with the local rounds taken
   one at a time (a diagnostic); (b) a server and 4 client processes over
   the port's SocketMqttBroker (hosted here) with one object store,
   ResNet-56, 2 rounds, cuDNN deterministic and TF32 off: every party on
   the card and exiting 0 within CS_PARTY_TIMEOUT_S, the final params within
   CS_PROC_TOL of the same federation in process over INMEMORY; seconds a
   round, payload bytes, object-store times, start to ready (the processes
   run beside (a)'s parity gate and the INMEMORY reference, before (a)'s
   timed rounds); (c) card state
   dicts in f32 and bf16 through the wire layout and the codec bit-exactly,
   and a CPU arrival ingested with one host-to-device copy per dtype group;
   (d) no flash launch;
11. async federation and the compressed uplink, ResNet-56 at full width on
   the CIFAR-10 surrogate: (b) first, the vmapped async driver through
   FedMLRunner (backend "vmap", async_rounds; 16 clients in flight, a
   publish every 8 merges, 4 publishes, staleness exponent 0.5, cut 10):
   finite losses, w_global moved, the publish count; publishes/hr,
   images/s, the async.merge / async.publish spans, staleness and peak
   memory; (a) the buffer's gate, cuDNN's TF32 off: exponent 0 and
   publish_k 16 (one bucket) bit-equal to engine.aggregate of the same 16
   state dicts, publish_k 32 within ASYNC_STREAM_TOL of the float64
   weighted mean; (c) simulate_async_rounds over the ResNet-56 state dict at
   1,000 and 10,000 clients (publish_k 32, gen_batch 1024, 8 publishes), the
   card waited for after each submit and publish: rounds/hr of server
   seconds at each size and their ratio (reported, not gated), and the
   same seed's event trace identical; (d) the cross-silo front over
   INMEMORY: 16 silos in async mode (a publish every 8 merges, 4 publishes),
   seconds a publish; phase 10's synchronous federation at ResNet-20
   (SILOS_R20) cut to 2 rounds, plain and with comm_compressor eftopk at ratio 1.0, cuDNN deterministic
   and TF32 off, final params bit-equal; topk at ratio 0.05 to an end with
   finite metrics, its client.compress / server.decompress spans and
   payload bytes, and both compressors timed on the card; (e) no flash
   launch;
12. resilience on the CIFAR-10 surrogate, ResNet-56 at full width in (b),
   ResNet-20 in the drills: (b)
   first, 16 silo threads over INMEMORY as a quorum federation in this
   process (QUORUM: 12 a round from 16 connected, quorum_frac 0.75, a 15 s
   deadline under the adaptive rule, over-provisioning by 0.25, 2 rounds;
   silo 16 raises in round 0, silo 15 sleeps 8 s before each local round):
   the run ends within QUORUM_TIMEOUT_S with the dead party alone failed
   and no deadline timer alive; each round closes complete (12 kept) or
   partial (at least 9); from round 1 the cohort is 15 exactly when the last
   health report flagged a straggler, and some round is; health flags the
   straggler and marks the dead rank failed; each round's fold bit-equal to
   engine.aggregate of the arrivals it kept, captured at ingest (f32
   matmuls, TF32 off), and the kept set the quorum's accepted list; per round the seconds, the deadline, the arrivals,
   the missing ranks, late and surplus deltas. Then the SIGKILL drills of
   fedml_tpu_torch/tools/resilience_drill.py, every run a process of its own
   under RES_DRILL_TIMEOUT_S, deterministic: (a) sp, 16 clients x 3 rounds
   under FedOpt; (c) cross-silo, a server and 4 silo threads x 3 rounds;
   (d) cross-silo async, one silo, a publish every 2 merges, a snapshot
   after every merge, killed after merge 3: each crash exits by SIGKILL
   with a complete round short of the end in its store (for (d) a snapshot
   holding a pending arrival), and the resumed store's final state is
   bit-equal to the baseline's; (a), (c) and (d) side by side, each
   baseline beside its crash, (a) with its save times (enqueue ms with the card waited for,
   checkpoint_save_seconds, drops, store bytes, spawn to the first resumed
   round); (e) no flash launch;
13. privacy, ResNet-20 (SILOS_R20: ResNet-56's widths at a third of its
   depth) on the CIFAR-10 surrogate, 16 silo
   threads over INMEMORY (PRIV_*): first the yardstick, the async federation
   without privacy (a publish every 16 merges, exponent 0, 2 publishes);
   (a) ``privacy: secagg`` on it (default grid: 13 qbits, clip 3.0, a
   20-bit ring; threshold 8; 2 windows): every upload that left a client
   masked and no masked vector its quantized vector; each publish bit-equal
   to the host reference dequantize_sum(center_ring(sum of quantize_vector
   of the members' vectors, captured at the client before masking, mod
   2^b)); the card's ring sum equal to the int64 sum of the masked vectors;
   each publish within one QuantSpec.step of the plain mean of the same
   arrivals at unit weight wherever they lie inside the clip (TF32 matmuls
   off, checked); (b) the dropout drill: silo 16 drops its masked upload
   after key exchange, the 6 s window deadline fires, the survivors reveal,
   the window closes partial bit-equal to the 15 survivors' reference,
   secagg.dropouts and secagg.recovered each up by 1, no timer alive; (c)
   ``privacy: dp`` on phase 10's synchronous federation (2 rounds) and on
   the async one, and ``secagg+dp`` (2 windows): each release's draws
   (published less the fold's clean vector on the card) with std within
   DP_STD_RTOL of z·C/n and mean within 4 sigma/sqrt(d), epsilon equal to
   a fresh accountant's; (d) secagg on the window's shared topk support at
   0.05 (2 windows): 13,624 coordinates drawn from each window's nonce, the
   publish bit-equal to the reference on the support and 0 elsewhere;
   per case the key exchange s, host ms to mask, the fold of a masked
   bucket, ms to unmask, DP noise ms on the card, seconds a window, upload
   bytes, and the cost of privacy against the yardstick; (e) no flash
   launch;
14. the round-barrier secure-aggregation fronts, ResNet-20 (SILOS_R20) on
   the CIFAR-10 surrogate, 16 silo threads over INMEMORY through FedMLRunner
   by role, 2 rounds each (SECURE_FRONTS): ``secure_aggregation: secagg``
   (threshold 8) and ``lightsecagg`` (U 16, T 8), quantize_bits 16, p =
   2^31 - 1. (a) Gates: each round's global bit-equal to the plain mean of
   the 16 uploads its clients quantized before masking (their int64 sum mod
   p, centred and dequantized in the JAX fronts' order on the host); round
   1's global within 2^-16 per coordinate of the unweighted mean of the
   clients' trained weights; the globals, the aggregator and every party on
   the card; a masked upload 8 bytes a coordinate, LightSecAgg's shares and
   aggregate mask their chunk's size. (b) Figures: seconds a round, the
   spans of round 2 (local round, quantize, masking, LightSecAgg's encode,
   the server's sum, unmask or decode, dequantize), SecAgg's key exchange
   (last key in to last share relayed) and LightSecAgg's share exchange,
   bytes a client a round, and the costs alone after each run, the card
   waited for; (c) no flash launch;
15. hierarchical async aggregation over the ResNet-56 state dict (a seeded
   template on the card): (a) simulate_async_rounds(n, 8, template, 8,
   hierarchy_edges=8, gen_batch 1024, seed 0) at 1,000 and 10,000 clients
   and 1,000 again (8 edges of publish_k 8 under regional_fanout 4: 2
   regionals, a root publish every 64 client merges), its own server
   seconds; then the same event simulation over a HierarchyTree whose
   buffers record every merge and publish, the card waited for after each
   submit and publish: every root publish within HIER_TOL of each leaf's
   scale of the float64 host re-fold of its recorded arrivals through the
   same tree (at both sizes), the tree at version 8, the hierarchy.forwards
   counter equal to the nodes' forwards, every root publish on the card,
   after flush_sketches the root's staleness count equal to the client
   submissions, and the same seed's event trace identical; server s and
   rounds/hr beside phase 11 (c)'s flat buffer, forwards and merges per
   tier, the root sketch's staleness p50/p99, high water, peak memory; (b)
   HierarchyPrivacy over the template, 4 edges x 4 members under
   regional_fanout 2, the default QuantSpec, exponent 0, TF32 off: the root
   publish bit-equal to the honest quantized mean of the 16 deltas, the
   ledger empty after it, no edge's upward ring vector close to its
   cohort's honest partial mean, R5's tree (8 x 16 under fanout 4) refused
   at construction; key exchange s, masking ms a client, the edge publish,
   the regional pass-through and the root's strip and unmask ms, bytes
   forwarded per tier; (c) no flash launch;
16. the message plane's other backends, phase 10 (b)'s federation at
   ResNet-20 (MP_PROCS: 4 silos, 2 rounds, cuDNN deterministic, TF32 off)
   over each,
   its final params bit-equal to the same federation over INMEMORY in this
   process: (a) a server and 4 client processes over TRPC on a block of
   ports found free (round s, payload frames and their bytes, spawn to
   ready); (b) the same over MQTT_WEB3 through the socket broker and one
   LocalCASStore directory (cids against uploads: each round's global is
   one object); (a) and (b) run side by side, beside the INMEMORY reference
   and (c)-(d) in this process, so their seconds are taken under that
   load; (c) GRPC and MPI, 4 silo threads each, when grpc imports
   (the JSON says "grpc": "not installed" where it does not; any other
   failure fails); (d) the reference wire, mqtt_s3_wire='fedml' and, with
   grpc, grpc_wire='fedml', 4 silo threads; (e) comm_bench over INMEMORY,
   TRPC and GRPC at ResNet-56's state dict (3,423,080 bytes) and 64 MB,
   both on the card: round-trip ms and MB/s; (f) no flash launch;
17. the trust middleware at ResNet-20 (SP_R20, SILOS_R20) on the CIFAR-10
   surrogate: (b) run_simulation on the sp front, 16 clients, 2 rounds, the
   first 4 Byzantine random, without a defense and with multi-Krum (which
   must keep no attacker), test_acc and round s;
   (a) on (b)'s first-round client list, every one of the 22 defense types'
   three hooks on the card (ms a fold) against the same function on the CPU
   in float64: the same kept clients, Krum and Bulyan selections, 3-sigma
   and FoolsGold flags, the fold within TRUST_FOLD_TOL of the update (WeakDP
   and CRFL: their draws' std within 1% of sigma); multi-Krum and Bulyan
   keep no attacker; (c) cdp, ldp, nbafl and dp_clip through FedMLRunner,
   2 rounds each: every draw's std within 1% of its frame's sigma, epsilon
   equal to the host accountant stepped with the same scales; (d) the
   vmapped front with cdp and the coordinate median: its fold bit-equal to
   the hooks over the unstacked list, the fused fold without middleware,
   R7's refusal; (e) 16 INMEMORY silos, one round of multi-Krum and cdp:
   the pre-noise fold equal to the defense, clip and fold over the same
   arrivals; (f) exact Shapley and LOO over 4 clients (efficiency to 1e-6),
   GTG over 16 (its s); (g) reveal-labels recovers a batch's labels, DLG's
   match loss falls 100x within 300 iterations; (h) no flash launch;
18. FHE and the sp simulator's other APIs, at phase 7's ResNet-56 width:
   (a) at N=4096, 4 primes, the card's keygen, encryption under one seeded
   generator and decryption residues (float64 negacyclic matrices) equal,
   integer for integer, to the plain np.convolve version over 4 chunks;
   (b) rlwe through init and FedMLRunner on the sp front, 16 clients, 2
   rounds: each round's decryption within the worst-case RLWE noise bound
   sum_i k_i (2N + 1) B / 2^46 (B the run's largest error draw) of the
   fixed-point sum sum_i k_i rint(2^30 x_i) / 2^46 of the clients'
   plaintexts, its gap to the f32 fold, encrypt ms and ciphertext bytes a
   client, fold ms, decryption's card products and CRT ms (the card's
   Garner CRT held bit-equal to the host's Python-integer CRT, both timed),
   round s beside phase 7's; (c) 16 INMEMORY silos, one round of rlwe: the server's
   global is the decryption, within the same bound of its arrivals'
   fixed-point sum; (d) R7 (backend vmap), R10 (additive_mask on a front)
   and R11 (a byte backend) refused before any round; (e) TurboAggregate,
   4 ring groups, 2 rounds: each ring sum bit-equal to the plain field sum
   of the same quantized updates, the global within K/2 quantization steps
   of the float fold, round s; (f) FedAvg_seq, 4 workers, 2 rounds: every
   client in one queue, each fold within FOLD_TOL of the float64 weighted
   mean, makespan and round s; (g) split NN and FedGKT, 2 rounds at the JAX
   package's widths: the first round of 2 clients (cut to 256 images) on
   the card against the CPU, TF32 off, each loss within SPLIT_LOSS_RTOL;
   test_acc and s a round; (h) DSGD, PushSum and vertical FL on the card
   against the CPU in float64, each loss falling; (i) no flash launch;
19. FedGAN, FedNAS, FedSeg and the rest of the model hub, through the
   entry points, at each model's default widths: (a) FedGAN on the MNIST
   surrogate, 4 clients, 2 rounds: round 0 on shards cut to 64 images on
   the card against the CPU in float64 (the same seeded pair, the same z:
   the latents come from a CPU generator), the pair and the losses within
   F64_TOL; finite losses, generated images in [-1, 1], each round's s;
   (b) FedNAS on the CIFAR-10 surrogate, DARTS width 16, 3 cells of 3
   steps, 4 clients, 1 round: round 0 of 2 clients cut to 32 images on the
   card against the CPU in float64 within F64_TOL, the genotypes equal;
   the full round's s, losses, test accuracy and genotype; (c) FedSeg on
   pascal_voc with unet, 4 clients, 2 rounds, card against CPU in f32 with
   TF32 off: the update within SEG_UPDATE_TOL, the confusion matrices
   within SEG_CM_PIXELS; (d) one sp FedAvg round, 2 clients of HUB_SHARD
   examples, of mobilenet, mobilenet_v3 and efficientnet on cifar10, rnn
   on shakespeare, rnn_stackoverflow on stackoverflow_nwp, distilbert on
   20news (T=128, d 256, 4 layers) and lr on stackoverflow_lr and
   lending_club, card against CPU from the same seeded params in float64
   (the text classifier's dropout off): the first batch's logits and the
   update within HUB_F64_TOL; then the round in float32 on the card
   (dropout on), finite, its s; (e) no flash launch (the text classifier's attention is
   plain einsums, as in the JAX package);
20. a user's own files, through the entry points: (a) each dataset
   format written at its real widths, cut only in count (CIFAR-10 python
   batches, a fashion_mnist idx-ubyte drop, a LEAF femnist json; with
   h5py a TFF fed_shakespeare h5 and the FedNLP 20news pair; with PIL a
   cinic10 image folder; the formats a missing package leaves to the CPU
   tests are printed), loaded twice through data_loader.load (bit-equal),
   its load s and MB/s, then one sp FedAvg round of 2 clients (ResNet-20,
   LR, the CNN, the LSTM, the text classifier, the CNN) card against CPU
   in float64 (HUB_F64_TOL, dropout off) and in float32 on the card,
   timed; (b) the C++ data plane built from native/dataplane/src into
   fedml_tpu_torch/ops/_build/dataplane (available() must be true), the
   CIFAR arrays tiled to STREAM_SAMPLES streamed through save_shards and
   ArrayDataset.stream: each batch of 2 epochs equal to the memmap of the
   same files gathered in the prefetcher's order, the memmap path's epoch
   holding the same samples, batches/s; (c) an HF llama checkpoint at
   Llama-2-7B's widths cut to HF_LAYERS layers, exported bf16 from seeded
   params with a tokenizer.json trained on a written corpus, imported
   equal to the written tensors, re-exported byte for byte, its logits on
   the card within HF_LOGITS_TOL of the CPU's (f32, TF32 off); then
   LLMTrainer with model_name_or_path and dataset_path, HF_STEPS LoRA
   steps (bf16, seq 2048, batch 2, rank 8): K1-K3 launched exactly as
   the steps need, all on the wgmma design, the base embedding the
   checkpoint's; then LLMPredictor.from_checkpoint decodes HF_DECODE
   tokens with no flash launch; export and import s and GB/s, step ms,
   first token and decode ms; (a) and (b) launch no flash kernel;
21. the serving front door: (a) the int8 GEMM (ops/csrc/int8_gemm.cu)
   against its plain version on the card at Llama-2-7B's projection shapes
   (K x N 4096x4096, 4096x11008, 11008x4096, 4096x32000) at M 1, 8 (decode
   rows), 16, 64, 128 (short prompts' prefills) and 512 in bf16 and two f32
   cases (INT8_RTOL, relative over the output), each launch through the
   design int8_matmul.design_for names (the C entry point's counters), each
   timed over INT8_ITERS back-to-back launches queued behind a sleep (the
   device's time, weights rotated through copies past the 50 MB L2) beside
   its plain version, its bound and torch._weight_int8pack_mm (the bf16
   matmul where that raises); (b) in-process int8 decode at Llama-2-7B's
   widths at SERVE_LAYERS from phase 6's seeded bf16 weights:
   quantize_params_int8 on the card bit-equal to the CPU's, the first
   token's logits within KEY_RTOL of the plain int8 path's on the card, the
   kernel launched on every projection and no flash launch, every launch
   on the design design_for names (bf16 prefills on sm90_wgmma_tma, decode
   rows on the mma.sync design; a bf16 tiled_simt launch fails), the no-copy
   gate (a B=1 decode step's extra peak memory below one bf16 copy of the
   smallest projection), resident weight bytes and ms a decoded token int8
   against bf16 at B=1 and 8; (c) EndpointManager.deploy_isolated with 2
   flagship bf16 replicas and 1 int8 replica (children on the card): every
   reply equal to an in-process LLMPredictor of the same seed and geometry,
   /metrics parsed (the serving families, the int8 replica's launches),
   /statusz's replicas section on the gateway's StatuszServer, a replica
   SIGKILLed with every request still answered and the corpse evicted, one
   AutoScaler.tick, spawn-to-ready s, requests/s and p50/p99 latency
   through the gateway; every child reaped;
22. head dims and dtypes beyond 64/128 and bf16, through the normal entry
   points with attention_impl="auto" on the card: (a) LLMTrainer.train for
   TRAIN_STEPS steps at Phi-3-mini-4k's published widths (PHI3: d_model
   3072, 32 heads and 32 KV heads of 96, d_ff 8192, vocab 32064) cut to 4
   of its 32 layers, bf16, seq 2048, batch 2, LoRA rank 8, then one
   LLMClientTrainer round as in phase 5; (b) LLMTrainer.train for
   GEMMA_STEPS steps at Gemma-2B's published attention widths (GEMMA2B:
   d_model 2048, 8 heads of 256 over one KV head, d_ff 16384, vocab 256000)
   cut to 2 of its 18 layers, through the repo's llama block (SwiGLU and an
   untied head, not Gemma's GeGLU); (c) JAX's own test geometry
   (tests/test_llm.py: d_model 64, 4 heads of 16, 2 KV heads) in f32 and
   float16: a forward and backward through "auto" against the same model
   with attention_impl="xla" on the card (TINY_TOL), then one SGD step of
   the adapters. Each part: finite loss, adapters moved, base weights
   bit-unchanged, K1-K3 launched exactly as its steps need, every bf16 and
   f16 launch on sm90_wgmma_tma and every f32 one on simt_f32_fma (the C
   counters);
23. the serve, fedavg (with its vmap and zoo entries), cross_silo, async,
   resilience, privacy, secure_fronts, hierarchy, message_plane, trust,
   fhe_sp_zoo, gan_nas_seg_hub, files, front_door, head_dims and kernels
   lines (JSON, the kernels line with the design each kernel ran on the
   main path and a row for each kernel at phase 22's head dims 96 and
   256), the card line, and last the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Slice shapes: Llama-2-7B attention (32 heads of 128) at seq 2048, batch 2.
B, T, HQ, D = 2, 2048, 32, 128
# phases 4-5's depth: 2 of Llama-2-7B's 32 layers. Most of a LoRA phase's
# seconds are the trainer's durable checkpoint of the whole model, 0.8 GB a
# layer, and the smoke's time limit holds every phase.
N_LAYERS = 2
TRAIN_STEPS = 3
ROUND_STEPS = 2

# Kernel against plain version, on the same inputs, row by row: for every
# row r of an output (one query or key position of one head),
# ||got_r - ref_r|| <= ROW_RTOL * ||ref_r|| + ROW_ATOL. Each row is held to
# its own size, so small late rows (causal O, dQ) are held as tightly as
# the large early ones. bf16 outputs differ where the last cast, or the cast
# of p/ds, rounds the other way (one bf16 ulp, 2^-8 relative, an element):
# worst rows measured 4.8e-3 on an H100 (PERF.md), about half the limit. f32
# outputs differ by summation order only: worst rows measured 1.6e-6.
# float16 rounds the same casts to 2^-11 relative, eight times finer than
# bf16's 2^-8: its limit is bf16's scaled by 2^-3, the same 2.56 ulps.
# The 16-bit dQ kernel sums dP = dO.V^T on the tensor cores, in another order
# than the plain version, so each of its rows is also allowed the f32
# rounding of that sum (ops/flash_attention.py flash_bwd_dq_rounding_floor):
# it is the whole size of causal row 0, 0 in exact arithmetic and a few 1e-6
# of noise in any f32 order, and below ROW_RTOL of every other row.
# A row of the gate holds at least GATE_ROW elements: one position's d
# elements, or, below d = 64, ceil(64 / d) consecutive positions of a head.
# The limits were set on rows of 64 and more elements, over which the
# per-element roundings average; over 8 they do not (a d = 8 row of O alone
# measured 1.04 of its limit on an H100, where d = 64's worst is 0.45).
ROW_RTOL = {"bfloat16": 1e-2, "float16": 1e-2 * 2.0 ** -3, "float32": 1e-5}
ROW_ATOL = 1e-6
GATE_ROW = 64
LSE_TOL = 1e-4  # lse is f32 in both dtypes, ~8 in size: abs 1e-4 is 1e-5 relative

# name: (source, TPU kernel it replaces, the design (ops/_build.py DESIGNS)
# every bf16 and f16 launch of the main path must run: phases 4-5 and 22
# fail otherwise)
KERNELS = {
    "flash_fwd": ("fedml_tpu_torch/ops/csrc/flash_fwd.cu", "fedml_tpu/ops/flash_attention.py:180",
                  "sm90_wgmma_tma"),
    "flash_bwd_dq": ("fedml_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "fedml_tpu/ops/flash_attention.py:273", "sm90_wgmma_tma"),
    "flash_bwd_dkv": ("fedml_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "fedml_tpu/ops/flash_attention.py:305", "sm90_wgmma_tma"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _inputs(b, t, hq, hkv, d, dtype, seed=0):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda rows: torch.randn(rows, t, d, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b * hq), mk(b * hkv), mk(b * hkv), mk(b * hq)


def _err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def gate_rows(x, d: int, width: int):
    """``x`` as the rows of the gate: ``width`` values a position (d for an
    output, 1 for a per-position floor), grouped ceil(GATE_ROW / d)
    consecutive positions a row, zero positions filling the last row."""
    import torch

    group = -(-GATE_ROW // d)
    flat = x.reshape(-1, width)
    pad = (-flat.shape[0]) % group
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad, width)])
    return flat.reshape(-1, group * width)


def row_check(got, ref, dtype, floor=None) -> tuple[bool, float, float, int]:
    """Row by row of the gate (gate_rows: a position's d elements, or
    ceil(64 / d) positions below d = 64): (every row within its limit
    ROW_RTOL * ||ref_r|| + ROW_ATOL + floor_r, worst ||err_r|| over its
    limit, worst ||err_r|| / ||ref_r|| over the rows the relative term
    holds, rows whose floor_r is above ROW_RTOL * ||ref_r||). A row's floor
    is the norm of its positions' floors."""
    d = got.shape[-1]
    err = gate_rows(got.float() - ref.float(), d, d).norm(dim=-1)
    size = gate_rows(ref.float(), d, d).norm(dim=-1)
    rel = ROW_RTOL[str(dtype).split(".")[-1]] * size
    floor = 0.0 * size if floor is None else gate_rows(floor, d, 1).norm(dim=-1)
    limit = rel + ROW_ATOL + floor
    held = floor <= rel
    return (bool((err <= limit).all().item()), (err / limit).max().item(),
            (err[held] / size[held].clamp_min(1e-30)).max().item(), int((~held).sum().item()))


def kernel_case(fa, b, t, hq, hkv, d, causal, dtype, tiles=None, quiet=False) -> dict:
    """Each kernel against its plain version on the same inputs; raises on a
    disagreement. ``tiles`` maps a kernel's name to its (block_q, block_k),
    the kernel's default where absent. Returns the max abs error per kernel
    and, under "share", each output's worst share of its row limit; prints a
    line unless ``quiet``."""
    import torch

    q, k, v, do = _inputs(b, t, hq, hkv, d, dtype)
    kw = dict(causal=causal, hq=hq, hkv=hkv)
    pick = {name: fa.resolve_blocks(name, dtype, *(tiles or {}).get(name, (None, None)),
                                    head_dim=d)
            for name in KERNELS}
    blocks = {name: dict(block_q=bq, block_k=bk) for name, (bq, bk) in pick.items()}
    o, lse = fa.flash_fwd(q, k, v, **kw, **blocks["flash_fwd"])
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, **kw)
    # both backward kernels read the plain forward's stats, so each is held
    # against its own plain version on identical inputs
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw, **blocks["flash_bwd_dq"])
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw, **blocks["flash_bwd_dkv"])
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta, **kw)
    dq_floor = (fa.flash_bwd_dq_rounding_floor(q, k, v, do, lse_ref, **kw)
                if dtype != torch.float32 else None)
    label = (f"B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal={causal} {str(dtype)[6:]} "
             f"tiles fwd/dq/dkv={'/'.join(str(pick[n]) for n in KERNELS)}")
    errs, rels, shares, floor_rows = {}, {}, {}, {}
    for name, got, ref, floor in (("o", o, o_ref, None), ("dq", dq, dq_ref, dq_floor),
                                  ("dk", dk, dk_ref, None), ("dv", dv, dv_ref, None)):
        errs[name] = _err(got, ref)
        check(torch.isfinite(got).all().item(), f"{label}: {name} not finite")
        ok, shares[name], rels[name], floor_rows[name] = row_check(got, ref, dtype, floor)
        check(ok, f"{label}: {name} row error {shares[name]:.3g} of its row's limit "
                  f"(worst {rels[name]:.3g} of its size, rtol "
                  f"{ROW_RTOL[str(dtype).split('.')[-1]]})")
    errs["lse"] = _err(lse, lse_ref)
    check(errs["lse"] <= LSE_TOL, f"{label}: lse err {errs['lse']} > {LSE_TOL}")
    if not quiet:
        say(f"  ok {label}: max abs " + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + "; worst row rel " + " ".join(f"{n}={e:.3g}" for n, e in rels.items())
        + "; worst share of the row limit " + " ".join(f"{n}={e:.3g}" for n, e in shares.items())
            + f"; dq rows held by the rounding floor {floor_rows['dq']}")
    return {"flash_fwd": max(errs["o"], errs["lse"]), "flash_bwd_dq": errs["dq"],
            "flash_bwd_dkv": max(errs["dk"], errs["dv"]), "share": shares}


# Head dims of the instance sweep: below one 64-column sub-tile (8, 16),
# inside a 128-column tile (80: Phi-2's width, 96: Phi-3's), a 256-wide
# tile whose last sub-tile lies wholly past d (136), and each padded width
# in full (64, 128, 256: Gemma's).
SWEEP_DIMS = (8, 16, 64, 80, 96, 128, 136, 256)
# B*Hq past CUDA's grid.y limit of 65,535: B=4096, Hq=16 over Hkv=4, T=24
WIDE_GRID = dict(b=4096, t=24, hq=16, hkv=4, d=64)


def instance_sweep(fa) -> int:
    """Every compiled instance against its plain version at small shapes:
    each dtype (bf16, f16, f32) and head dim of SWEEP_DIMS, causal and dense,
    GQA 8/2 and MQA 8/1 at the ragged T=200 and, for the 16-bit kernels,
    T=96, below one tile; the f32 tile pairs of each padded width cycled
    over its cases, so every pair runs; then B*Hq=65,536 in each dtype."""
    import torch

    cases = 0
    for dtype in fa.KERNEL_DTYPES:
        seen = {}  # cases so far at each padded width: the f32 pair to take
        for d in SWEEP_DIMS:
            width = fa.padded_width(d)
            worst, abs_err, pairs = {}, {}, set()
            for t in ((200,) if dtype == torch.float32 else (200, 96)):
                for hkv in (2, 1):
                    for causal in (True, False):
                        i = seen.get(width, 0)
                        seen[width] = i + 1
                        tiles = {name: fa.TILES[name][dtype][width][i % len(
                            fa.TILES[name][dtype][width])] for name in KERNELS}
                        pairs.add(tuple(tiles.values()))
                        got = kernel_case(fa, 2, t, 8, hkv, d, causal, dtype, tiles, quiet=True)
                        worst = {n: max(e, worst.get(n, 0.0)) for n, e in got["share"].items()}
                        abs_err = {n: max(got[n], abs_err.get(n, 0.0)) for n in KERNELS}
                        cases += 1
            say(f"  ok {str(dtype)[6:]} d={d} (width {width}, tiles fwd/dq/dkv "
                f"{sorted(pairs)}): worst share of the row limit "
                + " ".join(f"{n}={e:.3g}" for n, e in worst.items()) + "; max abs err "
                + " ".join(f"{n}={e:.3g}" for n, e in abs_err.items()))
        w = WIDE_GRID
        kernel_case(fa, w["b"], w["t"], w["hq"], w["hkv"], w["d"], True, dtype)
        cases += 1
    return cases


def _bound(flops, nbytes, dtype) -> dict:
    peak = PEAK_FLOPS[str(dtype).split(".")[-1]]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_kernels(fa, b, t, hq, hkv, d, dtype) -> dict:
    """ms of each kernel, its plain version and the library yardstick, and
    the bound, at the main path's shape (causal)."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.tools.compare_kernels import ITERS, cuda_ms, work

    q, k, v, do = _inputs(b, t, hq, hkv, d, dtype, seed=1)
    kw = dict(causal=True, hq=hq, hkv=hkv)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    q4, k4, v4 = (x.view(b, -1, t, d).detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=hq != hkv)
    do4 = do.view(b, hq, t, d)

    @torch.no_grad()
    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=hq != hkv)

    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, **kw),
                      sdpa_fwd),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
                         None),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw),
                          None),
    }
    # the library's backward computes dQ, dK and dV in one call: it stands
    # beside both backward kernels
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                      retain_graph=True), ITERS)
    out = {}
    for name, (kernel, plain, lib) in times.items():
        flops, nbytes = work(name, b, t, hq, hkv, d, q.element_size())
        ms = cuda_ms(kernel, ITERS)
        out[name] = {
            "ms": ms,
            "plain_ms": cuda_ms(plain, 3),
            **_bound(flops, nbytes, dtype),
            "library_ms": cuda_ms(lib, ITERS) if lib is not None else sdpa_bwd_ms,
            "tflops": flops / ms / 1e9,
        }
        out[name]["share_of_bound"] = out[name]["bound_ms"] / ms
    return out


def time_bwd_gqa(fa, b, t, hq, hkv, d, dtype) -> dict:
    """dQ and dK/dV at a GQA shape, where dK/dV's in-block loop over the
    group's query heads replaces the TPU's sequential grid axis and dQ's
    blocks of one group share their K/V tiles in L2; SDPA's backward (with
    enable_gqa) beside their sum."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.tools.compare_kernels import ITERS, cuda_ms, work

    q, k, v, do = _inputs(b, t, hq, hkv, d, dtype, seed=2)
    kw = dict(causal=True, hq=hq, hkv=hkv)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    q4, k4, v4 = (x.view(b, -1, t, d).detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)
    out = {}
    for name, fn in (("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
                     ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))):
        flops, nbytes = work(name, b, t, hq, hkv, d, q.element_size())
        ms = cuda_ms(fn, ITERS)
        out[name] = {"ms": ms, **_bound(flops, nbytes, dtype), "tflops": flops / ms / 1e9}
    out["k2_plus_k3_ms"] = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    out["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (q4, k4, v4), do.view(b, hq, t, d), retain_graph=True), ITERS)
    return out


def _snapshot(model, adapters: bool):
    from fedml_tpu_torch.train.llm.llm_trainer import is_lora_name

    return {n: p.detach().clone() for n, p in model.named_parameters()
            if is_lora_name(n) == adapters}


# The LoRA step's geometries (ModelArguments fields), each cut only in depth:
# Llama-2-7B's widths (phases 4-5), and phase 22's Phi-3-mini-4k
# (microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32 heads and
# 32 KV heads, so head dim 96, intermediate 8192, vocab 32064; 4 of 32
# layers) and Gemma-2B's attention widths (google/gemma-2b config.json:
# hidden 2048, 8 heads of 256 over 1 KV head, intermediate 16384, vocab
# 256000; 2 of 18 layers), both through the repo's llama block.
LLAMA7B = dict(vocab_size=32000, d_model=4096, n_layers=N_LAYERS, n_heads=HQ, n_kv_heads=HQ,
               d_ff=11008, seq_len=T, lora_rank=8, remat=True)
PHI3 = dict(vocab_size=32064, d_model=3072, n_layers=4, n_heads=32, n_kv_heads=32, d_ff=8192,
            seq_len=T, lora_rank=8, remat=True)
GEMMA2B = dict(vocab_size=256000, d_model=2048, n_layers=2, n_heads=8, n_kv_heads=1,
               d_ff=16384, seq_len=T, lora_rank=8, remat=True)
GEMMA_STEPS = 2


def train_phase(tmp: str, geom: dict = LLAMA7B, steps: int = TRAIN_STEPS) -> dict:
    """LLMTrainer.train: ``steps`` steps at ``geom`` (Llama-2-7B widths, 4
    layers, by default), bf16, batch B."""
    import numpy as np
    import torch

    from fedml_tpu_torch.train.llm.configurations import (DatasetArguments,
                                                          ExperimentArguments, ModelArguments)
    from fedml_tpu_torch.train.llm.data import TextDataset
    from fedml_tpu_torch.train.llm.llm_trainer import LLMTrainer

    ma = ModelArguments(**geom)
    ea = ExperimentArguments(max_steps=steps, per_device_batch_size=B, learning_rate=1e-4,
                             warmup_steps=1, output_dir=os.path.join(tmp, "trainer"))
    trainer = LLMTrainer(ma, DatasetArguments(), ea)  # device defaults to cuda
    check(trainer.cfg.attention_impl == "auto" and trainer.device.type == "cuda",
          "trainer is not on the CUDA kernel path")
    trainer._build(trainer.init_params())
    n_params = sum(p.numel() for p in trainer.model.parameters())
    base0, lora0 = _snapshot(trainer.model, False), _snapshot(trainer.model, True)
    blocks = np.random.default_rng(0).integers(0, ma.vocab_size, (16, T), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train(TextDataset(blocks).batches(B, steps, seed=0))
    check(metrics["steps"] == steps, f"trainer ran {metrics['steps']} steps")
    check(np.isfinite(metrics["final_loss"]), f"loss not finite: {metrics['final_loss']}")
    after_base, after_lora = _snapshot(trainer.model, False), _snapshot(trainer.model, True)
    check(all(torch.equal(base0[n], after_base[n]) for n in base0), "base weights changed")
    check(any(not torch.equal(lora0[n], after_lora[n]) for n in lora0), "adapters did not move")
    say(f"  params={n_params} final_loss={metrics['final_loss']:.6f} "
        f"tokens_per_sec={metrics['tokens_per_sec']:.1f} "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    adapters = trainer.adapter_params()
    del trainer, base0, lora0, after_base, after_lora
    torch.cuda.empty_cache()
    return {"metrics": metrics, "adapters": adapters, "n_params": n_params}


def client_phase(tmp: str, global_adapters: dict, geom: dict = LLAMA7B) -> dict:
    """One LLMClientTrainer round: set_model_params -> train -> get_model_params."""
    import numpy as np

    from fedml_tpu_torch.models.lora import split_lora
    from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer

    args = SimpleNamespace(**geom, per_device_batch_size=B, local_steps=ROUND_STEPS,
                           learning_rate=1e-4, warmup_steps=1,
                           output_dir=os.path.join(tmp, "client"))
    client = LLMClientTrainer(args)
    client.set_id(1)
    client.set_model_params(global_adapters)
    sent = _flat(global_adapters)
    got = _flat(client.get_model_params())
    expected = _flat(split_lora(client.llm.named_params())[0])
    check(sorted(got) == sorted(expected), "adapter keys differ from split_lora's")
    check(len(got) == geom["n_layers"] * 4 * 2, "unexpected number of adapter leaves")
    check(got.keys() == sent.keys() and all(np.array_equal(got[p], sent[p]) for p in sent),
          "set_model_params -> get_model_params is not the identity")
    blocks = np.random.default_rng(1).integers(0, args.vocab_size, (8, T), dtype=np.int32)
    metrics = client.train(blocks)
    out = _flat(client.get_model_params())
    check(np.isfinite(metrics["final_loss"]), "client loss not finite")
    check(any(not np.array_equal(out[p], sent[p]) for p in sent),
          "the round did not move the adapters")
    say(f"  client round: steps={metrics['steps']} final_loss={metrics['final_loss']:.6f} "
        f"tokens_per_sec={metrics['tokens_per_sec']:.1f} adapter_leaves={len(out)}")
    return metrics


# -- phase 22: head dims and dtypes beyond 64/128 and bf16 -----------------------

# a bf16 and f16 kernel's instances: two element types x three padded widths
WGMMA_INSTANCES = 6
# tests/test_llm.py's CFG: JAX's own test model (head dim 16), TransformerConfig fields
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=64, remat=False, lora_rank=4)
# The same tiny model through "auto" (the kernels) and through "xla" on the
# card, norm of the difference over the norm, for the logits and each LoRA
# gradient. f32: summation order only (TF32 off). float16: the plain path
# rounds its scores q.k to f16 before the softmax where the kernel keeps them
# in f32, an error of |s| 2^-11 in each exponent (a few 1e-3 of a row at
# |s| ~ 5), carried through two layers and the backward.
TINY_TOL = {"float32": 1e-4, "float16": 2e-2}


def _launched(fa, libs, run):
    """(run(), launches a kernel, launches a kernel by design) over run()."""
    fa.reset_launch_counts()
    before = {name: libs.design_launches(name) for name in KERNELS}
    out = run()
    by_design = {name: {d: n - before[name][d] for d, n in libs.design_launches(name).items()
                        if n > before[name][d]} for name in KERNELS}
    return out, dict(fa.launch_counts), by_design


def _check_launches(part: str, launches: dict, by_design: dict, n_layers: int, steps: int,
                    forwards_a_step: int, design: str) -> dict:
    """K1-K3 exactly as ``steps`` steps of ``n_layers`` layers need (the
    forward ``forwards_a_step`` times a layer: 2 under remat), all on
    ``design``; -> the expected counts."""
    want = {"flash_fwd": forwards_a_step * n_layers * steps, "flash_bwd_dq": n_layers * steps,
            "flash_bwd_dkv": n_layers * steps}
    check(launches == want, f"{part}: launch counts {launches} != {want}")
    for name in KERNELS:
        check(by_design[name] == {design: want[name]},
              f"{part}: {name} launches by design {by_design[name]}, expected all "
              f"{want[name]} on {design}")
    return want


def tiny_case(dtype) -> dict:
    """JAX's test geometry on the card in ``dtype``: a forward and backward
    through "auto" (the flash kernels) against the same weights through
    "xla", then one SGD step of the adapters."""
    import dataclasses

    import numpy as np
    import torch

    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.parallel.fsdp import causal_lm_loss
    from fedml_tpu_torch.train.llm.llm_trainer import is_lora_name

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(dtype=dtype, **TINY)
    check(cfg.attention_impl == "auto" and cfg.head_dim == 16, f"tiny config {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    auto = TransformerLM(cfg, device="cuda")
    auto.reset_parameters(gen)
    with torch.no_grad():  # adapters that contribute, so both factors get gradients
        for n, p in auto.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    plain = TransformerLM(dataclasses.replace(cfg, attention_impl="xla"), device="cuda")
    plain.load_state_dict(auto.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64))).to("cuda")
    outs = {}
    for name, model in (("auto", auto), ("xla", plain)):
        for n, p in model.named_parameters():
            p.requires_grad_(is_lora_name(n))
        logits = model(toks)
        loss = causal_lm_loss(logits, toks)
        loss.backward()
        outs[name] = (loss.item(), logits.detach().float(),
                      {n: p.grad.float() for n, p in model.named_parameters() if p.requires_grad})
    tag = str(dtype).split(".")[-1]
    (loss_a, logits_a, grads_a), (loss_x, logits_x, grads_x) = outs["auto"], outs["xla"]
    check(np.isfinite(loss_a), f"(c) {tag}: loss not finite")
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()  # noqa: E731
    logits_rel = rel(logits_a, logits_x)
    grad_rel = max(rel(grads_a[n], grads_x[n]) for n in grads_x)
    check(logits_rel <= TINY_TOL[tag] and grad_rel <= TINY_TOL[tag],
          f"(c) {tag}: auto against xla: logits {logits_rel:.3g}, LoRA grads {grad_rel:.3g} "
          f"(limit {TINY_TOL[tag]})")
    base0, lora0 = _snapshot(auto, False), _snapshot(auto, True)
    torch.optim.SGD([p for p in auto.parameters() if p.requires_grad], lr=0.1).step()
    check(all(torch.equal(base0[n], p) for n, p in _snapshot(auto, False).items()),
          f"(c) {tag}: base weights changed")
    check(any(not torch.equal(lora0[n], p) for n, p in _snapshot(auto, True).items()),
          f"(c) {tag}: adapters did not move")
    say(f"  (c) {tag}: loss {loss_a:.6f} (xla {loss_x:.6f}); auto against xla: logits "
        f"{logits_rel:.3g}, worst LoRA grad {grad_rel:.3g} of its norm (limit {TINY_TOL[tag]})")
    return {"loss": loss_a, "xla_loss": loss_x, "logits_rel": logits_rel, "grad_rel": grad_rel}


def head_dims_phase(libs) -> dict:
    """(a) the LoRA step and a client round at Phi-3-mini's widths (head dim
    96), (b) the LoRA step at Gemma-2B's attention widths (256, MQA), (c)
    JAX's test geometry (16) in f32 and float16, each through "auto"."""
    import torch

    from fedml_tpu_torch.ops import flash_attention as fa

    res = {}
    tmp = os.path.join(ROOT, ".smoke_run")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        say(f"  (a) Phi-3-mini-4k's widths, {PHI3['n_layers']} of its 32 layers: "
            f"LLMTrainer.train {TRAIN_STEPS} steps, an LLMClientTrainer round of {ROUND_STEPS}")
        t0 = time.time()

        def phi3():
            trained = train_phase(tmp, PHI3, TRAIN_STEPS)
            return trained["metrics"], client_phase(tmp, trained["adapters"], PHI3)

        (metrics, client), launches, by_design = _launched(fa, libs, phi3)
        want = _check_launches("(a)", launches, by_design, PHI3["n_layers"],
                               TRAIN_STEPS + ROUND_STEPS, 2, "sm90_wgmma_tma")
        res["phi3"] = {"geometry": PHI3, "head_dim": PHI3["d_model"] // PHI3["n_heads"],
                       "train": metrics, "client": client, "launches": launches,
                       "by_design": by_design, "s": time.time() - t0}
        say(f"  (a) {res['phi3']['s']:.1f}s; launches {launches} (expected {want}), "
            f"by design {by_design}")
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        say(f"  (b) Gemma-2B's attention widths, {GEMMA2B['n_layers']} of its 18 layers, "
            f"through the repo's llama block (SwiGLU, an untied head; not Gemma's GeGLU): "
            f"LLMTrainer.train {GEMMA_STEPS} steps")
        t0 = time.time()
        trained, launches, by_design = _launched(
            fa, libs, lambda: train_phase(tmp, GEMMA2B, GEMMA_STEPS))
        want = _check_launches("(b)", launches, by_design, GEMMA2B["n_layers"], GEMMA_STEPS, 2,
                               "sm90_wgmma_tma")
        res["gemma2b"] = {"geometry": GEMMA2B, "head_dim": GEMMA2B["d_model"] // GEMMA2B["n_heads"],
                          "train": trained["metrics"], "n_params": trained["n_params"],
                          "launches": launches, "by_design": by_design, "s": time.time() - t0}
        say(f"  (b) {res['gemma2b']['s']:.1f}s; launches {launches} (expected {want}), "
            f"by design {by_design}")
        del trained
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    res["tiny"] = {}
    for dtype, design in ((torch.float32, "simt_f32_fma"), (torch.float16, "sm90_wgmma_tma")):
        out, launches, by_design = _launched(fa, libs, lambda: tiny_case(dtype))
        tag = str(dtype).split(".")[-1]
        _check_launches(f"(c) {tag}", launches, by_design, TINY["n_layers"], 1, 1, design)
        res["tiny"][tag] = {**out, "launches": launches, "by_design": by_design}
    res["tiny_s"] = time.time() - t0
    return res


def _flat(tree, prefix=()) -> dict:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


# -- phase 6: serving at Llama-2-7B's widths, 4 of its 32 layers ---------------

DEV = "cuda"
SERVE_SEED = 0
# phase 4's cut of Llama-2-7B's depth: the decode step is host-bound (63.5
# ms a token at 32 layers on an H100, 17.2 at 8, PERF.md), and at full depth
# this phase took about 100 s of a smoke that must end inside 1,200 s
SERVE_LAYERS = 4
KEY_B, KEY_P, KEY_STEPS = 2, 128, 32   # the keystone: prefill, then single-token steps
SERVE_MAX_NEW = 32
SERVE_SLOTS, SERVE_CHUNK = 8, 8
PAGE_SIZE, NUM_PAGES = 16, 1024
SAMPLE_TEMP, SAMPLE_SEEDS = 0.8, (11, 12)
# Keystone gate, row by row (one row = the logits of one position of one
# sequence): ||cached_r - full_r|| <= KEY_RTOL * ||full_r||. bf16 decode
# (cached, one token at a time) and the full forward (all positions at once)
# round at different GEMM shapes, and a random model carries the
# difference to every logit: at 32 layers worst row 1.79e-2, median 1.59e-2
# on an H100 (PERF.md), while a write index off by one moved rows by 0.33 or
# more.
KEY_RTOL = 3e-2
# Greedy consistency: each greedy token's logit, teacher-forced through one
# full forward, within GREEDY_TOL of its row's max (bf16 paths of other
# shapes disagree on near-ties; an exact tie break is not a bf16 property).
GREEDY_TOL = 0.25
# Built-in corpus for the tokenizer and the prompts (the repo ships no text).
CORPUS = (
    "federated learning trains one model across many silos without moving their data",
    "each silo fine tunes low rank adapters on a frozen base model and sends only the adapters",
    "the server folds the adapters of a round into the global model and sends it back",
    "serving answers requests with the trained model one token at a time from a key value cache",
    "continuous batching lets requests join and leave the decode batch at token boundaries",
    "a paged cache keeps keys and values in fixed pages so requests sharing a prompt share memory",
    "the quick brown fox jumps over the lazy dog while the cat sleeps in the warm sun",
    "privacy budgets bound what any one client reveals through the updates it sends",
)


def _serve_model():
    """Llama-2-7B's widths (d_model 4096, 32 heads, d_ff 11008, vocab 32000,
    max_seq_len 4096) at SERVE_LAYERS layers as a decode model: bf16 weights
    drawn on the card from a seeded generator."""
    import torch

    from fedml_tpu_torch.models.transformer import TransformerConfig
    from fedml_tpu_torch.train.llm.generation import decode_model

    cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16, remat=False,
                                      n_layers=SERVE_LAYERS)
    model = decode_model(cfg, None, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SERVE_SEED)
    model.reset_parameters(gen)
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith("scale") else torch.bfloat16
        check(p.dtype == want and p.is_cuda, f"serving weight {name} is {p.dtype} on {p.device}")
    return cfg, model


def _row_rel(got, ref):
    """Per row ||got_r - ref_r|| / ||ref_r||."""
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).flatten()


def keystone(model, idx_shift: int = 0) -> dict:
    """Prefill KEY_P tokens at B=KEY_B, then KEY_STEPS single-token steps;
    every row of logits against the full non-cached forward over the same
    tokens. ``idx_shift`` moves the cache's write index after prefill (a
    wrong cache the gate must refuse)."""
    import torch

    from fedml_tpu_torch.models.transformer import init_cache

    with torch.inference_mode():
        g = torch.Generator(device=DEV).manual_seed(SERVE_SEED + 1)
        toks = torch.randint(0, model.cfg.vocab_size, (KEY_B, KEY_P + KEY_STEPS),
                             generator=g, device=DEV)
        full = model(toks)
        cache = init_cache(model.cfg, KEY_B, toks.device)
        # stale entries, as a reused slot holds them: the mask must hide
        # every position past the write index (an index one ahead exposes one)
        for layer in cache.values():
            for name in ("k", "v"):
                layer["attn"][name].normal_(0.0, 4.0, generator=g)
        pos = torch.arange(KEY_P, device=DEV).expand(KEY_B, KEY_P)
        pre = model(toks[:, :KEY_P], pos, cache=cache)
        rel = [_row_rel(pre, full[:, :KEY_P])]
        abs_err = [(pre - full[:, :KEY_P]).abs().max()]
        for layer in cache.values():
            layer["attn"]["idx"].add_(idx_shift)
        for t in range(KEY_P, KEY_P + KEY_STEPS):
            step = model(toks[:, t:t + 1], torch.full((KEY_B, 1), t, device=DEV),
                         cache=cache)[:, 0]
            rel.append(_row_rel(step, full[:, t]))
            abs_err.append((step - full[:, t]).abs().max())
        rel = torch.cat(rel)
        # the scale of bf16 path noise: the same full forward over the first
        # KEY_P tokens only (other GEMM shapes, no cache)
        noise = _row_rel(model(toks[:, :KEY_P]), full[:, :KEY_P])
        return {"worst_rel": rel.max().item(), "median_rel": rel.median().item(),
                "max_abs": torch.stack(abs_err).max().item(),
                "full_logit_absmax": full.abs().max().item(),
                "full_vs_shorter_full_worst_rel": noise.max().item(),
                "full_vs_shorter_full_median_rel": noise.median().item(),
                "ok": bool((rel <= KEY_RTOL).all().item())}


def greedy_gap(model, prompt, out, eos=None) -> float:
    """Teacher-force ``prompt + out`` through one full forward: the largest
    gap between a row's max logit and the logit of the greedy token chosen
    there (up to and including the first EOS)."""
    import torch

    out = [int(t) for t in out]
    if eos is not None and eos in out:
        out = out[:out.index(eos) + 1]
    with torch.inference_mode():
        seq = torch.tensor([list(prompt) + out[:-1]], device=DEV)
        logits = model(seq)[0, len(prompt) - 1:]
        chosen = logits[torch.arange(len(out), device=DEV), torch.tensor(out, device=DEV)]
        return (logits.max(-1).values - chosen).max().item()


def _requests(tok):
    """The request set from the tokenizer: 8 greedy prompts of 17-300
    tokens (two share a system prompt of >= 64 tokens, 4 pages of 16), the
    fourth with an EOS id chosen later, and 2 sampled ones."""
    import numpy as np

    words = " ".join(CORPUS).split()
    rng = np.random.default_rng(SERVE_SEED)

    def text(n_tokens):
        out = []
        while len(tok.encode(" ".join(out))) < n_tokens:
            out.append(words[rng.integers(len(words))])
        return " ".join(out)

    system = text(64)
    texts = [text(17), system + " " + text(40), text(300), text(60), text(130),
             system + " " + text(25), text(220), text(90)]
    sampled = [text(48), text(75)]
    return texts, sampled


def _truncate(out, eos):
    out = [int(t) for t in out]
    return out[:out.index(eos) + 1] if eos is not None and eos in out else out


def _time_ms(fn, reps: int) -> float:
    """Mean host ms of ``fn`` over ``reps`` synchronised calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _last_span_seq() -> int:
    from fedml_tpu_torch.core import telemetry as tel

    return max((r["seq"] for r in tel.snapshot()["spans"]), default=0)


def _chunk_ms(n_slots: int, since: int) -> float:
    """Mean ms of the engine's decode chunks that ran with ``n_slots`` live
    slots (telemetry spans after seq ``since``), the first one dropped."""
    from fedml_tpu_torch.core import telemetry as tel

    spans = [r for r in tel.snapshot()["spans"] if r["seq"] > since
             and r["name"] == "serving.cb.chunk" and r.get("attrs", {}).get("slots") == n_slots]
    check(len(spans) >= 2, f"only {len(spans)} decode chunks ran with {n_slots} live slots")
    return sum(r["dur_ns"] for r in spans[1:]) / (len(spans) - 1) / 1e6


def _engine_run(engine, ids, sampled_ids, eos_req, eos_id):
    """Drive one engine: the system-prompt request first (so its pages are
    registered), then everything else at once; returns (greedy outputs,
    sampled outputs, tokens/s over the burst)."""
    h0 = engine.submit(ids[1], SERVE_MAX_NEW)
    first = h0.result(timeout=600)
    t0 = time.perf_counter()
    hs = {i: engine.submit(p, SERVE_MAX_NEW, eos_id=eos_id if i == eos_req else None)
          for i, p in enumerate(ids) if i != 1}
    hs_s = [engine.submit(p, SERVE_MAX_NEW, temperature=SAMPLE_TEMP, seed=s)
            for p, s in zip(sampled_ids, SAMPLE_SEEDS)]
    outs = {i: h.result(timeout=600) for i, h in hs.items()}
    outs_s = [h.result(timeout=600) for h in hs_s]
    dt = time.perf_counter() - t0
    outs[1] = first
    n = sum(len(o) for i, o in outs.items() if i != 1) + sum(len(o) for o in outs_s)
    return [outs[i] for i in range(len(ids))], outs_s, n / dt


def serve_phase() -> dict:
    """Phase 6: the serving path at Llama-2-7B's widths, SERVE_LAYERS
    layers, in bf16 on one card, through every serving entry point (see
    the module docstring)."""
    import torch

    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.serving import (ContinuousBatchingEngine, LLMPredictor,
                                         PagedContinuousBatchingEngine)
    from fedml_tpu_torch.train.llm.data import load_or_train_tokenizer
    from fedml_tpu_torch.train.llm.generation import _prefill, generate, generate_batch

    res, mem = {}, {}
    torch.cuda.reset_peak_memory_stats()
    cfg, model = _serve_model()
    mem["weights"] = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  Llama-2-7B decode model at {cfg.n_layers} layers: {n_params} params, "
        f"{mem['weights']:.2f} GB")

    # (a) the keystone, and the gate refusing a cache off by one position
    torch.cuda.reset_peak_memory_stats()
    key = keystone(model)
    mem["keystone"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"  keystone B={KEY_B} P={KEY_P} +{KEY_STEPS} steps: {key}")
    check(key["ok"], f"cached decode is {key['worst_rel']:.3g} from the full forward "
                     f"(rtol {KEY_RTOL})")
    res["keystone"] = {k: key[k] for k in ("worst_rel", "median_rel", "max_abs",
                                           "full_vs_shorter_full_worst_rel",
                                           "full_vs_shorter_full_median_rel")}
    res["keystone"]["rtol"] = KEY_RTOL
    for shift in (1, -1):
        bad = keystone(model, shift)
        say(f"  keystone with the write index off by {shift:+d}: worst row {bad['worst_rel']:.3g}")
        check(not bad["ok"], f"the keystone gate passed a cache off by {shift:+d}")
        res["keystone"][f"off_by_{shift:+d}_worst_rel"] = bad["worst_rel"]

    # (b) every serving entry point on one request set
    tok = load_or_train_tokenizer(None, None, vocab_size=512, corpus=list(CORPUS))
    texts, sampled_texts = _requests(tok)
    ids = [tok.encode(t) for t in texts]
    sampled_ids = [tok.encode(t) for t in sampled_texts]
    shared = next(i for i, (a, b) in enumerate(zip(ids[1], ids[5])) if a != b)
    say(f"  requests: greedy prompt lengths {[len(p) for p in ids]}, sampled "
        f"{[len(p) for p in sampled_ids]}, shared system prefix {shared} tokens")
    check(shared >= 4 * PAGE_SIZE, f"the shared system prefix is {shared} tokens")
    gaps = {}

    torch.cuda.reset_peak_memory_stats()
    gen_out = [generate(model, cfg, [p], SERVE_MAX_NEW, device=DEV)[0].tolist() for p in ids]
    eos_req = 3
    eos_id = gen_out[eos_req][3]
    eos_out = generate(model, cfg, [ids[eos_req]], SERVE_MAX_NEW, eos_id=eos_id,
                       device=DEV)[0].tolist()
    cut = gen_out[eos_req].index(eos_id)
    check(eos_out[:cut + 1] == gen_out[eos_req][:cut + 1]
          and all(t == eos_id for t in eos_out[cut:]), "generate's EOS fill")
    gaps["generate"] = max(greedy_gap(model, p, o) for p, o in zip(ids, gen_out))
    s_a = [generate(model, cfg, [p], SERVE_MAX_NEW, temperature=SAMPLE_TEMP, seed=s,
                    device=DEV)[0].tolist()
           for p, s in zip(sampled_ids, SAMPLE_SEEDS)]
    s_b = [generate(model, cfg, [p], SERVE_MAX_NEW, temperature=SAMPLE_TEMP, seed=s,
                    device=DEV)[0].tolist()
           for p, s in zip(sampled_ids, SAMPLE_SEEDS)]
    check(s_a == s_b, "generate: a seeded sampled request gave other tokens on its second run")
    mem["generate_b1"] = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    batch_out = [o.tolist() for o in generate_batch(model, cfg, ids, SERVE_MAX_NEW, device=DEV)]
    gaps["generate_batch"] = max(greedy_gap(model, p, o) for p, o in zip(ids, batch_out))
    mem["generate_batch_b8"] = torch.cuda.max_memory_allocated() / 1e9

    pred = LLMPredictor(model, cfg, tok, default_max_new_tokens=SERVE_MAX_NEW, device=DEV)
    p_eos = pred._eos_id
    single = [pred.predict({"prompt": t})["text"] for t in texts]
    many = [r["text"] for r in pred.predict_many([{"prompt": t} for t in texts])]
    # the predictor stops at the tokenizer's </s>: before it, its tokens are
    # generate's (B=1) and generate_batch's (B=8), computed the same way
    for i in range(len(texts)):
        check(single[i] == tok.decode(_truncate(gen_out[i], p_eos)),
              f"LLMPredictor.predict text {i} differs from generate's")
        check(many[i] == tok.decode(_truncate(batch_out[i], p_eos)),
              f"LLMPredictor.predict_many text {i} differs from generate_batch's")
    del pred

    engines = {}
    agree = {"generate_batch": _agree(batch_out, gen_out)}
    for name, make in (("slot", lambda: ContinuousBatchingEngine(
                            model, cfg, num_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, device=DEV)),
                       ("paged", lambda: PagedContinuousBatchingEngine(
                            model, cfg, num_slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                            page_size=PAGE_SIZE, num_pages=NUM_PAGES, device=DEV))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hits0 = tel.counter("serving.kv.prefix_hits").value
        engine = make()
        try:
            outs, outs_s, tps = _engine_run(engine, ids, sampled_ids, eos_req, eos_id)
            e_eos = outs[eos_req]
            check(eos_id not in e_eos[:-1] and (e_eos[-1] == eos_id or len(e_eos) == SERVE_MAX_NEW),
                  f"{name} engine: the EOS request did not stop at its EOS")
            check(all(len(o) == SERVE_MAX_NEW for i, o in enumerate(outs) if i != eos_req),
                  f"{name} engine: a request came back short")
            gaps[name] = max(greedy_gap(model, p, o, eos_id if i == eos_req else None)
                             for i, (p, o) in enumerate(zip(ids, outs)))
            def sampled():
                return [engine.generate(p, SERVE_MAX_NEW, temperature=SAMPLE_TEMP, seed=s)
                        for p, s in zip(sampled_ids, SAMPLE_SEEDS)]

            again = sampled()
            # the slot engine repeats the burst's computation in another slot
            # beside other neighbours. The paged engine prefilled these prompts
            # in full in the burst and from then on hits their registered
            # pages and prefills only the suffix: in bf16 that is other GEMM
            # shapes, so its repeat is held against a second run on that path
            ref = outs_s if name == "slot" else sampled()
            check(again == ref, f"{name} engine: a seeded sampled request gave other "
                                "tokens on its second run")
            agree[name] = _agree([o for i, o in enumerate(outs) if i != eos_req],
                                 [o for i, o in enumerate(gen_out) if i != eos_req])
            row = {"tokens_per_s": tps, "requests": len(ids) + len(sampled_ids)}
            if name == "paged":
                hits = tel.counter("serving.kv.prefix_hits").value - hits0
                check(hits >= 1, "paged engine: no prefix hit for the shared system prompt")
                leaks = engine._alloc.check_leaks()
                check(leaks["leaked"] == [] and leaks["bad_free"] == [] and leaks["accounted"],
                      f"paged engine: pages leaked after drain: {leaks}")
                row["prefix_hits"] = hits
                row["pages_retained"] = engine.stats()["kv_prefix_nodes"]
            # decode ms per token at 1 and 8 live slots: the mean of the
            # engine's chunks, divided by the chunk's tokens
            since = _last_span_seq()
            engine.generate(ids[0], 64)
            row["decode_ms_per_token_b1"] = _chunk_ms(1, since) / SERVE_CHUNK
            since = _last_span_seq()
            hs = [engine.submit(p, 64) for p in ids]
            for h in hs:
                h.result(timeout=600)
            row["decode_ms_per_token_b8"] = _chunk_ms(len(ids), since) / SERVE_CHUNK
            engines[name] = row
        finally:
            engine.shutdown()
        del engine
        mem[name] = torch.cuda.max_memory_allocated() / 1e9
        say(f"  {name} engine: {engines[name]}")
    say(f"  greedy gaps (max logit - chosen logit, teacher-forced): {gaps}; "
        f"share of greedy tokens equal to generate's: {agree}")
    for name, gap in gaps.items():
        check(gap <= GREEDY_TOL, f"{name}: a greedy token is {gap:.3g} below its row's max "
                                 f"(tolerance {GREEDY_TOL})")

    # (c) prefill and decode times
    torch.cuda.empty_cache()
    with torch.inference_mode():
        p512 = torch.randint(0, cfg.vocab_size, (1, 512), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(2))
        res["prefill_ms_b1_p512"] = _time_ms(lambda: _prefill(model, p512, 512), 5)
    for b in (1, 8):
        prompts = ids[:b]
        t16 = _time_ms(lambda: generate_batch(model, cfg, prompts, 16, device=DEV), 2)
        t48 = _time_ms(lambda: generate_batch(model, cfg, prompts, 48, device=DEV), 2)
        res[f"generate_batch_decode_ms_per_token_b{b}"] = (t48 - t16) / 32
    res["engines"] = engines
    res["greedy_gap"] = gaps
    res["greedy_tol"] = GREEDY_TOL
    res["agree_with_generate"] = agree
    res["peak_mem_gb"] = mem
    res["n_params"] = n_params
    res["n_layers"] = cfg.n_layers
    return res


def _agree(outs, refs) -> float:
    """Share of positions where two token lists agree."""
    pairs = [(a, b) for o, r in zip(outs, refs) for a, b in zip(o, r)]
    return sum(a == b for a, b in pairs) / max(1, len(pairs))


# -- phase 7: the FedAvg round of the sp simulator ---------------------------

# Parrot config 1, examples/quick_start/parrot/fedml_config.yaml as written
# (tests/test_torch_fedavg.py holds this dict to the file), with no data
# cache dir: the MNIST surrogate either way, and nothing read outside the run
PARROT = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
              partition_alpha=0.5, model="lr", federated_optimizer="FedAvg",
              client_num_in_total=2, client_num_per_round=2, comm_round=10, epochs=1,
              batch_size=10, client_optimizer="sgd", learning_rate=0.03, weight_decay=0.001,
              frequency_of_the_test=5, backend="sp")
# ResNet-56 at full width (16/32/64 channels, 56 layers, 855,770 params) on
# the CIFAR-10 surrogate (12,000 train / 2,000 test, 32x32x3), 16 silos all
# in every round (BASELINE.md's 16-silo shape), hetero alpha 0.5
RESNET = dict(random_seed=0, dataset="cifar10", data_cache_dir="", partition_method="hetero",
              partition_alpha=0.5, model="resnet56", federated_optimizer="FedAvg",
              client_num_in_total=16, client_num_per_round=16, comm_round=3, epochs=1,
              batch_size=128, client_optimizer="sgd", learning_rate=0.05, momentum=0.9,
              weight_decay=5e-4, frequency_of_the_test=1, backend="sp")
# Parrot on the card against the same run on the CPU (12,000 SGD steps in
# f32): each eval round's test_loss within rtol 1e-4 and test_correct within
# 2 of 2,000; the final params within 1e-4 of their largest magnitude (the
# tolerances tests/test_torch_fedavg.py holds the CPU port to against JAX)
PARROT_LOSS_RTOL, PARROT_ACC_SLACK, PARROT_PARAM_TOL = 1e-4, 2, 1e-4
# ResNet-56, card against CPU, cuDNN's TF32 off: the forward of the seeded
# params on the client's first batch within 1e-4 of the logits' scale (56
# f32 conv layers summed in other orders); the client's local round (3
# steps of lr 0.05, momentum 0.9, from a loss near 16) with its mean loss
# within rtol 1e-3 and its update within 5e-2 (relative L2) of the CPU's.
# The round amplifies f32 noise: on the CPU, the same round from params
# perturbed by 1e-7 (relative) moves the update by 1.5e-3. A dropped
# padding or layout change moves logits by O(1) (tests/test_torch_vision_models.py).
R56_LOGITS_TOL, R56_LOSS_RTOL, R56_UPDATE_TOL = 1e-4, 1e-3, 5e-2
R56_PARITY_CLIENT = 7   # the smallest shard: 341 examples, 3 steps, the last part-masked
# the fold against the float64 sample-weighted mean of the round's 16
# w_locals: f32 accumulation of 16 terms, within 2e-6 of each leaf's scale
FOLD_TOL = 2e-6


def _fedavg_runner(over: dict, using_gpu: bool):
    """The user's entry points: init, get_device, data.load, model.create,
    FedMLRunner."""
    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", using_gpu=using_gpu, **over))
    dev = fedml.get_device(args)
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim)
    return args, dataset, model, fedml.FedMLRunner(args, dev, dataset, model)


def _rel(a: dict, b: dict, start: dict = None) -> float:
    """||a - b|| / ||b - start|| (or / ||b||) over state dicts on the CPU."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float(((b[k].double() - (start[k].double() if start else 0)) ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def _cpu(tree: dict) -> dict:
    return {k: v.detach().to("cpu") for k, v in tree.items()}


def parrot_parity() -> dict:
    """Parrot config 1 on the card and on the CPU from the same seeded params."""
    import torch

    out = {}
    for where in (DEV, "cpu"):
        t0 = time.perf_counter()
        _, _, model, runner = _fedavg_runner(PARROT, where == "cuda")
        check(model.device.type == where, f"Parrot model on {model.device}, wanted {where}")
        p0 = _cpu(model.params)
        runner.run()
        api = runner.runner.fl_trainer
        out[where] = {"p0": p0, "hist": api.metrics_history, "s": time.perf_counter() - t0,
                      "w": _cpu(api.model_trainer.get_model_params())}
    gpu, cpu = out[DEV], out["cpu"]
    check(all(torch.equal(gpu["p0"][k], cpu["p0"][k]) for k in cpu["p0"]),
          "Parrot: the card and the CPU started from different params")
    check([m["round"] for m in gpu["hist"]] == [m["round"] for m in cpu["hist"]] == [0, 5, 9],
          f"Parrot eval rounds {[m['round'] for m in gpu['hist']]}")
    rows = []
    for g, c in zip(gpu["hist"], cpu["hist"]):
        rel = abs(g["test_loss"] - c["test_loss"]) / abs(c["test_loss"])
        rows.append({"round": g["round"], "test_loss": g["test_loss"], "test_acc": g["test_acc"],
                     "cpu_test_loss": c["test_loss"], "cpu_test_acc": c["test_acc"],
                     "loss_rel_diff": rel})
        check(rel <= PARROT_LOSS_RTOL, f"Parrot round {g['round']}: test_loss {g['test_loss']} vs "
                                       f"CPU {c['test_loss']} (rtol {PARROT_LOSS_RTOL})")
        check(abs(g["test_correct"] - c["test_correct"]) <= PARROT_ACC_SLACK,
              f"Parrot round {g['round']}: {g['test_correct']} correct vs CPU {c['test_correct']}")
    param_err = max((gpu["w"][k] - cpu["w"][k]).abs().max().item()
                    / cpu["w"][k].abs().max().item() for k in cpu["w"])
    check(param_err <= PARROT_PARAM_TOL, f"Parrot final params {param_err:.3g} of their scale apart")
    say(f"  Parrot config 1 (LR, 2 clients, 10 rounds): card {gpu['s']:.1f}s, CPU {cpu['s']:.1f}s; "
        f"eval rounds {rows}; final params {param_err:.3g} of their scale apart")
    return {"rounds": rows, "final_param_err_of_scale": param_err, "card_s": gpu["s"],
            "cpu_s": cpu["s"]}


def _client_round(args, model, shard, client_id: int):
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer

    trainer = ClassificationTrainer(model, args)
    trainer.set_id(client_id)
    trainer.train(shard)
    return _cpu(trainer.get_model_params()), trainer.last_loss, trainer.last_steps


def resnet_client_parity(args, dataset) -> dict:
    """One ResNet-56 client round on the card against the same round on the
    CPU (same seeded params, same epoch_index_array), cuDNN's TF32 off."""
    import numpy as np
    import torch

    import fedml_tpu_torch as fedml

    shard = dataset[5][R56_PARITY_CLIENT]
    res = {"client": R56_PARITY_CLIENT, "examples": len(shard)}
    x = torch.from_numpy(np.ascontiguousarray(shard.x[:RESNET["batch_size"]]))
    got = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
        for where in (DEV, "cpu"):
            model = fedml.model.create(args, dataset[-1], device=where)
            p0 = _cpu(model.params)
            with torch.no_grad():
                logits = model.module(x.to(where)).to("cpu")
            t0 = time.perf_counter()
            w, loss, steps = _client_round(args, model, shard, R56_PARITY_CLIENT)
            got[where] = dict(p0=p0, logits=logits, w=w, loss=loss, steps=steps,
                              s=time.perf_counter() - t0)
            del model
    gpu, cpu = got[DEV], got["cpu"]
    check(all(torch.equal(gpu["p0"][k], cpu["p0"][k]) for k in cpu["p0"]),
          "ResNet-56: the card and the CPU started from different params")
    res["logits_err_of_scale"] = ((gpu["logits"] - cpu["logits"]).abs().max()
                                  / cpu["logits"].abs().max()).item()
    res["steps"] = gpu["steps"]
    res["loss"], res["cpu_loss"] = gpu["loss"], cpu["loss"]
    res["loss_rel_diff"] = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    res["update_rel_err"] = _rel(gpu["w"], cpu["w"], cpu["p0"])
    res["card_s"], res["cpu_s"] = gpu["s"], cpu["s"]
    say(f"  ResNet-56 client {R56_PARITY_CLIENT} round, card vs CPU (TF32 off): {res}")
    check(np.isfinite(gpu["loss"]) and np.isfinite(cpu["loss"]), "ResNet-56 client loss not finite")
    check(res["logits_err_of_scale"] <= R56_LOGITS_TOL,
          f"ResNet-56 logits {res['logits_err_of_scale']:.3g} of their scale apart")
    check(res["loss_rel_diff"] <= R56_LOSS_RTOL, f"ResNet-56 client loss {res['loss_rel_diff']:.3g}")
    check(res["update_rel_err"] <= R56_UPDATE_TOL,
          f"ResNet-56 client update {res['update_rel_err']:.3g} from the CPU's")
    return res


def _span_sums(since: int) -> dict:
    """{round: {span name: seconds}} of the fedavg spans after seq ``since``."""
    from fedml_tpu_torch.core import telemetry as tel

    out: dict = {}
    for r in tel.snapshot()["spans"]:
        if r["seq"] > since and r["name"].startswith("fedavg."):
            row = out.setdefault(r["attrs"]["round"], {})
            row[r["name"]] = row.get(r["name"], 0.0) + r["dur_ns"] / 1e9
    return out


def fedavg_phase() -> dict:
    """Phase 7: Parrot config 1 card vs CPU; ResNet-56 at full width, one
    client round card vs CPU, then 3 rounds of 16 clients on the card
    through FedMLRunner (see the module docstring)."""
    import math

    import torch

    res = {"parrot": parrot_parity()}

    args, dataset, model, runner = _fedavg_runner(RESNET, DEV == "cuda")
    n_params = sum(p.numel() for p in model.module.parameters())
    check(model.device.type == DEV and n_params == 855770,
          f"ResNet-56 has {n_params} params on {model.device}")
    res["resnet56"] = {"params": n_params, "parity": resnet_client_parity(args, dataset)}

    api = runner.runner.fl_trainer
    p0 = _cpu(model.params)
    folds = []
    aggregate = api.aggregator.aggregate

    def recorded(pairs):  # the last round's w_locals and fold, for the check after the run
        out = aggregate(pairs)
        folds[:] = [(pairs, out)]  # references: nothing writes them after the fold
        return out

    api.aggregator.aggregate = recorded
    sizes = dataset[4]
    steps = sum(math.ceil(n / RESNET["batch_size"]) * RESNET["epochs"] for n in sizes.values())
    images = sum(sizes.values()) * RESNET["epochs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = _last_span_seq()
    t0 = time.perf_counter()
    runner.run()
    wall = time.perf_counter() - t0
    spans = _span_sums(since)
    hist = api.metrics_history
    check([m["round"] for m in hist] == [0, 1, 2], f"eval rounds {[m['round'] for m in hist]}")
    check(all(math.isfinite(m["test_loss"]) for m in hist), f"test loss not finite: {hist}")
    w = _cpu(api.model_trainer.get_model_params())
    check(all(torch.isfinite(v).all() for v in w.values()), "w_global not finite")
    moved = max(float((w[k] - p0[k]).abs().max()) for k in w)
    check(moved > 0, "w_global did not move")
    pairs, fold = folds[0]
    pairs, fold = [(n, _cpu(t)) for n, t in pairs], _cpu(fold)
    total = sum(n for n, _ in pairs)
    fold_err = max(((fold[k].double() - sum(n * t[k].double() for n, t in pairs) / total).abs().max()
                    / fold[k].double().abs().max().clamp_min(1e-30)).item() for k in fold)
    check(len(pairs) == 16 and fold_err <= FOLD_TOL,
          f"the fold of {len(pairs)} w_locals is {fold_err:.3g} from their weighted mean")
    per_round = [{"round": r, "round_s": spans[r]["fedavg.round"],
                  "client_train_s": spans[r]["fedavg.client_train"],
                  "aggregate_s": spans[r]["fedavg.aggregate"],
                  "eval_s": spans[r].get("fedavg.eval", 0.0)} for r in sorted(spans)]
    steady = per_round[1:]
    mean = {k: sum(r[k] for r in steady) / len(steady)
            for k in ("round_s", "client_train_s", "aggregate_s", "eval_s")}
    res["resnet56"].update({
        "config": {k: RESNET[k] for k in ("client_num_in_total", "client_num_per_round",
                                          "comm_round", "epochs", "batch_size",
                                          "learning_rate", "momentum", "weight_decay")},
        "precision": {"params": "float32",
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "local_steps_per_round": steps, "images_per_round": images,
        "round_s_mean_rounds_2_3": mean["round_s"],
        "rounds_per_hr": 3600.0 / mean["round_s"],
        "local_steps_per_s": steps / mean["client_train_s"],
        "images_per_s": images / mean["round_s"],
        "split_s_mean_rounds_2_3": {"client_train": mean["client_train_s"],
                                    "aggregate": mean["aggregate_s"], "eval": mean["eval_s"],
                                    "other": mean["round_s"] - mean["client_train_s"]
                                    - mean["aggregate_s"] - mean["eval_s"]},
        "per_round": per_round,
        "test_acc": [m["test_acc"] for m in hist], "test_loss": [m["test_loss"] for m in hist],
        "fold_err_of_scale": fold_err, "w_global_max_move": moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "run_wall_s": wall,
    })
    say(f"  ResNet-56, 16 clients x 3 rounds: {res['resnet56']}")
    return res

# -- phase 8: the vmapped FedAvg round ----------------------------------------

# the client-batched round of 4 clients over their first 2 steps, TF32 off,
# against the same functional step run client by client without vmap on the
# card (the plain counterpart: per-client convolutions in place of the
# grouped ones vmap makes). The last client is ragged: its second step is a
# padded one (index row 0, mask all 0, as _stack_clients pads a shard with
# fewer batches), where only weight decay and momentum move it. Limits from
# this comparison's own readings on the H100 (logits 6.5e-7 of their scale,
# updates 2.4e-4 to 6.7e-4 of theirs): about 8-15x those.
VMAP_PARITY_CLIENTS, VMAP_PARITY_STEPS = 4, 2
VMAP_LOGITS_TOL, VMAP_UPDATE_TOL = 1e-5, 5e-3


def vmap_loop_parity(api, args, model) -> dict:
    """Phase 8 (c): the vmapped local round against a loop over clients."""
    import torch

    from fedml_tpu_torch.ml.trainer.local_sgd import create_client_optimizer, make_client_loss_fn

    cohort = list(range(VMAP_PARITY_CLIENTS))
    x, y, idx, mask = api._stack_clients(cohort)
    idx, mask = idx[:, :1, :VMAP_PARITY_STEPS].clone(), mask[:, :1, :VMAP_PARITY_STEPS].clone()
    idx[-1, 0, 1:], mask[-1, 0, 1:] = 0, 0  # the ragged client's padded step
    w0 = {k: v.detach().clone() for k, v in model.params.items()}
    rows = torch.arange(len(cohort), device=x.device)[:, None]
    xb = x[rows, idx[:, 0, 0].long()]
    loss_fn = torch.func.grad_and_value(make_client_loss_fn(model, args))
    res = {"clients": len(cohort), "steps": VMAP_PARITY_STEPS,
           "real_steps": [int((mask[k, 0].sum(-1) > 0).sum()) for k in cohort]}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
        stacked0 = {k: v.expand(len(cohort), *v.shape).clone() for k, v in w0.items()}
        with torch.no_grad():
            vm_logits = torch.func.vmap(
                lambda p, b: torch.func.functional_call(model.module, p, (b,)))(stacked0, xb)
            loop_logits = torch.stack([model.apply(w0, xb[k]) for k in range(len(cohort))])
        got = api._vmapped_train(w0, x, y, idx, mask, 0)
        loop = []
        for k in range(len(cohort)):  # the plain counterpart: one client at a time
            params = {n: v.clone() for n, v in w0.items()}
            opt = create_client_optimizer(args, list(params.values()))
            for s in range(VMAP_PARITY_STEPS):
                sel = idx[k, 0, s].long()
                grads, _ = loss_fn(params, x[k, sel], y[k, sel], mask[k, 0, s], w0)
                for n, p in params.items():
                    p.grad = grads[n]
                opt.step()
            loop.append(params)
        torch.cuda.synchronize()
    res["logits_err_of_scale"] = ((vm_logits - loop_logits).abs().max()
                                  / loop_logits.abs().max()).item()
    res["update_rel_err"] = [_rel(_cpu({n: v[k] for n, v in got.params.items()}), _cpu(loop[k]),
                                  _cpu(w0)) for k in range(len(cohort))]
    say(f"  vmapped round vs client loop on the card (TF32 off): {res}")
    check(res["real_steps"] == [VMAP_PARITY_STEPS] * (len(cohort) - 1) + [1],
          f"the parity cohort's real steps {res['real_steps']}")
    check(res["logits_err_of_scale"] <= VMAP_LOGITS_TOL,
          f"vmapped logits {res['logits_err_of_scale']:.3g} of their scale from the loop's")
    check(max(res["update_rel_err"]) <= VMAP_UPDATE_TOL,
          f"vmapped client updates {res['update_rel_err']} from the loop's")
    return res


def vmap_phase() -> dict:
    """Phase 8: ResNet-56 x 16 clients through the vmapped simulator
    (backend "vmap"): the vmap-vs-loop gate, then 3 rounds on the card."""
    import math

    import torch

    from fedml_tpu_torch.core.aggregation.bucketed import get_engine

    over = dict(RESNET, backend="vmap")
    args, dataset, model, runner = _fedavg_runner(over, DEV == "cuda")
    api = runner.runner.fl_trainer
    n_params = sum(p.numel() for p in model.module.parameters())
    check(model.device.type == DEV and n_params == 855770 and type(api).__name__ == "VmapFedAvgAPI",
          f"ResNet-56 has {n_params} params on {model.device} under {type(api).__name__}")
    res = {"params": n_params, "parity": vmap_loop_parity(api, args, model)}

    p0 = _cpu(model.params)
    engine = get_engine()
    folds = []

    def recorded(stacked, weights):  # the last round's stacked fold, for the check after the run
        out = type(engine).aggregate_stacked(engine, stacked, weights)
        folds[:] = [(stacked, weights, out)]
        return out

    engine.aggregate_stacked = recorded
    sizes = dataset[4]
    bs, epochs = over["batch_size"], over["epochs"]
    steps = math.ceil(max(sizes.values()) / bs) * epochs  # batched steps a round
    images = sum(sizes.values()) * epochs                  # real images, not padded slots
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = _last_span_seq()
    t0 = time.perf_counter()
    try:
        runner.run()
    finally:
        del engine.aggregate_stacked
    wall = time.perf_counter() - t0
    spans = _span_sums(since)
    hist = api.metrics_history
    check([m["round"] for m in hist] == [0, 1, 2], f"vmap eval rounds {[m['round'] for m in hist]}")
    check(all(math.isfinite(m["test_loss"]) for m in hist), f"vmap test loss not finite: {hist}")
    w = _cpu(api.model.params)
    check(all(torch.isfinite(v).all() for v in w.values()), "vmap w_global not finite")
    moved = max(float((w[k] - p0[k]).abs().max()) for k in w)
    check(moved > 0, "vmap w_global did not move")
    stacked, weights, fold = folds[0]
    fold = _cpu(fold)
    wt = torch.as_tensor(weights, dtype=torch.float64)
    fold_err = max(((fold[k].double() - torch.tensordot(wt, stacked[k].double().cpu(), dims=1))
                    .abs().max() / fold[k].double().abs().max().clamp_min(1e-30)).item()
                   for k in fold)
    check(len(weights) == 16 and fold_err <= FOLD_TOL,
          f"the stacked fold of {len(weights)} clients is {fold_err:.3g} from their weighted mean")
    per_round = [{"round": r, "round_s": spans[r]["fedavg.round"],
                  "client_train_s": spans[r]["fedavg.client_train"],
                  "aggregate_s": spans[r]["fedavg.aggregate"],
                  "eval_s": spans[r].get("fedavg.eval", 0.0)} for r in sorted(spans)]
    steady = per_round[1:]
    mean = {k: sum(r[k] for r in steady) / len(steady)
            for k in ("round_s", "client_train_s", "aggregate_s", "eval_s")}
    res.update({
        "precision": {"params": "float32",
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "batched_steps_per_round": steps, "images_per_round": images,
        "round_s_mean_rounds_2_3": mean["round_s"],
        "rounds_per_hr": 3600.0 / mean["round_s"],
        "batched_steps_per_s": steps / mean["client_train_s"],
        "images_per_s": images / mean["round_s"],
        "split_s_mean_rounds_2_3": {"client_train": mean["client_train_s"],
                                    "aggregate": mean["aggregate_s"], "eval": mean["eval_s"],
                                    "other": mean["round_s"] - mean["client_train_s"]
                                    - mean["aggregate_s"] - mean["eval_s"]},
        "per_round": per_round,
        "test_acc": [m["test_acc"] for m in hist], "test_loss": [m["test_loss"] for m in hist],
        "fold_err_of_scale": fold_err, "w_global_max_move": moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "run_wall_s": wall,
    })
    say(f"  ResNet-56, 16 clients x 3 rounds, vmapped: {res}")
    return res


# -- phase 9: the algorithm zoo ------------------------------------------------

ZOO = ("FedNova", "SCAFFOLD", "FedDyn", "Mime")
ZOO_STATE = {"SCAFFOLD": "_scaffold_c", "FedDyn": "_feddyn_h", "Mime": "_mime_s"}
# each eval's test_loss within PARROT_LOSS_RTOL of the CPU's plus an absolute
# 1e-7: FedDyn and Mime fit the surrogate to losses of 9e-5 and 2.5e-6 in 2
# rounds, where f32 evaluation alone is 2.5e-8 from float64 (measured on the
# CPU, logits up to 27)
ZOO_LOSS_ATOL = 1e-7


def zoo_phase() -> dict:
    """Phase 9: FedNova, SCAFFOLD, FedDyn and Mime, each 2 rounds of Parrot
    config 1's shape, on the card and on the CPU from the same seeded params:
    each eval's test_loss, the final params and the server state."""
    import torch

    out = {}
    for opt in ZOO:
        runs = {}
        for where in (DEV, "cpu"):
            t0 = time.perf_counter()
            over = dict(PARROT, comm_round=2, federated_optimizer=opt)
            _, _, model, runner = _fedavg_runner(over, where == "cuda")
            check(model.device.type == where, f"{opt} model on {model.device}, wanted {where}")
            p0 = _cpu(model.params)
            runner.run()
            api = runner.runner.fl_trainer
            state = getattr(api, ZOO_STATE[opt]) if opt in ZOO_STATE else None
            runs[where] = {"p0": p0, "hist": api.metrics_history, "s": time.perf_counter() - t0,
                           "w": _cpu(api.model_trainer.get_model_params()),
                           "state": _cpu(state) if state is not None else None}
        gpu, cpu = runs[DEV], runs["cpu"]
        check(all(torch.equal(gpu["p0"][k], cpu["p0"][k]) for k in cpu["p0"]),
              f"{opt}: the card and the CPU started from different params")
        check([m["round"] for m in gpu["hist"]] == [m["round"] for m in cpu["hist"]] == [0, 1],
              f"{opt} eval rounds {[m['round'] for m in gpu['hist']]}")
        row = {"card_s": gpu["s"], "cpu_s": cpu["s"], "rounds": []}
        for g, c in zip(gpu["hist"], cpu["hist"]):
            diff = abs(g["test_loss"] - c["test_loss"])
            row["rounds"].append({"round": g["round"], "test_loss": g["test_loss"],
                                  "cpu_test_loss": c["test_loss"], "test_acc": g["test_acc"],
                                  "loss_abs_diff": diff})
            check(diff <= PARROT_LOSS_RTOL * abs(c["test_loss"]) + ZOO_LOSS_ATOL,
                  f"{opt} round {g['round']}: test_loss {g['test_loss']} vs CPU {c['test_loss']}")

        def of_scale(a, b):
            return max((a[k] - b[k]).abs().max().item() for k in b) / \
                max(b[k].abs().max().item() for k in b)

        row["final_param_err_of_scale"] = of_scale(gpu["w"], cpu["w"])
        check(row["final_param_err_of_scale"] <= PARROT_PARAM_TOL,
              f"{opt} final params {row['final_param_err_of_scale']:.3g} of their scale apart")
        if opt in ZOO_STATE:
            row["server_state"] = ZOO_STATE[opt]
            row["state_err_of_scale"] = of_scale(gpu["state"], cpu["state"])
            check(row["state_err_of_scale"] <= PARROT_PARAM_TOL,
                  f"{opt} {ZOO_STATE[opt]} {row['state_err_of_scale']:.3g} of its scale apart")
        say(f"  {opt}: {row}")
        out[opt] = row
    return out


# -- phase 10: the cross-silo front ("Octopus") over the message plane ---------

# BASELINE.md config 2: FedAvg, ResNet-56 on the CIFAR-10 surrogate, 16 silos
# all in every round: phase 7's ResNet-56 config as a cross-silo federation
# (the server and 16 clients, each a party of its own through FedMLRunner)
CROSS_SILO = {k: v for k, v in RESNET.items() if k != "backend"}
# the later phases' federations at ResNet-20, ResNet-56's widths at a third
# of its depth (272,474 params), as phase 12's drills: phase 11's compressed
# uplinks, 13, 14, 16's and 17's, to keep the smoke inside its 1,200 s on a
# host that runs the ResNet-56 round 1.4x slower than another (the smoke
# took 805-959 s with them at ResNet-56, phases 16-18 at 84-100 s each, on
# the H100)
SP_R20 = dict(RESNET, model="resnet20")
SILOS_R20 = dict(CROSS_SILO, model="resnet20")
# (b): the same model over 4 silos, 2 rounds, each party a process of its own
CS_PROCS = dict(CROSS_SILO, client_num_in_total=4, client_num_per_round=4, comm_round=2)
CS_PARTY_TIMEOUT_S = 420
# limits of the gates, each from this phase's own readings on an H100
# (PERF.md). (a) Round 1's 16 uploads and the server's fold against the sp
# simulator's round 1 from the same w_global, cuDNN deterministic, TF32 off:
# read bit-equal (the same kernels on the same inputs in the same order), so
# held bit-equal. The fold against the float64 weighted mean of its
# arrivals: read 1.97e-7 of each leaf's scale, held to 1e-6 (f32 sums of 16
# terms). (b) The cross-process server's final params against the
# in-process INMEMORY run's: read bit-equal (the wire carries f32 exactly),
# held bit-equal.
CS_UPLOAD_TOL = 0.0
CS_FOLD_TOL = 0.0
CS_MEAN_TOL = 1e-6
CS_PROC_TOL = 0.0


def _of_scale(a: dict, b: dict) -> float:
    """max |a - b| over max |b|, over state dicts (on the CPU)."""
    return max((a[k].double() - b[k].double()).abs().max().item() for k in b) / \
        max(b[k].double().abs().max().item() for k in b)


class _Federation:
    """Every party of one cross-silo federation in this process, each built
    through the user's entry points (init, get_device, model.create,
    FedMLRunner) and run as a thread. The silos' data is the one
    ``data.load`` of the config, loaded once and handed to every party (a
    silo's loader would give each the same partition)."""

    def __init__(self, over: dict, run_id: str, backend: str = "INMEMORY", per_rank=None,
                 **extra):
        import fedml_tpu_torch as fedml
        from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker

        InMemoryBroker.reset(run_id)
        self.run_id, self.runners, self.errors = run_id, {}, {}
        dataset = output_dim = None
        n = int(over.get("client_num_connected") or over["client_num_per_round"])
        for rank in range(n + 1):
            args = fedml.init(fedml.default_config(
                "cross_silo", run_id=run_id, rank=rank, role="server" if rank == 0 else "client",
                backend=backend, using_gpu=DEV == "cuda", **over, **extra,
                **(per_rank or {}).get(rank, {})))
            dev = fedml.get_device(args)
            if dataset is None:
                dataset, output_dim = fedml.data.load(args)
            args.output_dim = output_dim
            model = fedml.model.create(args, output_dim)
            check(model.device.type == DEV, f"party {rank}'s model on {model.device}")
            self.runners[rank] = fedml.FedMLRunner(args, dev, dataset, model)
        self.dataset = dataset

    @property
    def server(self):
        return self.runners[0].runner.server_manager

    def run(self, timeout_s: float = CS_PARTY_TIMEOUT_S, dies=()) -> float:
        """Run every party to its end; the ranks in ``dies`` must end by an
        exception (a chaos raise), every other rank without one."""
        import threading

        from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker

        def party(rank):
            try:
                self.runners[rank].run()
            except BaseException as e:  # noqa: BLE001 - reported below; a dead party must not hang the phase
                self.errors[rank] = repr(e)
                if rank not in dies:
                    raise

        threads = [threading.Thread(target=party, args=(r,), daemon=True, name=f"party-{r}")
                   for r in self.runners]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            check(not t.is_alive(), f"{self.run_id}: {t.name} still running after {timeout_s}s")
        wall = time.perf_counter() - t0
        InMemoryBroker.reset(self.run_id)
        check(sorted(self.errors) == sorted(dies),
              f"{self.run_id}: parties failed: {self.errors} (expected to die: {list(dies)})")
        return wall


def cross_silo_parity() -> dict:
    """Phase 10 (a), the gate: round 1 of the 16-silo federation against
    the sp simulator's round 1 of the same config from the same w_global,
    cuDNN deterministic and TF32 off. The sp trainer seeds each local round
    from its call counter unless args.round_idx is set, the cross-silo
    trainer from the round index: the sp run is given round_idx 0, so both
    train every client on the same shuffles."""
    import torch

    uploads, folds = {}, []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
        _, _, model, runner = _fedavg_runner(dict(CROSS_SILO, backend="sp", comm_round=1,
                                                  round_idx=0), DEV == "cuda")
        api = runner.runner.fl_trainer
        sp_p0 = _cpu(model.params)
        sp = {}
        aggregate = api.aggregator.aggregate

        def sp_recorded(pairs):
            out = aggregate(pairs)
            sp["pairs"], sp["fold"] = [(n, _cpu(t)) for n, t in pairs], _cpu(out)
            return out

        api.aggregator.aggregate = sp_recorded
        runner.run()
        del runner, api, model
        fed = _Federation(dict(CROSS_SILO, comm_round=1), "smoke_cs_parity")
        agg = fed.server.aggregator
        cs_p0 = _cpu(agg.get_global_model_params())
        add, cs_aggregate = agg.add_local_trained_result, agg.aggregate

        def record_add(index, params, n):
            uploads[index] = (n, _cpu(params))
            add(index, params, n)

        def record_aggregate():
            out = cs_aggregate()
            folds.append(_cpu(out))
            return out

        agg.add_local_trained_result, agg.aggregate = record_add, record_aggregate
        fed.run()
    check(all(torch.equal(sp_p0[k], cs_p0[k]) for k in sp_p0),
          "the cross-silo server and the sp simulator started from different params")
    k = int(CROSS_SILO["client_num_per_round"])
    check(sorted(uploads) == list(range(k)) and len(sp["pairs"]) == k and len(folds) == 1,
          f"uploads {sorted(uploads)}, sp clients {len(sp['pairs'])}, folds {len(folds)}")
    upload_errs = [_of_scale(uploads[i][1], sp["pairs"][i][1]) for i in range(k)]
    check(all(uploads[i][0] == sp["pairs"][i][0] for i in range(k)), "sample counts differ")
    fold = folds[0]
    fold_err = _of_scale(fold, sp["fold"])
    total = sum(n for n, _ in uploads.values())
    mean_err = max(((fold[key].double() - sum(n * t[key].double() for n, t in uploads.values())
                     / total).abs().max() / fold[key].double().abs().max().clamp_min(1e-30)).item()
                   for key in fold)
    res = {"uploads_err_of_scale_max": max(upload_errs), "uploads_bit_equal":
           sum(all(torch.equal(uploads[i][1][key], sp["pairs"][i][1][key]) for key in fold)
               for i in range(k)),
           "fold_err_of_scale": fold_err,
           "fold_bit_equal": all(torch.equal(fold[key], sp["fold"][key]) for key in fold),
           "fold_vs_f64_mean_of_scale": mean_err}
    say(f"  parity, round 1 against the sp simulator (TF32 off, deterministic): {res}")
    check(max(upload_errs) <= CS_UPLOAD_TOL, f"uploads {max(upload_errs):.3g} of scale from sp's")
    check(fold_err <= CS_FOLD_TOL, f"the fold is {fold_err:.3g} of scale from sp's")
    check(mean_err <= CS_MEAN_TOL, f"the fold is {mean_err:.3g} from its float64 weighted mean")
    return res


def _cs_round_split(since: int) -> list:
    """Per round, from the server's and the clients' spans after ``since``:
    the server.round time and its parts, and the clients' client.train."""
    from fedml_tpu_torch.core import telemetry as tel

    rows: dict = {}
    for r in tel.snapshot()["spans"]:
        if r["seq"] <= since:
            continue
        rnd = r.get("attrs", {}).get("round", r.get("trace_round"))
        if rnd is None:
            continue
        row = rows.setdefault(rnd, {"train": []})
        if r["name"] == "client.train":
            row["train"].append((r["t0_ns"], r["t0_ns"] + r["dur_ns"]))
        elif r["name"].startswith("server."):
            row[r["name"]] = row.get(r["name"], 0.0) + r["dur_ns"] / 1e9
    out = []
    for rnd in sorted(rows):
        row = rows[rnd]
        parts = {k: row.get(f"server.{k}", 0.0)
                 for k in ("round", "broadcast", "receive_model", "aggregate", "eval")}
        out.append({"round": rnd, "round_s": parts["round"], "broadcast_s": parts["broadcast"],
                    "receive_s": parts["receive_model"], "aggregate_s": parts["aggregate"],
                    "eval_s": parts["eval"],
                    "server_wait_s": parts["round"] - parts["broadcast"] - parts["receive_model"]
                    - parts["aggregate"] - parts["eval"],
                    "client_train_mean_s": sum(b - a for a, b in row["train"]) / 1e9
                    / max(1, len(row["train"])),
                    "client_train_wall_s": (max(b for _, b in row["train"])
                                            - min(a for a, _ in row["train"])) / 1e9
                    if row["train"] else 0.0,
                    "clients": len(row["train"])})
    return out


def _evals_of(fed) -> list:
    """Every eval the federation's server runs, recorded as it runs."""
    agg = fed.server.aggregator
    evals = []
    test = agg.test_on_server_for_all_clients

    def recorded(round_idx):
        m = test(round_idx)
        if m is not None:
            evals.append(dict(m))
        return m

    agg.test_on_server_for_all_clients = recorded
    return evals


def cross_silo_timed(sp: dict) -> tuple:
    """Phase 10 (a), timed: 3 rounds of the 16-silo federation in the port's
    documented precision, beside phase 7's sp round."""
    import math

    import torch

    fed = _Federation(CROSS_SILO, "smoke_cs_timed")
    server = fed.server
    p0 = _cpu(server.aggregator.get_global_model_params())
    evals = _evals_of(fed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = _last_span_seq()
    wall = fed.run()
    rows = _cs_round_split(since)
    k = int(CROSS_SILO["client_num_per_round"])
    check([r["round"] for r in rows] == [0, 1, 2] and all(r["clients"] == k for r in rows),
          f"rounds {[(r['round'], r['clients']) for r in rows]}")
    check([m["round"] for m in evals] == [0, 1, 2] and
          all(math.isfinite(m["test_loss"]) for m in evals), f"evals {evals}")
    w = server.aggregator.get_global_model_params()
    check(all(v.device.type == DEV for v in w.values()), "the global params left the card")
    w = _cpu(w)
    check(all(torch.isfinite(v).all() for v in w.values()), "w_global not finite")
    moved = max(float((w[key] - p0[key]).abs().max()) for key in w)
    check(moved > 0, "w_global did not move")
    steady = rows[1:]
    keys = ("round_s", "broadcast_s", "receive_s", "aggregate_s", "eval_s", "server_wait_s",
            "client_train_mean_s", "client_train_wall_s")
    mean = {key: sum(r[key] for r in steady) / len(steady) for key in keys}
    images = sum(fed.dataset[4].values()) * int(CROSS_SILO["epochs"])
    res = {
        "config": {key: CROSS_SILO[key] for key in ("client_num_in_total", "client_num_per_round",
                                                    "comm_round", "batch_size", "learning_rate")},
        "backend": "INMEMORY", "parties": "server + 16 client threads in one process",
        "precision": {"params": "float32", "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "round_s_mean_rounds_2_3": mean["round_s"], "rounds_per_hr": 3600.0 / mean["round_s"],
        "images_per_s": images / mean["round_s"],
        "split_s_mean_rounds_2_3": {key[:-2]: mean[key] for key in keys if key != "round_s"},
        "per_round": rows, "test_acc": [m["test_acc"] for m in evals],
        "test_loss": [m["test_loss"] for m in evals], "w_global_max_move": moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "run_wall_s": wall,
        "sp_phase7": {key: sp.get(key) for key in ("round_s_mean_rounds_2_3", "rounds_per_hr",
                                                   "images_per_s", "split_s_mean_rounds_2_3",
                                                   "peak_mem_gb")},
    }
    say(f"  ResNet-56, 16 silos x 3 rounds over INMEMORY: {res}")
    return res, fed


def cross_silo_serialized() -> dict:
    """Phase 10 (a), a diagnostic: the same 16-silo federation with the
    clients' local rounds taken one at a time (a lock shared by the client
    threads around each), so the round's excess over the sp round splits
    into the clients training at once and the rest of the front."""
    import threading

    fed = _Federation(CROSS_SILO, "smoke_cs_serial")
    lock = threading.Lock()
    for rank, runner in fed.runners.items():
        if rank == 0:
            continue
        adapter = runner.runner.client_manager.trainer_dist_adapter

        def locked(round_idx=None, _train=adapter.train):
            with lock:
                return _train(round_idx)

        adapter.train = locked
    since = _last_span_seq()
    fed.run()
    rows = _cs_round_split(since)
    steady = rows[1:]
    res = {"round_s_mean_rounds_2_3": sum(r["round_s"] for r in steady) / len(steady),
           "client_train_wall_s_mean_rounds_2_3":
               sum(r["client_train_wall_s"] for r in steady) / len(steady),
           "per_round_s": [r["round_s"] for r in rows]}
    say(f"  the same federation with the local rounds one at a time: {res}")
    return res


def _timed_store(cls, store: dict, path_of) -> None:
    """Count and time ``cls``'s payload writes and reads into ``store`` (in
    this party process); ``path_of(self, url)`` is a written object's file."""
    write_model, read_model = cls.write_model, cls.read_model

    def timed_write(self, key, params):
        t0 = time.perf_counter()
        url = write_model(self, key, params)
        store["write_s"] += time.perf_counter() - t0
        store["writes"] += 1
        store["bytes_written"] += os.path.getsize(path_of(self, url))
        return url

    def timed_read(self, url):
        t0 = time.perf_counter()
        out = read_model(self, url)
        store["read_s"] += time.perf_counter() - t0
        store["reads"] += 1
        return out

    cls.write_model, cls.read_model = timed_write, timed_read


def _counted_frames(store: dict) -> None:
    """Count TRPC's payload frames and their bytes (header and buffers)
    into ``store``, and time each send of one."""
    from fedml_tpu_torch.core.distributed.communication.trpc import trpc_comm_manager as trpc

    encode, send = trpc.encode_frame, trpc.TRPCCommManager.send_message

    def counted(msg):
        header, bufs = encode(msg)
        if bufs:
            store["writes"] += 1
            store["bytes_written"] += len(header) + sum(b.nbytes for b in bufs)
        return header, bufs

    def timed_send(self, msg):
        t0 = time.perf_counter()
        send(self, msg)
        if msg.get("model_params") is not None:
            store["write_s"] += time.perf_counter() - t0

    trpc.encode_frame, trpc.TRPCCommManager.send_message = counted, timed_send


def party_main(spec_json: str) -> None:
    """One party of phase 10 (b) or 16 (a)-(b), in a process of its own
    (started by _party_processes): build it through the user's entry
    points, run it, and print one JSON line of what it saw."""
    import torch

    spec = json.loads(spec_json)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core import telemetry as tel

    store = {"write_s": 0.0, "read_s": 0.0, "writes": 0, "reads": 0, "bytes_written": 0}
    backend = spec["config"]["backend"]
    if backend == "MQTT_S3":
        from fedml_tpu_torch.core.distributed.communication.mqtt_s3.object_store import (
            LocalObjectStore)

        _timed_store(LocalObjectStore, store, lambda self, url: url[len("file://"):])
    elif backend == "MQTT_WEB3":
        from fedml_tpu_torch.core.distributed.communication.web3 import LocalCASStore

        _timed_store(LocalCASStore, store, lambda self, url: self._path(url[len("cas://"):]))
    elif backend == "TRPC":
        _counted_frames(store)
    args = fedml.init(fedml.default_config("cross_silo", **spec["config"]))
    dev = fedml.get_device(args)
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim)
    runner = fedml.FedMLRunner(args, dev, dataset, model)
    t_ready = time.time()
    metrics = runner.run()
    out = {"rank": args.rank, "device": str(model.device), "t_ready": t_ready,
           "t_end": time.time(), "store": store}
    if args.role == "server":
        w = runner.runner.server_manager.aggregator.get_global_model_params()
        out["global_device"] = str(next(iter(w.values())).device)
        torch.save(_cpu(w), spec["params_out"])
        out["metrics"] = metrics
        out["round_s"] = [r["dur_ns"] / 1e9 for r in tel.snapshot()["spans"]
                          if r["name"] == "server.round"]
    print(json.dumps(out), flush=True)


def _inmemory_reference(over: dict, run_id: str) -> dict:
    """The server's final params of ``over`` run in this process over
    INMEMORY, cuDNN deterministic and TF32 off (the party processes' flags)."""
    import torch

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        ref = _Federation(over, run_id)
        ref.run()
        return _cpu(ref.server.aggregator.get_global_model_params())


def _party_processes(tmp: str, over: dict, run_id: str, backend: str) -> tuple:
    """A server and ``client_num_per_round`` client processes of ``over``
    over ``backend`` (clients started first), each under a timeout; returns
    (each rank's JSON line, each rank's spawn time, the server's final
    params on the CPU)."""
    import torch

    os.makedirs(tmp, exist_ok=True)
    n = int(over["client_num_per_round"])
    procs, logs, spawned = {}, {}, {}
    params_out = os.path.join(tmp, "server_params.pt")
    try:
        for rank in list(range(1, n + 1)) + [0]:
            spec = {"config": dict(over, run_id=run_id, rank=rank,
                                   role="server" if rank == 0 else "client", backend=backend,
                                   using_gpu=DEV == "cuda"),
                    "params_out": params_out}
            code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                    f"chip_smoke.party_main({json.dumps(spec)!r})")
            logs[rank] = (open(os.path.join(tmp, f"party{rank}.out"), "w+"),
                          open(os.path.join(tmp, f"party{rank}.err"), "w+"))
            spawned[rank] = time.time()
            procs[rank] = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                           stdout=logs[rank][0], stderr=logs[rank][1])
        deadline = time.monotonic() + CS_PARTY_TIMEOUT_S
        for rank, p in procs.items():
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                check(False, f"{backend} party {rank} still running after {CS_PARTY_TIMEOUT_S}s")
        results = {}
        for rank, p in procs.items():
            out, err = logs[rank]
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            check(p.returncode == 0 and lines,
                  f"{backend} party {rank} exited {p.returncode}: {err.read()[-3000:]}")
            results[rank] = json.loads(lines[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (f for pair in logs.values() for f in pair):
            f.close()
    for rank, r in results.items():
        check(r["device"].startswith(DEV), f"{backend} party {rank} ran on {r['device']}")
    check(results[0]["global_device"].startswith(DEV),
          f"the {backend} server's global on {results[0]['global_device']}")
    return results, spawned, torch.load(params_out)


def _process_report(over: dict, results: dict, spawned: dict, got: dict, ref_w: dict) -> dict:
    """The cross-process run's numbers beside its final params against the
    INMEMORY reference's."""
    import torch

    rounds = int(over["comm_round"])
    store = {key: sum(r["store"][key] for r in results.values())
             for key in ("write_s", "read_s", "writes", "reads", "bytes_written")}
    server = results[0]
    return {
        "config": {key: over[key] for key in ("client_num_per_round", "comm_round",
                                              "batch_size")},
        "processes": len(results),
        "final_params_err_of_scale_vs_inmemory": _of_scale(got, ref_w),
        "final_params_bit_equal": all(torch.equal(got[key], ref_w[key]) for key in ref_w),
        "round_s": server["round_s"], "test_acc": server["metrics"]["test_acc"],
        "payload_bytes_per_round": store["bytes_written"] / rounds,
        "object_store": {**store, "write_ms_mean": 1e3 * store["write_s"] / max(1, store["writes"]),
                         "read_ms_mean": 1e3 * store["read_s"] / max(1, store["reads"])},
        "start_to_ready_s": {str(rank): r["t_ready"] - spawned[rank] for rank, r in results.items()},
        "start_to_end_s": {str(rank): r["t_end"] - spawned[rank] for rank, r in results.items()},
    }


def cross_silo_processes(procs: tuple, ref_w: dict) -> dict:
    """Phase 10 (b): a server and 4 client processes over the port's
    SocketMqttBroker (hosted here) with one shared object store, ResNet-56,
    2 rounds, cuDNN deterministic and TF32 off (``procs``, what
    _party_processes returned); its final params against ``ref_w``, the
    same federation run in this process over INMEMORY."""
    results, spawned, got = procs
    res = {**_process_report(CS_PROCS, results, spawned, got, ref_w),
           "backend": "MQTT_S3 over SocketMqttBroker"}
    n, rounds = int(CS_PROCS["client_num_per_round"]), int(CS_PROCS["comm_round"])
    store = res["object_store"]
    say(f"  ResNet-56, 4 silos x {rounds} rounds, 5 processes over MQTT_S3: {res}")
    check(store["writes"] == 2 * n * rounds and store["reads"] == 2 * n * rounds,
          f"object store writes {store['writes']}, reads {store['reads']}")
    err = res["final_params_err_of_scale_vs_inmemory"]
    check(err <= CS_PROC_TOL, f"cross-process final params {err:.3g} of scale from INMEMORY's")
    return res


def cross_silo_wire(fed) -> dict:
    """Phase 10 (c): the wire at the card boundary. A state dict of card
    tensors in f32 and bf16 through the wire layout and the codec, bit-exact;
    the aggregator ingesting a CPU arrival with one host-to-device copy per
    dtype group."""
    import torch

    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.core.distributed.communication.codec import (message_from_bytes,
                                                                      message_to_bytes)
    from fedml_tpu_torch.core.distributed.communication.message import Message
    from fedml_tpu_torch.core.distributed.fedml_comm_manager import (from_wire_layout,
                                                                     to_wire_layout)
    from fedml_tpu_torch.utils.pytree import H2D_TRANSFERS

    agg = fed.server.aggregator
    w = agg.get_global_model_params()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        src = {key: v.to(dtype) for key, v in w.items()}
        msg = Message(3, 1, 0)
        msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, to_wire_layout(src))
        t0 = time.perf_counter()
        frame = message_to_bytes(msg)
        back = from_wire_layout(message_from_bytes(frame).get(Message.MSG_ARG_KEY_MODEL_PARAMS))
        res[f"{str(dtype)[6:]}_round_trip_ms"] = 1e3 * (time.perf_counter() - t0)
        res[f"{str(dtype)[6:]}_frame_bytes"] = len(frame)
        check(sorted(back) == sorted(src), "wire keys differ")
        check(all(back[key].dtype == dtype and back[key].device.type == "cpu" and
                  torch.equal(back[key], src[key].cpu()) for key in src),
              f"the {dtype} state dict did not round-trip bit-exactly")
    names = list(w)
    # on the card one copy per dtype group; a CPU server has nothing to copy
    for label, groups in (("f32", 1), ("f32_bf16", 2)) if DEV == "cuda" else (("f32", 0),):
        arrival = {key: v.to("cpu", torch.bfloat16 if label == "f32_bf16" and i % 2 else
                             torch.float32) for i, (key, v) in enumerate(w.items())}
        before = tel.get_telemetry().counter(H2D_TRANSFERS).value
        agg.add_local_trained_result(0, arrival, 1)
        copies = tel.get_telemetry().counter(H2D_TRANSFERS).value - before
        landed = agg.model_dict.pop(0)
        agg.flag_client_model_uploaded_dict[0] = False
        res[f"ingest_{label}_leaves"] = len(names)
        res[f"ingest_{label}_copies"] = copies
        check(copies == groups, f"ingesting {label}: {copies} host-to-device copies, want {groups}")
        check(all(landed[key].device.type == DEV and torch.equal(landed[key].cpu(), arrival[key])
                  for key in names), f"ingesting {label}: leaves not on the card or changed")
    say(f"  the wire at the card boundary: {res}")
    return res


def cross_silo_phase(sp: dict) -> dict:
    """Phase 10: the cross-silo front, (a) in process, (b) across processes,
    (c) the wire at the card boundary ((d), no flash launch, is main's).
    (b)'s processes run beside (a)'s parity gate and (b)'s INMEMORY
    reference, which time nothing; (a)'s timed rounds come after them."""
    from concurrent.futures import ThreadPoolExecutor

    from fedml_tpu_torch.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker

    tmp = os.path.join(ROOT, ".smoke_run", "cross_silo")
    shutil.rmtree(tmp, ignore_errors=True)
    broker = SocketMqttBroker(port=0)
    try:
        with ThreadPoolExecutor(1) as pool:
            procs = pool.submit(_party_processes, tmp, dict(
                CS_PROCS, mqtt_socket=broker.address,
                object_store_dir=os.path.join(tmp, "object_store")), "smoke_cs_procs", "MQTT_S3")
            res = {"parity": cross_silo_parity()}
            ref_w = _inmemory_reference(CS_PROCS, "smoke_cs_ref")
            procs = procs.result()
        res["processes_4"] = cross_silo_processes(procs, ref_w)
    finally:
        broker.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    res["inmemory_16"], fed = cross_silo_timed(sp)
    res["wire"] = cross_silo_wire(fed)
    del fed
    res["inmemory_16"]["training_serialized"] = cross_silo_serialized()
    return res


# -- phase 11: async federation (FedBuff) and the compressed uplink ------------

# phase 7's ResNet-56 x 16 clients through the vmapped async driver
# (FedMLRunner, backend "vmap", async_rounds): 16 clients in flight, a
# publish every 8 merges, 4 publishes, staleness exponent 0.5, cut 10,
# delays lognormal around 1.0 with spread 0.5
ASYNC_VMAP = dict(RESNET, backend="vmap", async_rounds=True, async_publish_k=8, comm_round=4,
                  async_staleness_exponent=0.5, async_max_staleness=10, async_mean_delay=1.0,
                  async_delay_heterogeneity=0.5)
# simulate_async_rounds at two fleet sizes over the ResNet-56 state dict
ASYNC_SIM_CLIENTS = (1000, 10000)
ASYNC_SIM = dict(publish_k=32, gen_batch=1024, publishes=8, seed=0)
# the cross-silo front: phase 10's 16 silos in async mode (4 publishes of 8
# merges), then its synchronous federation cut to 2 rounds, plain, eftopk at
# ratio 1.0 and topk at ratio 0.05
CS_ASYNC = dict(CROSS_SILO, async_rounds=True, async_publish_k=8, comm_round=4)
CS_COMPRESSED = dict(SILOS_R20, comm_round=2)
LOSSY_RATIO = 0.05
# the streaming fold (publish_k 32 = two buckets, scaled after the fold)
# against the float64 weighted mean of its 32 state dicts: f32 sums of 32
# terms and one f32 scale, within 1e-6 of each leaf's scale
ASYNC_STREAM_TOL = 1e-6


def _client_trees(template: dict, n: int, seed: int) -> list:
    """``n`` distinct ResNet-56 state dicts on the card: the template plus
    seeded noise (the async driver's synthetic delta)."""
    from fedml_tpu_torch.simulation.vmapped.async_driver import make_synthetic_delta_fn

    stacked = make_synthetic_delta_fn(seed=seed)(template, list(range(n)), 0)
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def async_parity(template: dict, counts: list) -> dict:
    """Phase 11 (a): exponent 0 and publish_k = 16 = the bucket publishes
    through engine.aggregate, bit for bit; publish_k = 32 folds two buckets
    as they fill and scales after, within ASYNC_STREAM_TOL of the float64
    weighted mean. cuDNN's TF32 off."""
    import torch

    from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine

    engine = get_engine()
    check(engine.bucket_size == 16, f"bucket size {engine.bucket_size}")
    res = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        trees = _client_trees(template, 16, seed=1)
        pairs = [(float(counts[i]), trees[i]) for i in range(16)]
        buf = AsyncAggBuffer(16, StalenessPolicy(exponent=0.0), engine)
        verdicts = [buf.submit(i, t, n, client_version=0) for i, (n, t) in enumerate(pairs)]
        out, ref = buf.publish(), engine.aggregate(pairs)
        res["publish_k_16_bit_equal"] = all(torch.equal(out[k], ref[k]) for k in ref)
        check(verdicts == ["accept"] * 16, f"verdicts {verdicts}")
        check(res["publish_k_16_bit_equal"], "the exponent-0 publish of one bucket is not "
                                             "bit-equal to engine.aggregate")
        trees = _client_trees(template, 32, seed=2)
        pairs = [(float(counts[i % 16]), trees[i]) for i in range(32)]
        buf = AsyncAggBuffer(32, StalenessPolicy(exponent=0.0), engine)
        for i, (n, t) in enumerate(pairs):
            buf.submit(i, t, n, client_version=0)
        pending = buf.statusz()["pending_unfolded"]
        out = _cpu(buf.publish())
    total = sum(n for n, _ in pairs)
    err = max(((out[k].double() - sum(n * t[k].double().cpu() for n, t in pairs) / total)
               .abs().max() / out[k].double().abs().max().clamp_min(1e-30)).item() for k in out)
    res.update({"publish_k_32_vs_f64_mean_of_scale": err, "pending_after_32": pending})
    say(f"  (a) parity: {res}")
    check(pending == 0, f"{pending} arrivals left unfolded after two full buckets")
    check(err <= ASYNC_STREAM_TOL, f"the streaming fold is {err:.3g} from its float64 mean")
    return res


def _span_totals(since: int, names) -> dict:
    """{name: (count, seconds)} of the spans after seq ``since``."""
    from fedml_tpu_torch.core import telemetry as tel

    out = {n: [0, 0.0] for n in names}
    for r in tel.snapshot()["spans"]:
        if r["seq"] > since and r["name"] in out:
            out[r["name"]][0] += 1
            out[r["name"]][1] += r["dur_ns"] / 1e9
    return {n: {"count": c, "s": s} for n, (c, s) in out.items()}


def async_vmap() -> tuple:
    """Phase 11 (b): the vmapped async driver through FedMLRunner."""
    import math

    import torch

    args, dataset, model, runner = _fedavg_runner(ASYNC_VMAP, DEV == "cuda")
    api = runner.runner.fl_trainer
    check(type(api).__name__ == "VmapAsyncFedAvgAPI", f"backend vmap + async_rounds ran "
                                                      f"{type(api).__name__}")
    p0 = _cpu(model.params)
    trained = []
    stack = api._stack_clients

    def counting(ids):  # the clients each generation batch trains
        trained.extend(ids)
        return stack(ids)

    api._stack_clients = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = _last_span_seq()
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats, hist = api.stats, api.metrics_history
    check(stats["publishes"] == ASYNC_VMAP["comm_round"], f"publishes {stats['publishes']}")
    check([m["round"] for m in hist] == list(range(ASYNC_VMAP["comm_round"])) and
          all(math.isfinite(m["test_loss"]) for m in hist), f"evals {hist}")
    w = _cpu(api.model.params)
    check(all(torch.isfinite(v).all() for v in w.values()), "async w_global not finite")
    moved = max(float((w[k] - p0[k]).abs().max()) for k in w)
    check(moved > 0, "async w_global did not move")
    images = sum(dataset[4][c] for c in trained) * ASYNC_VMAP["epochs"]
    spans = _span_totals(since, ("async.merge", "async.publish"))
    res = {"config": {k: ASYNC_VMAP[k] for k in (
               "client_num_in_total", "client_num_per_round", "async_publish_k", "comm_round",
               "async_staleness_exponent", "async_max_staleness", "async_mean_delay",
               "async_delay_heterogeneity", "batch_size")},
           "precision": {"params": "float32", "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32},
           "stats": stats, "run_wall_s": wall,
           "publishes_per_hr": 3600.0 * stats["publishes"] / wall,
           "clients_trained": len(trained), "images_trained": images,
           "images_per_s": images / wall, "spans": spans,
           "test_loss": [m["test_loss"] for m in hist], "test_acc": [m["test_acc"] for m in hist],
           "w_global_max_move": moved, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    say(f"  (b) vmapped async driver, ResNet-56 x 16 in flight: {res}")
    return res, model.params, [dataset[4][c] for c in range(16)]


def _synced_recording_sink(raw):
    """The async sink of ``raw`` (a buffer or a hierarchy tree) that waits
    for the card after each submit and publish, so the simulator's
    server_seconds hold the device's work, and records every arrival's
    (client, version, verdict)."""
    import torch

    from fedml_tpu_torch.core.engine import as_async_sink

    class Sink(type(as_async_sink(raw))):
        def __init__(self, raw_):
            super().__init__(raw_)
            self.trace = []

        def submit(self, rank, tree, weight, client_version):
            verdict = super().submit(rank, tree, weight, client_version)
            torch.cuda.synchronize()
            self.trace.append((int(rank), int(client_version), verdict))
            return verdict

        def try_publish(self):
            out = super().try_publish()
            torch.cuda.synchronize()
            return out

    return Sink(raw)


def async_fleet(template: dict) -> dict:
    """Phase 11 (c): simulate_async_rounds over the ResNet-56 state dict at
    1,000 and 10,000 clients; the same seed twice gives the same trace."""
    import torch

    from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine
    from fedml_tpu_torch.simulation.vmapped.async_driver import simulate_async_rounds

    res, traces = {}, []
    for n in ASYNC_SIM_CLIENTS + ASYNC_SIM_CLIENTS[:1]:
        sink = _synced_recording_sink(AsyncAggBuffer(ASYNC_SIM["publish_k"], engine=get_engine()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = simulate_async_rounds(n, ASYNC_SIM["publish_k"], template,
                                      ASYNC_SIM["publishes"], gen_batch=ASYNC_SIM["gen_batch"],
                                      buffer=sink, seed=ASYNC_SIM["seed"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(stats["publishes"] == ASYNC_SIM["publishes"], f"{n} clients: {stats}")
        traces.append((n, sink.trace))
        if str(n) in res:
            continue
        res[str(n)] = {**stats, "run_wall_s": wall,
                       "rounds_per_hr_server_s": 3600.0 * stats["publishes"]
                       / stats["server_seconds"],
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    small, large = (str(n) for n in ASYNC_SIM_CLIENTS)
    res["ratio_large_over_small"] = (res[large]["rounds_per_hr_server_s"]
                                     / res[small]["rounds_per_hr_server_s"])
    same = traces[0][1] == traces[2][1]
    res["same_seed_same_trace"] = same
    res["config"] = dict(ASYNC_SIM)
    say(f"  (c) simulate_async_rounds over ResNet-56: {res}")
    check(same and len(traces[0][1]) > 0, "the same seed gave another event trace")
    return res


def cross_silo_async() -> dict:
    """Phase 11 (d): the cross-silo front with async rounds over INMEMORY,
    16 silos, a publish every 8 merges, 4 publishes."""
    import math

    import torch

    fed = _Federation(CS_ASYNC, "smoke_cs_async")
    agg = fed.server.aggregator
    p0 = _cpu(agg.get_global_model_params())
    evals = _evals_of(fed)
    stamps = []
    publish = agg.publish_async

    def stamped():
        out = publish()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    agg.publish_async = stamped
    torch.cuda.synchronize()
    since = _last_span_seq()
    t0 = time.perf_counter()
    wall = fed.run()
    buf = agg.async_buffer
    check(buf.version == CS_ASYNC["comm_round"] and len(stamps) == CS_ASYNC["comm_round"],
          f"async server at version {buf.version} after {len(stamps)} publishes")
    check([m["round"] for m in evals] == list(range(CS_ASYNC["comm_round"])) and
          all(math.isfinite(m["test_loss"]) for m in evals), f"async evals {evals}")
    w = _cpu(agg.get_global_model_params())
    check(all(torch.isfinite(v).all() for v in w.values()), "async w_global not finite")
    check(max(float((w[k] - p0[k]).abs().max()) for k in w) > 0, "async w_global did not move")
    gaps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    res = {"config": {k: CS_ASYNC[k] for k in ("client_num_per_round", "async_publish_k",
                                               "comm_round")},
           "run_wall_s": wall, "s_per_publish": gaps, "s_per_publish_mean": wall / len(stamps),
           "statusz": {k: v for k, v in buf.statusz().items() if k != "client_versions"},
           "spans": _span_totals(since, ("server.async_receive", "async.merge", "async.publish",
                                         "server.eval", "client.train")),
           "test_loss": [m["test_loss"] for m in evals]}
    say(f"  (d) cross-silo async rounds, 16 silos: {res}")
    return res


def cross_silo_compressed() -> dict:
    """Phase 11 (d): the synchronous 16-silo federation twice, plain and
    with eftopk at ratio 1.0, cuDNN deterministic and TF32 off: the final
    params bit-equal; then topk at ratio LOSSY_RATIO to an end with finite
    metrics."""
    import math

    import torch

    from fedml_tpu_torch.utils.compression import payload_nbytes

    res, finals = {}, {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for label, extra in (("plain", {}), ("eftopk_1.0", dict(comm_compressor="eftopk",
                                                                 comm_compressor_ratio=1.0))):
            fed = _Federation(dict(CS_COMPRESSED, **extra), f"smoke_cs_{label}")
            evals = _evals_of(fed)
            since = _last_span_seq()
            wall = fed.run()
            finals[label] = (_cpu(fed.server.aggregator.get_global_model_params()), evals)
            res[label] = {"run_wall_s": wall, "spans": _span_totals(
                since, ("client.compress", "server.decompress"))}
            del fed
    (pw, pe), (cw, ce) = finals["plain"], finals["eftopk_1.0"]
    res["eftopk_1.0"]["bit_equal_to_plain"] = same = \
        list(pw) == list(cw) and all(torch.equal(pw[k], cw[k]) for k in pw) and pe == ce
    check(res["eftopk_1.0"]["spans"]["server.decompress"]["count"] ==
          int(CS_COMPRESSED["client_num_per_round"]) * int(CS_COMPRESSED["comm_round"]),
          f"decompressed arrivals: {res['eftopk_1.0']['spans']}")
    check(same, "the eftopk ratio-1.0 federation is not bit-equal to the plain one")
    fed = _Federation(dict(CS_COMPRESSED, comm_compressor="topk",
                           comm_compressor_ratio=LOSSY_RATIO), "smoke_cs_topk")
    evals = _evals_of(fed)
    sizes = []
    for rank, runner in fed.runners.items():
        if rank:
            comp = runner.runner.client_manager._comm_compressor

            def recording(tree, _f=comp.compress_tree):
                payload = _f(tree)
                sizes.append(payload_nbytes(payload))
                return payload
            comp.compress_tree = recording
    since = _last_span_seq()
    wall = fed.run()
    check(evals and all(math.isfinite(m["test_loss"]) for m in evals), f"topk evals {evals}")
    spans = _span_totals(since, ("client.compress", "server.decompress"))
    res[f"topk_{LOSSY_RATIO}"] = {
        "run_wall_s": wall, "spans": spans, "payload_bytes": sorted(set(sizes)),
        "dense_bytes": 4 * sum(v.numel() for v in pw.values()),
        "client_compress_ms_mean": 1e3 * spans["client.compress"]["s"]
        / max(1, spans["client.compress"]["count"]),
        "server_decompress_ms_mean": 1e3 * spans["server.decompress"]["s"]
        / max(1, spans["server.decompress"]["count"]),
        "test_loss": [m["test_loss"] for m in evals]}
    say(f"  (d) compressed uplinks, 16 silos x {CS_COMPRESSED['comm_round']} rounds: {res}")
    return res


def compression_timed(template: dict) -> dict:
    """Phase 11 (d): CommCompressor.compress_tree and the server's
    decompression of the ResNet-56 state dict on the card, synchronised
    (the spans above time the host's enqueue only)."""
    from fedml_tpu_torch.utils.compression import CommCompressor, decompress_comm_payload

    res = {}
    for kind, ratio in (("topk", LOSSY_RATIO), ("eftopk", 1.0)):
        comp = CommCompressor(kind, ratio=ratio)
        payload = comp.compress_tree(template)
        res[f"{kind}_{ratio}"] = {
            "compress_ms": _time_ms(lambda: comp.compress_tree(template), 20),
            "decompress_ms": _time_ms(lambda: decompress_comm_payload(payload), 20)}
    say(f"  (d) compression on the card, ResNet-56 state dict: {res}")
    return res


def async_phase() -> dict:
    """Phase 11: (a) the buffer's parity gate, (b) the vmapped async
    driver, (c) simulate_async_rounds at two fleet sizes, (d) the cross-silo
    front in async mode and with compressed uplinks ((e), no flash launch,
    is main's)."""
    res = {}
    res["vmap_async"], template, counts = async_vmap()
    res["parity"] = async_parity(template, counts)
    res["fleet"] = async_fleet(template)
    res["compression_ms"] = compression_timed(template)
    del template
    res["cross_silo_async"] = cross_silo_async()
    res["cross_silo_compressed"] = cross_silo_compressed()
    return res


# -- phase 12: resilience: durable round state, quorum rounds, chaos drills -------

# (a), (c), (d): the SIGKILL drills of fedml_tpu_torch/tools/resilience_drill.py,
# each mode a process of its own on the card, deterministic (the tool sets
# CUBLAS_WORKSPACE_CONFIG, cuDNN deterministic, TF32 off and
# torch.use_deterministic_algorithms before CUDA initialises): sp 16 clients
# x 3 rounds under FedOpt (Adam), cs a server and 4 silo threads x 3 rounds,
# cs_async one silo, a publish every 2 merges, 3 publishes, a snapshot after
# every merge. ResNet-20, ResNet-56's widths at a third of its depth: with
# phase 17 the whole smoke took 1,091 s on the H100, the drills at ResNet-56
# 196 s of this phase's 256 s (and (b)'s fourth round 20 s)
RES_DRILL_MODEL = "resnet20"
RES_DRILL_TIMEOUT_S = 300
# (b): phase 10's 16 silos as a quorum federation: 12 a round, quorum 0.75,
# a 15 s deadline shortened by the adaptive rule, over-provisioning by 0.25
# once health flags a straggler; silo 16 dies in round 0, silo 15 sleeps 8 s
# before every local round (it arrives at about 8.2 s, well inside the
# deadline that round 0 waits out for the dead silo)
QUORUM = dict(CROSS_SILO, client_num_in_total=16, client_num_per_round=12,
              client_num_connected=16, comm_round=2, frequency_of_the_test=5,
              quorum_frac=0.75, round_deadline_s=15.0, adaptive_deadline=True,
              overprovision_frac=0.25)
QUORUM_DEAD, QUORUM_STRAGGLER, QUORUM_DELAY_S = 16, 15, 8.0
QUORUM_TIMEOUT_S = 300


def _drill(name: str, mode: str, rdir: str, expect_kill: bool = False) -> dict:
    """One run of the drill tool in a process of its own; its report (none
    for a crash, which dies by SIGKILL) with the spawn time."""
    report = rdir + f".{mode}.json"
    cmd = [sys.executable, "-m", "fedml_tpu_torch.tools.resilience_drill", name, mode, rdir,
           "--device", DEV, "--model", RES_DRILL_MODEL, "--report", report]
    spawn = time.time()
    with open(rdir + f".{mode}.log", "w") as log:
        proc = subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                              timeout=RES_DRILL_TIMEOUT_S,
                              env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    wall = time.time() - spawn
    if expect_kill:
        check(proc.returncode in (-9, 137), f"{name} {mode}: exit {proc.returncode}, not SIGKILL "
                                            f"(log {rdir}.{mode}.log)")
        return {"spawn_unix": spawn, "wall_s": wall, "rc": proc.returncode}
    check(proc.returncode == 0, f"{name} {mode}: exit {proc.returncode} (log {rdir}.{mode}.log)")
    with open(report) as f:
        out = json.load(f)
    check(out["device"] == DEV and (DEV != "cuda" or out["card"]), f"{name} {mode} ran on {out}")
    return {**out, "spawn_unix": spawn, "wall_s": wall}


def resilience_drill(name: str, tmp: str) -> dict:
    """Phase 12 (a), (c), (d): the baseline and the crash of one drill side
    by side, then the resume; the resumed store's final state bit-equal to
    the baseline's."""
    from concurrent.futures import ThreadPoolExecutor

    from fedml_tpu_torch.tools import resilience_drill as rd

    base, crash = os.path.join(tmp, f"{name}_baseline"), os.path.join(tmp, f"{name}_crash")
    with ThreadPoolExecutor(2) as pool:
        b = pool.submit(_drill, name, "baseline", base)
        c = pool.submit(_drill, name, "crash", crash, expect_kill=True)
        b, c = b.result(), c.result()
    final, partial = rd.final_state(base), rd.final_state(crash)
    check(final is not None and partial is not None, f"{name}: an empty store")
    res = {"baseline_run_s": b["run_s"], "crash_rc": c["rc"],
           "crash_store_round": partial.round_idx, "final_round": final.round_idx}
    if name == "cs_async":
        buf = partial.meta.get("async_buffer") or {}
        res["crash_buffer"] = {k: buf.get(k) for k in ("version", "merges_total",
                                                       "merges_since_publish")}
        res["crash_buffer"]["pending"] = len(buf.get("pending_weights") or [])
        check(buf.get("merges_total") == rd.KILL_AFTER_MERGES and res["crash_buffer"]["pending"] > 0
              and len((partial.state.get("async_buffer") or {}).get("pending") or []) > 0,
              f"cs_async: the crash store's newest snapshot holds no pending arrival: {res}")
    else:
        check(partial.round_idx < final.round_idx, f"{name}: the crash store reached round "
                                                   f"{partial.round_idx} of {final.round_idx}")
    r = _drill(name, "resume", crash)
    resumed = rd.final_state(crash)
    res["bit_equal"] = resumed.round_idx == final.round_idx and rd.bit_equal(resumed.state,
                                                                            final.state)
    res["state_keys"] = sorted(final.state)
    res["resume_run_s"] = r["run_s"]
    res["process_wall_s"] = {"baseline": b["wall_s"], "crash": c["wall_s"], "resume": r["wall_s"]}
    res["start_to_first_resumed_round_s"] = r["first_save_unix"] - r["spawn_unix"]
    res["start_to_main_s"] = r["main_start_unix"] - r["spawn_unix"]
    for key, rep in (("baseline", b), ("resume", r)):
        res[f"{key}_saves"] = rep["saves"]
        res[f"{key}_checkpoint_save_seconds"] = rep["checkpoint_save_seconds"]
        res[f"{key}_checkpoint_dropped"] = rep["checkpoint_dropped"]
    res["enqueue_ms"] = [row["ms"] for row in b["saves"] if not row["wait"]]
    res["store_bytes"] = b["store_bytes"]
    say(f"  ({ {'sp': 'a', 'cs': 'c', 'cs_async': 'd'}[name] }) {name} drill: {res}")
    check(res["bit_equal"], f"{name}: the resumed run's final state differs from the baseline's")
    return res


def quorum_federation() -> dict:
    """Phase 12 (b): the 16-silo quorum federation over INMEMORY, in this
    process; see QUORUM."""
    import threading

    import torch

    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine
    from fedml_tpu_torch.core.resilience import quorum as qmod

    per_rank = {QUORUM_DEAD: dict(chaos_raise_at_round=0),
                QUORUM_STRAGGLER: dict(chaos_train_delay_s=QUORUM_DELAY_S)}
    fed = _Federation(QUORUM, "smoke_quorum", per_rank=per_rank)
    server = fed.server
    agg = server.aggregator
    health = agg.fleet.health
    p0 = _cpu(agg.get_global_model_params())
    rounds: dict = {}
    ingested: dict = {}
    folds: dict = {}
    add, aggregate, begin = agg.add_local_trained_result, agg.aggregate, server._begin_quorum_round

    def record_begin():
        report = health.report()
        begin()
        q, timer = server._round_quorum, server._deadline_timer
        rounds[int(server.args.round_idx)] = {
            "sampled": len(server.client_id_list_in_this_round),
            "stragglers_before": list(report.stragglers) if report else [],
            "deadline_s": timer.interval if timer is not None else None,
            "keep_k": q.keep_k, "min_quorum": q.policy.min_quorum(q.keep_k)}

    def record_add(index, params, n):
        add(index, params, n)
        ingested.setdefault(int(server.args.round_idx), {})[index] = (
            n, {k: v.detach().clone() for k, v in agg.model_dict[index].items()})

    def record_aggregate():
        r = int(server.args.round_idx)
        q = server._round_quorum
        counters = tel.snapshot()["counters"]
        kept = sorted(agg.model_dict)
        out = aggregate()
        folds[r] = (kept, {k: v.detach().clone() for k, v in out.items()})
        rounds[r].update(partial=q.statusz()["closed"], arrived=sorted(q.arrived()),
                         missing=q.missing(),
                         late_discarded_total=counters.get(qmod.LATE_COUNTER, 0),
                         surplus_total=counters.get(qmod.SURPLUS_COUNTER, 0))
        return out

    # host seconds of the resilience bookkeeping on the round path: merging
    # the clients' telemetry deltas (the health EWMAs), the health round's
    # MAD test, arming the deadline timer
    bookkeeping = {"merge_client_telemetry": [0, 0.0], "health.end_round": [0, 0.0],
                   "arm_deadline_timer": [0, 0.0]}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                row = bookkeeping[name]
                row[0] += 1
                row[1] += time.perf_counter() - t
        return run

    agg.merge_client_telemetry = timed("merge_client_telemetry", agg.merge_client_telemetry)
    health.end_round = timed("health.end_round", health.end_round)
    server._arm_deadline_timer = timed("arm_deadline_timer", server._arm_deadline_timer)
    server._begin_quorum_round = record_begin
    agg.add_local_trained_result, agg.aggregate = record_add, record_aggregate
    since = _last_span_seq()
    counters0 = tel.snapshot()["counters"]
    torch.cuda.synchronize()
    wall = fed.run(timeout_s=QUORUM_TIMEOUT_S, dies=(QUORUM_DEAD,))
    for t in threading.enumerate():
        if isinstance(t, threading.Timer):
            t.join(5.0)  # a cancelled timer's thread ends at once
    timers = [t for t in threading.enumerate() if isinstance(t, threading.Timer) and t.is_alive()]
    check(not timers, f"deadline timers still alive after the run: {timers}")
    round_s = [r["dur_ns"] / 1e9 for r in tel.snapshot()["spans"]
               if r["seq"] > since and r["name"] == "server.round"]
    prev = {name: counters0.get(name, 0) for name in (qmod.LATE_COUNTER, qmod.SURPLUS_COUNTER)}
    for r in sorted(rounds):
        row = rounds[r]
        # discarded while the round was open (a late delta of round r-1
        # arrives in round r), from the counters at each round's close
        for key, name in (("late_discarded", qmod.LATE_COUNTER), ("surplus", qmod.SURPLUS_COUNTER)):
            total = row.pop(f"{key}_total", prev[name])
            row[key], prev[name] = total - prev[name], total
        row["round_s"] = round_s[r] if r < len(round_s) else None
    n_rounds, k = int(QUORUM["comm_round"]), int(QUORUM["client_num_per_round"])
    check(sorted(rounds) == sorted(folds) == list(range(n_rounds)),
          f"rounds begun {sorted(rounds)}, folded {sorted(folds)}")
    state = health.export_state()
    # each fold against engine.aggregate of exactly the arrivals it kept (the
    # fold is f32 matmuls, TF32 off: PyTorch's default, checked)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    bit_equal = {}
    for r, (kept, out) in folds.items():
        row = rounds[r]
        check(sorted(ingested.get(r, {})) == kept, f"round {r}: folded {kept}, ingested "
                                                   f"{sorted(ingested.get(r, {}))}")
        # the folded set is the quorum's own accepted list (silo rank - 1)
        check(kept == [a - 1 for a in row["arrived"]],
              f"round {r}: folded {kept}, the quorum accepted ranks {row['arrived']}")
        ref = get_engine().aggregate([ingested[r][i] for i in kept])
        bit_equal[r] = all(torch.equal(ref[key], out[key]) for key in out)
        row["kept"] = len(kept)
        row["fold_bit_equal"] = bit_equal[r]
        row["closed_as"] = "partial" if row["partial"] else "complete"
    w = _cpu(agg.get_global_model_params())
    res = {"config": {key: QUORUM[key] for key in ("client_num_connected", "client_num_per_round",
                                                   "comm_round", "quorum_frac", "round_deadline_s",
                                                   "adaptive_deadline", "overprovision_frac")},
           "dead_rank": QUORUM_DEAD, "straggler": QUORUM_STRAGGLER,
           "straggler_delay_s": QUORUM_DELAY_S, "run_wall_s": wall,
           "rounds": {str(r): rounds[r] for r in sorted(rounds)},
           "health": {str(r): state.get(str(r)) for r in (QUORUM_DEAD, QUORUM_STRAGGLER)},
           "bookkeeping": {name: {"calls": n, "total_ms": 1e3 * sec,
                                  "ms_per_call": 1e3 * sec / max(1, n)}
                           for name, (n, sec) in bookkeeping.items()},
           "died": sorted(fed.errors)}
    say(f"  (b) quorum federation, 16 silos: {res}")
    for r in range(n_rounds):
        row = rounds[r]
        check((not row["partial"] and row["kept"] == row["keep_k"] == k)
              or (row["partial"] and row["kept"] >= row["min_quorum"]),
              f"round {r} closed with {row['kept']} of {row['keep_k']} (partial {row['partial']})")
        check(bit_equal[r], f"round {r}: the fold differs from engine.aggregate of its arrivals")
        if r >= 1:
            want = 15 if row["stragglers_before"] else k
            check(row["sampled"] == want, f"round {r} sampled {row['sampled']} after stragglers "
                                          f"{row['stragglers_before']}, wanted {want}")
    check(any(rounds[r]["sampled"] > k for r in range(1, n_rounds)),
          "no round was over-provisioned")
    check((state.get(str(QUORUM_STRAGGLER)) or {}).get("straggler_rounds", 0) >= 1,
          f"health never flagged the straggler: {state.get(str(QUORUM_STRAGGLER))}")
    check((state.get(str(QUORUM_DEAD)) or {}).get("total_failures", 0) >= 1,
          f"health never marked the dead rank failed: {state.get(str(QUORUM_DEAD))}")
    check(all(torch.isfinite(v).all() for v in w.values())
          and max(float((w[key] - p0[key]).abs().max()) for key in w) > 0,
          "the quorum federation's w_global is not finite or did not move")
    return res


def resilience_phase() -> dict:
    """Phase 12: (b) the quorum federation in this process, then the SIGKILL
    drills in processes of their own, the sp (a), cross-silo (c) and async
    (d) drills side by side (each its baseline and crash side by side, then
    its resume; only their bit-equality is gated, and their times are taken
    beside each other)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = os.path.join(ROOT, ".smoke_run", "resilience")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    out = {"quorum": quorum_federation()}
    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(resilience_drill, name, tmp)
                   for name in ("sp", "cs", "cs_async")}
        for name, fut in futures.items():
            out[f"drill_{name}"] = fut.result()
    out["drill_wall_s"] = {"sp_cs_and_cs_async_side_by_side": time.time() - t0}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 13: privacy: windowed async SecAgg and accounted DP at the fold ------

# phase 13: the 16 silos as an async federation whose publish window is the
# whole cohort: a publish every 16 merges at staleness exponent 0 (a masked
# window folds at unit weight), 2 publishes; the no-privacy run of it is the
# yardstick of every async case
PRIV_ASYNC = dict(SILOS_R20, async_rounds=True, async_publish_k=16,
                  async_staleness_exponent=0.0, comm_round=2)
# (a) windowed SecAgg: the default grid (secagg_qbits 13, clip 3.0), a
# reveal threshold of 8, one window a publish
PRIV_SECAGG = dict(PRIV_ASYNC, privacy="secagg", secagg_threshold=8)
# (b) the dropout drill: silo 16 drops its masked upload of round 0 after key
# exchange; one window, closed partial after a 6 s deadline and the reveals
# (the other 15 arrive in about 3 s, as the first publish of the plain run)
PRIV_DROP_RANK = 16
PRIV_DROP = dict(PRIV_SECAGG, comm_round=1, secagg_window_deadline_s=6.0)
# (c) accounted DP (noise multiplier 0.8, clip 1.0, delta 1e-5, seed 0, the
# defaults): phase 10's synchronous federation (2 rounds), the async one, and
# secagg+dp over 2 windows
PRIV_DP_SYNC = dict(SILOS_R20, privacy="dp", comm_round=2)
PRIV_DP_ASYNC = dict(PRIV_ASYNC, privacy="dp")
PRIV_BOTH = dict(PRIV_SECAGG, privacy="secagg+dp", comm_round=2)
# (d) the masked uplink on the window's shared rand-k support, topk at 0.05
PRIV_TOPK = dict(PRIV_SECAGG, comm_round=2, comm_compressor="topk", comm_compressor_ratio=0.05)
PRIV_TIMEOUT_S = 300
# the DP draws (published less clean, 272,474 of them a release): std within
# 2% of the fold's sigma (a 1/sqrt(2d) = 0.14% standard error), mean within
# 4 sigma/sqrt(d) of 0
DP_STD_RTOL = 0.02


class _PrivacyProbe:
    """Records one federation's privacy traffic while it runs: each
    member's vector before masking and its masked vector, with the host ms
    of the masking (``WindowMember.mask``, patched class-wide for the run);
    every model upload that leaves a client; each window's announce and its
    last share relay; the card's ring sum, the publish and the unmask ms of
    each window; each DP release's draws (published less the clean vector
    the fold computed on the card, before the noise) and its ms on the card;
    and the time of each publish."""

    def __init__(self, fed):
        import threading

        import numpy as np
        import torch

        from fedml_tpu_torch.core.privacy import is_masked_payload
        from fedml_tpu_torch.core.privacy import secagg_window as twin
        from fedml_tpu_torch.cross_silo.message_define import MyMessage
        from fedml_tpu_torch.models.convert import wire_vector

        self.lock = threading.Lock()
        self.masks, self.mask_ms, self.uploads = {}, [], []
        self.announce, self.last_relay = {}, {}
        self.publishes, self.noise, self.stamps = [], [], []
        self.supports = {}  # window -> (nonce, the shared support), when one is drawn
        self.publish_weights = []
        server, agg = fed.server, fed.server.aggregator
        co, dp, buf = agg.secagg_coordinator, agg.dp_fold, agg.async_buffer
        self._mask_cls, self._mask_orig = twin.WindowMember, twin.WindowMember.mask
        probe = self

        def mask(member, vec):
            t = time.perf_counter()
            out = probe._mask_orig(member, vec)
            dt = time.perf_counter() - t
            with probe.lock:
                probe.mask_ms.append(1e3 * dt)
                probe.masks.setdefault(member.window_id, {})[member.rank] = (
                    np.array(vec, np.float32), out.copy())
            return out

        twin.WindowMember.mask = mask
        for rank, runner in fed.runners.items():
            if rank == 0:
                continue
            cm = runner.runner.client_manager

            def sent(message, _send=cm.send_message, _rank=rank):
                if message.get_type() == MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER:
                    p = message.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
                    masked = is_masked_payload(p)
                    nbytes = p["masked"].nbytes if masked else \
                        sum(v.numel() * v.element_size() for v in p.values())
                    with probe.lock:
                        probe.uploads.append((_rank, masked, nbytes))
                _send(message)
            cm.send_message = sent
        if co is not None:
            def open_window(cohort=None, _f=server._secagg_open_window):
                t = time.perf_counter()
                _f(cohort)
                if co.window is not None:
                    probe.announce[co.window.window_id] = t
                    if co.support is not None:
                        probe.supports[co.window.window_id] = (co.window.nonce, co.support.copy())

            def shares(msg, _f=server.handle_message_secagg_shares):
                _f(msg)
                wid = int(msg.get(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID))
                probe.last_relay[wid] = time.perf_counter()

            def on_publish(acc, weight_sum, merges, template, engine, _f=co.on_publish):
                window = co.window
                torch.cuda.synchronize()
                ring_sum = acc.detach().cpu().numpy().astype(np.float64)
                t = time.perf_counter()
                out = _f(acc, weight_sum, merges, template, engine)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                probe.publishes.append({
                    "window": window.window_id, "arrived": sorted(window.arrived),
                    "missing": window.missing(), "recovered": window.recovered,
                    "ring_sum": ring_sum, "out": wire_vector(out).cpu().numpy(),
                    # secagg+dp: the unmasked mean before its noise
                    "clean": probe.__dict__.pop("clean", None), "unmask_ms": ms})
                return out
            server._secagg_open_window = open_window
            server.handle_message_secagg_shares = shares
            self.unmask = co.on_publish
            co.on_publish = on_publish
        if dp is not None:
            def noise(flat, s, sigma, _f=dp._noise_):
                clean = flat.detach().clone()
                if s != 1.0:
                    clean.mul_(float(np.float32(s)))
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _f(flat, s, sigma)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                draws = out.double() - clean.double()
                probe.clean = clean.cpu().numpy()
                probe.noise.append({"sigma": float(np.float32(sigma)), "d": draws.numel(),
                                    "std": float(draws.std()), "mean": float(draws.mean()),
                                    "noise_ms": ms, "steps": dp.accountant.steps,
                                    "epsilon": dp.accountant.epsilon_spent})
                return out
            dp._noise_ = noise
        target = buf if buf is not None else agg
        name = "publish" if buf is not None else "aggregate"
        orig = getattr(target, name)

        def stamped(*a, _f=orig):
            out = _f(*a)
            torch.cuda.synchronize()
            probe.stamps.append(time.perf_counter())
            if buf is not None:
                probe.publish_weights.append(buf.last_publish_weight)
            return out
        setattr(target, name, stamped)

    def close(self) -> None:
        self._mask_cls.mask = self._mask_orig


def _priv_run(over: dict, run_id: str, per_rank=None) -> tuple:
    """Build and run one federation of phase 13 under a probe; the run
    must end within PRIV_TIMEOUT_S and leave no timer thread alive."""
    import threading

    import numpy as np
    import torch

    from fedml_tpu_torch.core import telemetry as tel

    fed = _Federation(over, run_id, per_rank=per_rank)
    evals = _evals_of(fed)
    probe = _PrivacyProbe(fed)
    counters0 = dict(tel.snapshot()["counters"])
    since = _last_span_seq()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        wall = fed.run(timeout_s=PRIV_TIMEOUT_S)
    finally:
        probe.close()
    for t in threading.enumerate():
        if isinstance(t, threading.Timer):
            t.join(5.0)  # a cancelled timer's thread ends at once
    timers = [t for t in threading.enumerate() if isinstance(t, threading.Timer) and t.is_alive()]
    check(not timers, f"{run_id}: timers still alive after the run: {timers}")
    counters = tel.snapshot()["counters"]
    probe.counters = {k: counters.get(k, 0) - counters0.get(k, 0) for k in counters
                      if k.startswith(("secagg.", "dp.", "quorum.partial"))}
    probe.spans = _span_totals(since, ("client.secagg_mask", "secagg.submit", "secagg.unmask",
                                       "async.publish", "server.async_receive", "client.train"))
    probe.gaps = [b - a for a, b in zip([t0] + probe.stamps[:-1], probe.stamps)]
    probe.wall, probe.since = wall, since
    probe.d = sum(v.numel() for v in fed.server.aggregator.get_global_model_params().values())
    check(evals and all(np.isfinite(m["test_loss"]) for m in evals), f"{run_id}: evals {evals}")
    w = fed.server.aggregator.get_global_model_params()
    check(all(v.device.type == DEV and bool(torch.isfinite(v).all()) for v in w.values()),
          f"{run_id}: the global params are off the card or not finite")
    return fed, probe, evals


def _window_reference(probe, pub: dict, spec, support=None) -> dict:
    """Gates (a) for one publish, against the members' vectors captured at
    the client before masking: the publish bit-equal to the host reference,
    the card's ring sum equal to the int64 sum of the masked vectors, each
    masked vector not its quantized vector, and the publish within one step
    of the plain mean at unit weight (the fold's weight) wherever every
    arrival lies inside the clip."""
    import numpy as np

    from fedml_tpu_torch.core.privacy.masking import (center_ring, dequantize_sum,
                                                      quantize_vector)

    members = probe.masks.get(pub["window"], {})
    arrived = pub["arrived"]
    check(set(arrived) <= set(members),
          f"window {pub['window']}: arrivals {arrived}, masked at the clients {sorted(members)}")
    vecs = [members[r][0] for r in arrived]
    qsum = sum(quantize_vector(v, spec) for v in vecs)
    ref = dequantize_sum(center_ring(np.mod(qsum, spec.ring), spec), len(vecs), spec)
    out = pub["out"] if pub["clean"] is None else pub["clean"]
    got = out if support is None else out[support]
    if support is not None:
        off = np.ones(pub["out"].size, bool)
        off[support] = False
        check(not pub["out"][off].any(), f"window {pub['window']}: nonzero off the support")
    check(np.array_equal(got, ref), f"window {pub['window']}: the publish differs from the "
                                    "host reference of its members' quantized vectors")
    int_sum = sum(members[r][1].astype(np.int64) for r in arrived)
    check(np.array_equal(pub["ring_sum"], int_sum.astype(np.float64)),
          f"window {pub['window']}: the card's ring sum differs from the int64 sum")
    check(np.array_equal(np.mod(pub["ring_sum"].astype(np.int64), spec.ring),
                         np.mod(int_sum, spec.ring)), "ring sums differ mod 2^b")
    for r in arrived:
        vec, masked = members[r]
        check(not np.array_equal(masked, np.mod(quantize_vector(vec, spec), spec.ring)),
              f"window {pub['window']}: rank {r}'s masked vector is its quantized vector")
    stack = np.stack(vecs)
    inside = np.all(np.abs(stack) <= spec.clip, axis=0)
    plain = stack.astype(np.float64).mean(axis=0).astype(np.float32)
    gap = float(np.abs(got.astype(np.float64) - plain)[inside].max())
    check(gap <= spec.step, f"window {pub['window']}: {gap} from the plain mean, step {spec.step}")
    return {"window": pub["window"], "members": len(arrived), "bit_equal": True,
            "ring_sum_exact": True, "max_from_plain": gap, "step": spec.step,
            "coords_inside_clip": int(inside.sum()), "unmask_ms": pub["unmask_ms"]}


def _secagg_case(probe, fed, n_windows: int) -> dict:
    """The gates of a windowed case: every upload masked, every window
    published and held to its reference; and its costs."""
    import numpy as np

    co = fed.server.aggregator.secagg_coordinator
    check(probe.uploads and all(m for _, m, _ in probe.uploads),
          f"an upload crossed the boundary unmasked: {[u for u in probe.uploads if not u[1]][:3]}")
    check(len(probe.publishes) == n_windows, f"{len(probe.publishes)} windows published, "
                                             f"expected {n_windows}")
    windows = [_window_reference(probe, pub, co.spec,
                                 support=probe.supports[pub["window"]][1]
                                 if pub["window"] in probe.supports else None)
               for pub in probe.publishes]
    keyx = [probe.last_relay[w] - probe.announce[w] for w in sorted(probe.announce)
            if w in probe.last_relay]
    spans = probe.spans
    return {
        "windows": windows, "spec": co.spec.as_dict(), "threshold": co.threshold,
        "upload_bytes": sorted({b for _, _, b in probe.uploads}), "uploads": len(probe.uploads),
        "key_exchange_s": keyx,
        "mask_host_ms_mean": float(np.mean(probe.mask_ms)), "mask_host_ms_max":
            float(np.max(probe.mask_ms)), "masks": len(probe.mask_ms),
        "client_secagg_mask_ms_mean": 1e3 * spans["client.secagg_mask"]["s"]
        / max(1, spans["client.secagg_mask"]["count"]),
        "submit_ms_mean": 1e3 * spans["secagg.submit"]["s"] / max(1, spans["secagg.submit"]["count"]),
        "unmask_ms_in_run": [w["unmask_ms"] for w in windows],
        "s_per_window": probe.gaps, "run_wall_s": probe.wall, "counters": probe.counters}


def _dp_case(probe, fed, ns: list) -> dict:
    """The gates of a DP case: each release's sigma z·C/n for the ``n`` its
    fold normalizes by (``ns``, a release each), its draws against that
    sigma, and epsilon against a fresh accountant stepped as often."""
    import numpy as np

    from fedml_tpu_torch.core.privacy import DPAccountant

    dp = fed.server.aggregator.dp_fold
    releases = len(ns)
    check(len(probe.noise) == releases == dp.accountant.steps,
          f"{len(probe.noise)} noised releases, accountant at {dp.accountant.steps}, "
          f"expected {releases}")
    for row, n in zip(probe.noise, ns):
        want = float(np.float32(dp.noise_multiplier * dp.l2_clip / max(1.0, float(n))))
        check(row["sigma"] == want, f"a release's sigma {row['sigma']}, z*C/n = {want} (n {n})")
        check(row["d"] == probe.d, f"a release noised {row['d']} of {probe.d} coordinates")
        check(abs(row["std"] - row["sigma"]) <= DP_STD_RTOL * row["sigma"],
              f"DP draws' std {row['std']} against sigma {row['sigma']}")
        check(abs(row["mean"]) <= 4 * row["sigma"] / np.sqrt(row["d"]),
              f"DP draws' mean {row['mean']} (sigma {row['sigma']}, d {row['d']})")
    acc = dp.accountant
    fresh = DPAccountant(noise_multiplier=acc.noise_multiplier, delta=acc.delta,
                         epsilon_budget=acc.epsilon_budget, sample_rate=acc.sample_rate)
    for _ in range(releases):
        fresh.step()
    check(abs(acc.epsilon_spent - fresh.epsilon_spent) <= 1e-12,
          f"epsilon {acc.epsilon_spent} after {releases} releases, a fresh accountant "
          f"{fresh.epsilon_spent}")
    return {"releases": probe.noise, "epsilon": acc.epsilon_spent,
            "epsilon_fresh_accountant": fresh.epsilon_spent,
            "noise_ms_mean": float(np.mean([r["noise_ms"] for r in probe.noise])),
            "counters": probe.counters}


def _alone(fed, probe, template) -> dict:
    """Phase 13's host and card costs taken one at a time after a run, the
    card otherwise idle (in a run, 16 client threads queue their training on
    the card's one default stream, and every synchronising copy waits for
    it): a member's masking of ResNet-20 (numpy), a client's wire flatten
    and copy to the host, the fold of a bucket of 16 masked arrivals, the
    unmask of the last window's ring sum (copy down, f64 ring math, copy up,
    unflatten), one DP release's noise, and the server's clip of an arrival
    against the global."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine
    from fedml_tpu_torch.core.privacy import DPFold, WindowCoordinator, clip_to_reference
    from fedml_tpu_torch.models.convert import wire_vector

    co = fed.server.aggregator.secagg_coordinator
    n = int(PRIV_SECAGG["client_num_per_round"])
    vec = wire_vector(template).cpu().numpy()
    scratch = WindowCoordinator(AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0)),
                                template, spec=co.spec, threshold=co.threshold,
                                rng=np.random.default_rng(0))
    _, members = scratch.open_window(range(1, n + 1))
    t = time.perf_counter()
    for _ in range(3):
        members[1].mask(vec)
    mask_ms = (time.perf_counter() - t) / 3 * 1e3
    pub = probe.publishes[-1]
    last = probe.masks[pub["window"]]
    chunk = [{"masked": torch.from_numpy(last[r][1]).to(DEV)} for r in sorted(last)[:n]]
    ones = np.ones(len(chunk), np.float32)
    engine = get_engine()
    bucket_ms = _time_ms(lambda: engine.accumulate_bucket(None, chunk, ones), 20)
    acc = torch.from_numpy(pub["ring_sum"].astype(np.float32)).to(DEV)
    window, co.window = co.window, None  # no window: no bookkeeping, n from merges
    try:
        unmask_ms = _time_ms(lambda: probe.unmask(acc, float(n), n, None, None), 10)
    finally:
        co.window = window
    flat = torch.from_numpy(vec).to(DEV)
    fold = DPFold(seed=0)
    noise_ms = _time_ms(lambda: fold._noise_(flat, 1.0, 0.05), 20)
    moved = {k: v + 0.01 for k, v in template.items()}
    clip_ms = _time_ms(lambda: clip_to_reference(moved, template, 1.0), 20)
    return {"mask_host_ms": mask_ms,
            "flatten_to_host_ms": _time_ms(lambda: wire_vector(template).cpu(), 20),
            "fold_bucket_ms": bucket_ms, "fold_ms_per_arrival": bucket_ms / len(chunk),
            "unmask_ms": unmask_ms, "dp_noise_ms": noise_ms, "dp_clip_ms": clip_ms}


def _mean_after_first(gaps) -> float:
    return sum(gaps[1:]) / (len(gaps) - 1) if len(gaps) > 1 else gaps[0]


def privacy_phase() -> dict:
    """Phase 13: the no-privacy async yardstick, (a) windowed SecAgg, (b) the
    dropout drill, (c) DP sync, async and composed with SecAgg, (d) the
    masked uplink on a topk support ((e), no flash launch, is main's)."""
    import numpy as np
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    res = {}
    fed, probe, evals = _priv_run(PRIV_ASYNC, "smoke_priv_plain")
    check(len(probe.stamps) == PRIV_ASYNC["comm_round"], f"plain: {len(probe.stamps)} publishes")
    res["plain_async"] = {"s_per_publish": probe.gaps, "run_wall_s": probe.wall,
                          "upload_bytes": sorted({b for _, _, b in probe.uploads}),
                          "test_loss": [m["test_loss"] for m in evals]}
    del fed
    say(f"  no privacy, 16 async silos, {PRIV_ASYNC['comm_round']} publishes of 16: "
        f"{res['plain_async']}")

    fed, probe, evals = _priv_run(PRIV_SECAGG, "smoke_priv_secagg")
    case = _secagg_case(probe, fed, PRIV_SECAGG["comm_round"])
    case["test_loss"] = [m["test_loss"] for m in evals]
    check(case["upload_bytes"] == [probe.d * 4], f"masked upload bytes {case['upload_bytes']}")
    res["secagg"] = case
    res["alone"] = _alone(fed, probe, fed.server.aggregator.get_global_model_params())
    del fed
    say(f"  (a) windowed SecAgg, 16 silos x {PRIV_SECAGG['comm_round']} windows: {case}")

    fed, probe, evals = _priv_run(PRIV_DROP, "smoke_priv_drop",
                                  per_rank={PRIV_DROP_RANK: dict(
                                      chaos_secagg_drop_upload_at_round=0)})
    case = _secagg_case(probe, fed, 1)
    pub = probe.publishes[0]
    check(pub["missing"] == [PRIV_DROP_RANK] and pub["recovered"] and len(pub["arrived"]) == 15,
          f"the drill's window: arrived {pub['arrived']}, missing {pub['missing']}, "
          f"recovered {pub['recovered']}")
    check(probe.counters.get("secagg.dropouts") == 1 and probe.counters.get("secagg.recovered") == 1
          and probe.counters.get("quorum.partial") == 1, f"drill counters {probe.counters}")
    check(fed.server._secagg_deadline_timer is None, "the window's deadline timer is still set")
    co = fed.server.aggregator.secagg_coordinator
    t = time.perf_counter()
    co.window.correction(co.d)  # the stray-mask correction alone: Shamir and 15 PRG draws
    case["correction_ms_alone"] = (time.perf_counter() - t) * 1e3
    case["test_loss"] = [m["test_loss"] for m in evals]
    res["dropout"] = case
    del fed
    say(f"  (b) dropout drill, silo {PRIV_DROP_RANK} drops after key exchange: {case}")

    fed, probe, evals = _priv_run(PRIV_DP_SYNC, "smoke_priv_dp_sync")
    k = int(PRIV_DP_SYNC["client_num_per_round"])
    case = _dp_case(probe, fed, [k] * int(PRIV_DP_SYNC["comm_round"]))
    rows = _cs_round_split(probe.since)
    case.update(round_s=[r["round_s"] for r in rows],
                round_s_mean_after_first=float(np.mean([r["round_s"] for r in rows[1:]])),
                test_loss=[m["test_loss"] for m in evals])
    res["dp_sync"] = case
    del fed
    say(f"  (c) DP, the synchronous 16-silo federation x {PRIV_DP_SYNC['comm_round']} rounds: "
        f"{case}")

    fed, probe, evals = _priv_run(PRIV_DP_ASYNC, "smoke_priv_dp_async")
    # dp alone: the fold normalizes by the window's weight sum (sample
    # counts), and the JAX package calibrates sigma to it
    case = _dp_case(probe, fed, probe.publish_weights)
    case.update(s_per_publish=probe.gaps, test_loss=[m["test_loss"] for m in evals],
                weight_sum=fed.server.aggregator.async_buffer.last_publish_weight)
    res["dp_async"] = case
    del fed
    say(f"  (c) DP, 16 async silos x {PRIV_DP_ASYNC['comm_round']} publishes: {case}")

    fed, probe, evals = _priv_run(PRIV_BOTH, "smoke_priv_both")
    case = _secagg_case(probe, fed, PRIV_BOTH["comm_round"])
    case["dp"] = _dp_case(probe, fed, [len(p["arrived"]) for p in probe.publishes])
    case["test_loss"] = [m["test_loss"] for m in evals]
    res["secagg_dp"] = case
    del fed
    say(f"  (c) secagg+dp, 16 silos x 2 windows: {case}")

    fed, probe, evals = _priv_run(PRIV_TOPK, "smoke_priv_topk")
    from fedml_tpu_torch.utils.compression import secagg_support

    # each window's support: ceil(0.05 d) coordinates (13,624 of ResNet-20's
    # 272,474), drawn from its nonce
    ratio = PRIV_TOPK["comm_compressor_ratio"]
    k = int(np.ceil(probe.d * ratio))
    for w, (nonce, support) in probe.supports.items():
        check(support.size == k and np.array_equal(support, secagg_support(nonce, probe.d, ratio)),
              f"window {w}: a support of {support.size}, not the {k} its nonce draws")
    check(len(probe.supports) == PRIV_TOPK["comm_round"], f"supports {sorted(probe.supports)}")
    case = _secagg_case(probe, fed, PRIV_TOPK["comm_round"])
    check(case["upload_bytes"] == [k * 4], f"masked topk upload bytes {case['upload_bytes']}")
    case.update(support_k=k, d=probe.d)
    case["test_loss"] = [m["test_loss"] for m in evals]
    res["secagg_topk"] = case
    del fed
    say(f"  (d) secagg on a topk 0.05 support, 16 silos x 2 windows: {case}")
    base = _mean_after_first(res["plain_async"]["s_per_publish"])
    res["cost_of_privacy"] = {
        "no_privacy_s_per_publish": base,
        **{f"{name}_{key}": _mean_after_first(res[name][key])
           for name, key in (("secagg", "s_per_window"), ("secagg_dp", "s_per_window"),
                             ("secagg_topk", "s_per_window"), ("dp_async", "s_per_publish"))},
        "dp_sync_round_s": res["dp_sync"]["round_s_mean_after_first"]}
    say(f"  cost of privacy (seconds a publish or round after the first): {res['cost_of_privacy']}")
    say(f"  costs alone, the card otherwise idle: {res['alone']}")
    return res


# -- phase 14: the round-barrier secure-aggregation fronts ----------------------

# phase 10's 16 silos at ResNet-20 (SILOS_R20) over INMEMORY through
# FedMLRunner by role, 2 rounds, secure_aggregation secagg (threshold 8, the default client_num // 2)
# and lightsecagg (U 16, T 8, the defaults); quantize_bits 16, p = 2^31 - 1
SECURE = dict(SILOS_R20, comm_round=2, quantize_bits=16, mpc_prime=2**31 - 1)
SECURE_FRONTS = {"secagg": dict(SECURE, secure_aggregation="secagg"),
                 "lightsecagg": dict(SECURE, secure_aggregation="lightsecagg")}
SECURE_TIMEOUT_S = 300
# the spans of a front, by step (host seconds; the card is waited for where a
# step ends in a copy to the host)
SECURE_SPANS = {"secagg": {"local_round": "client.train", "quantize": "sa.quantize",
                           "masking": "sa.mask", "server_sum": "sa.server_sum",
                           "unmask": "sa.unmask", "dequantize": "sa.dequantize"},
                "lightsecagg": {"local_round": "client.train", "quantize": "lsa.quantize",
                                "encode": "lsa.encode", "masking": "lsa.mask",
                                "server_sum": "lsa.server_sum", "decode": "lsa.decode",
                                "dequantize": "lsa.dequantize"}}


class _SecureProbe:
    """Records one secure federation while it runs: each client's quantized
    upload before masking (a reference, not a copy: nothing writes it) and,
    in round 0, its trained weights as a float32 wire vector; the bytes of
    every array a client sends, by message type; the server's handler times
    (keys in, shares routed, masked uploads, reconstruction) and each
    round's new global as it is installed."""

    def __init__(self, fed, front: str):
        import threading

        import torch

        from fedml_tpu_torch.models.convert import wire_vector

        self.lock = threading.Lock()
        self.uploads, self.trained, self.sent = {}, {}, {}
        self.events, self.globals = [], []
        probe = self
        for rank, runner in fed.runners.items():
            if rank == 0:
                continue
            cm = runner.runner.client_manager

            def quantize(weights, _q=cm.quantize, _cm=cm, _rank=rank):
                rnd = int(_cm.args.round_idx)
                if rnd == 0:
                    probe.trained[_rank] = wire_vector(weights, torch.float32).cpu().numpy()
                out = _q(weights)
                with probe.lock:
                    probe.uploads.setdefault(rnd, {})[_rank] = out
                return out

            def send(message, _send=cm.send_message, _cm=cm):
                nbytes = sum(_nbytes(v) for v in message.get_params().values())
                key = (message.get_type(), int(_cm.args.round_idx))
                with probe.lock:
                    probe.sent[key] = probe.sent.get(key, 0) + nbytes
                _send(message)
            cm.quantize, cm.send_message = quantize, send
        server = fed.server
        names = (("handle_message_pk", "handle_message_route_share", "handle_message_masked_model",
                  "handle_message_reveal") if front == "secagg" else
                 ("handle_message_route_encoded_mask", "handle_message_receive_model",
                  "handle_message_receive_aggregate_mask"))
        for name in names:
            def timed(msg, _f=getattr(server, name), _name=name):
                _f(msg)
                probe.events.append((_name, int(server.args.round_idx), time.perf_counter()))
            setattr(server, name, timed)
        agg = server.aggregator
        reconstruct = agg.aggregate_model_reconstruction

        def installed():
            out = reconstruct()
            torch.cuda.synchronize()
            probe.globals.append((time.perf_counter(), wire_vector(out).cpu().numpy(),
                                  {v.device.type for v in out.values()}))
            return out
        agg.aggregate_model_reconstruction = installed


def _nbytes(value) -> int:
    """Bytes of the arrays in a message parameter (a reveal is a dict of
    dicts of shares)."""
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    return 0


def _plain_quantized_mean(uploads: list, q_bits: int, p: int):
    """The reference a round's global is held to: the int64 sum mod p of the
    uploads, centred, float64 over 2^q, float32, over n in float32 (the JAX
    fronts' order, on the host)."""
    import numpy as np

    total = np.zeros_like(uploads[0])
    for u in uploads:
        total = (total + u) % p
    centred = np.where(total > (p - 1) // 2, total - p, total)
    return (centred.astype(np.float64) / 2 ** q_bits).astype(np.float32) / np.float32(len(uploads))


def _secure_alone(front: str, fed, template) -> dict:
    """A front's costs one at a time after its run, the card otherwise idle
    and waited for: quantizing a ResNet-20 state dict on the card and its
    copy to the host; a client's masking (SecAgg: its self mask and 15
    pairwise masks; LightSecAgg: one add) and, for LightSecAgg, its mask's
    encoding (host draws, the (16x16)·(16x106,972) product on the card, the
    shares back) and the product alone, the sum of 16 received shares, and
    the server's decode of 16 aggregates on the card; the server's sum of 16
    masked uploads (each copied up); SecAgg's unmask of the last round
    (Shamir and 16 mask draws on the host, each stripped on the card); the
    dequantized mean installed as a state dict."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.mpc import lightsecagg as lsa
    from fedml_tpu_torch.core.mpc.finite_field import dequantize_mean, lcc_encode
    from fedml_tpu_torch.core.mpc.secagg import SecAggClient
    from fedml_tpu_torch.models.convert import state_from_wire_vector

    agg = fed.server.aggregator
    cm = fed.runners[1].runner.client_manager
    p, n = agg.cfg.prime, agg.client_num
    rng = np.random.default_rng(0)
    quantize = type(cm).quantize  # the manager's own, not the probe's
    x = quantize(cm, template)
    d = x.size
    out = {"quantize_to_host_ms": _time_ms(lambda: quantize(cm, template), 10)}
    ys = [rng.integers(0, p, size=d, dtype=np.int64) for _ in range(n)]

    def server_sum():
        acc = None
        for y in ys:
            y = torch.from_numpy(y).to(DEV)
            acc = y % p if acc is None else (acc + y) % p
        return acc
    out["server_sum_16_ms"] = _time_ms(server_sum, 5)
    x_sum = server_sum()
    out["dequantize_install_ms"] = _time_ms(
        lambda: state_from_wire_vector(dequantize_mean(x_sum, n, agg.q_bits, p), template), 10)
    if front == "secagg":
        client = SecAggClient(0, agg.cfg, np.random.default_rng(1))
        client.advertise_keys()
        client.peer_public = {j: int(rng.integers(2, p - 1)) for j in range(n)}
        t = time.perf_counter()
        for _ in range(3):
            client.masked_input(x)
        out["mask_host_ms"] = (time.perf_counter() - t) / 3 * 1e3
        out["unmask_ms"] = _time_ms(lambda: agg.server.strip_masks(agg.masked_sum, agg.reveals), 3)
        return out
    cfg = agg.cfg
    t = time.perf_counter()
    for _ in range(3):
        state = lsa.encode_mask(cfg, d, rng, device=DEV)
    out["encode_ms"] = (time.perf_counter() - t) / 3 * 1e3
    chunk = state.encoded_shares.shape[1]
    payload = torch.from_numpy(rng.integers(0, p, size=(cfg.target_active, chunk),
                                            dtype=np.int64)).to(DEV)
    out["encode_product_on_card_ms"] = _time_ms(lambda: lcc_encode(payload, cfg.beta, cfg.alpha, p), 10)
    t = time.perf_counter()
    for _ in range(3):
        lsa.mask_vector(cfg, x, state)
    out["mask_host_ms"] = (time.perf_counter() - t) / 3 * 1e3
    lsa.exchange_shares({i: state for i in range(n)})
    t = time.perf_counter()
    for _ in range(3):
        lsa.aggregate_encoded_mask(cfg, state, list(range(n)))
    out["share_sum_host_ms"] = (time.perf_counter() - t) / 3 * 1e3
    aggs = {i: torch.from_numpy(state.encoded_shares[i]).to(DEV) for i in range(n)}
    out["decode_ms"] = _time_ms(lambda: lsa.decode_aggregate_mask(cfg, aggs, d), 10)
    return out


def _secure_run(front: str) -> dict:
    """Phase 14 for one front: 16 ResNet-20 silos x 2 rounds under a probe,
    then the gates, the figures and the costs alone."""
    import numpy as np
    import torch

    from fedml_tpu_torch.cross_silo.lightsecagg.lsa_fedml_server_manager import \
        LightSecAggServerManager
    from fedml_tpu_torch.cross_silo.secagg.sa_fedml_server_manager import SecAggServerManager

    over = SECURE_FRONTS[front]
    fed = _Federation(over, f"smoke_secure_{front}")
    want_cls = SecAggServerManager if front == "secagg" else LightSecAggServerManager
    check(isinstance(fed.server, want_cls), f"{front}: the server is a {type(fed.server).__name__}")
    evals = _evals_of(fed)
    probe = _SecureProbe(fed, front)
    since = _last_span_seq()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wall = fed.run(timeout_s=SECURE_TIMEOUT_S)
    rounds, n = int(over["comm_round"]), int(over["client_num_per_round"])
    q_bits, p = int(over["quantize_bits"]), int(over["mpc_prime"])
    check(sorted(probe.uploads) == list(range(rounds)) and len(probe.globals) == rounds and
          all(sorted(u) == list(range(1, n + 1)) for u in probe.uploads.values()),
          f"{front}: uploads {[(r, sorted(u)) for r, u in probe.uploads.items()]}, "
          f"{len(probe.globals)} globals")
    check(all(devs == {DEV} for _, _, devs in probe.globals), f"{front}: a global left the card")
    agg = fed.server.aggregator
    check(torch.device(agg.device).type == DEV, f"{front}: the aggregator runs on {agg.device}")
    # each round's global bit-equal to the plain quantized mean of its uploads
    bit_equal = []
    for rnd in range(rounds):
        ref = _plain_quantized_mean([probe.uploads[rnd][r] for r in range(1, n + 1)], q_bits, p)
        bit_equal.append(bool(np.array_equal(probe.globals[rnd][1], ref)))
    check(all(bit_equal), f"{front}: rounds bit-equal to the plain quantized mean: {bit_equal}")
    # round 1 within one quantum of the unweighted mean of the trained weights
    mean = sum(probe.trained[r].astype(np.float64) for r in range(1, n + 1)) / n
    off = float(np.abs(probe.globals[0][1].astype(np.float64) - mean).max())
    check(off <= 2.0 ** -q_bits, f"{front}: round 1 is {off:.3g} from the float mean (> 2^-{q_bits})")
    check(all(np.isfinite(m["test_loss"]) for m in evals) and len(evals) == rounds,
          f"{front}: evals {evals}")
    stamps = [t for t, _, _ in probe.globals]
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    # the spans of round 2, the steady round: every span entered after round
    # 1's dequantization (the clients wait for the sync meanwhile)
    from fedml_tpu_torch.core import telemetry as tel

    deq = SECURE_SPANS[front]["dequantize"]
    steady = min(r["seq"] for r in tel.snapshot()["spans"] if r["seq"] > since and r["name"] == deq)
    spans = {step: _span_totals(steady, [name])[name] for step, name in SECURE_SPANS[front].items()}
    per_round = {"round_s": round_s}
    for rnd in range(rounds):
        ev = [(name, t) for name, r, t in probe.events if r == rnd]

        def at(name, last=True):
            ts = [t for nm, t in ev if nm == name]
            return (max(ts) if last else min(ts)) if ts else None
        if front == "secagg":
            per_round.setdefault("keys_in_s", []).append(at("handle_message_pk") -
                                                         at("handle_message_pk", last=False))
            per_round.setdefault("key_exchange_s", []).append(
                at("handle_message_route_share") - at("handle_message_pk"))
        else:
            per_round.setdefault("share_exchange_s", []).append(
                at("handle_message_route_encoded_mask") -
                at("handle_message_route_encoded_mask", last=False))
        per_round.setdefault("uploads_s", []).append(
            at("handle_message_masked_model" if front == "secagg" else
               "handle_message_receive_model") -
            at("handle_message_masked_model" if front == "secagg" else
               "handle_message_receive_model", last=False))
    from fedml_tpu_torch.cross_silo.lightsecagg.lsa_message_define import MyMessage as LMsg
    from fedml_tpu_torch.cross_silo.secagg.sa_message_define import MyMessage as SMsg

    def per_client(msg_type):
        return [probe.sent.get((msg_type, rnd), 0) / n for rnd in range(rounds)]
    if front == "secagg":
        nbytes = {"masked_upload": per_client(SMsg.MSG_TYPE_C2S_MASKED_MODEL),
                  "shamir_shares": per_client(SMsg.MSG_TYPE_C2S_SHARE),
                  "reveal": per_client(SMsg.MSG_TYPE_C2S_REVEAL)}
    else:
        nbytes = {"masked_upload": per_client(LMsg.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER),
                  "encoded_shares": per_client(LMsg.MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER),
                  "aggregate_mask": per_client(LMsg.MSG_TYPE_C2S_SEND_MASK_TO_SERVER)}
    d = probe.globals[0][1].size
    check(nbytes["masked_upload"] == [8.0 * d] * rounds,
          f"{front}: masked upload bytes {nbytes['masked_upload']}, expected {8 * d}")
    if front == "lightsecagg":
        cfg = fed.server.aggregator.cfg
        chunk = -(-d // (cfg.target_active - cfg.privacy_guarantee))
        check(nbytes["encoded_shares"] == [8.0 * chunk * (n - 1)] * rounds and
              nbytes["aggregate_mask"] == [8.0 * chunk * cfg.target_active / n] * rounds,
              f"{front}: share bytes {nbytes}, a chunk of {chunk}")
    res = {"config": {key: over[key] for key in ("client_num_per_round", "comm_round",
                                                  "quantize_bits", "mpc_prime",
                                                  "secure_aggregation")},
           "d": d, "round_s": round_s, "run_wall_s": wall, "spans": spans,
           "per_round": per_round, "bytes_per_client_per_round": nbytes,
           "rounds_bit_equal": bit_equal, "round1_max_abs_from_float_mean": off,
           "test_loss": [m["test_loss"] for m in evals],
           "test_acc": [m["test_acc"] for m in evals],
           "alone": _secure_alone(front, fed, agg.get_global_model_params())}
    del fed
    return res


def secure_phase() -> dict:
    """Phase 14: the SecAgg and LightSecAgg fronts ((c), no flash launch, is
    main's)."""
    res = {}
    for front, over in SECURE_FRONTS.items():
        res[front] = _secure_run(front)
        say(f"  {front}, {over['client_num_per_round']} {over['model']} silos x "
            f"{over['comm_round']} rounds: {res[front]}")
    return res


# -- phase 15: hierarchical async aggregation: the edge->regional->root tree ----

# the JAX bench's tree (bench.py's hierarchy rider): 8 edges of publish_k 8
# under regional_fanout 4, so 2 regionals and a root publish every 64 client
# merges, over the ResNet-56 state dict at phase 11's fleet sizes, generation
# batch and seed; 8 root publishes a run, exponent 0.5 (the default policy)
HIER_SIM = dict(hierarchy_edges=8, publish_k=8, publishes=8, gen_batch=ASYNC_SIM["gen_batch"],
                seed=ASYNC_SIM["seed"])
# tier-masked SecAgg over the ResNet-56 template: 4 edges x 4 members under
# regional_fanout 2 (a 16-member root window), the default QuantSpec (13
# qbits, clip 3.0, a 20-bit ring), exponent 0; R5's tree (8 x 16 under
# regional_fanout 4: 128 members, 21 bits) must be refused
HIER_MASKED = dict(n_edges=4, per_edge=4, regional_fanout=2, seed=0)
HIER_R5 = dict(n_edges=8, per_edge=16, regional_fanout=4)
# a root publish against the float64 host re-fold of its recorded arrivals
# through the same tree: phase 11's ASYNC_STREAM_TOL a tier (each tier is one
# f32 fold of at most 8 arrivals with f32-normalized weights), so 3x it
HIER_TOL = 3 * ASYNC_STREAM_TOL


# the spans of a gated run (nested: hierarchy.publish holds async.publish,
# which holds agg.aggregate and its agg.bucket; an edge's arrival is
# async.merge)
HIER_SPANS = ("async.merge", "async.publish", "hierarchy.publish", "hierarchy.version_sync",
              "agg.aggregate", "agg.bucket", "agg.pad_tail")


def _sketch_hop_ms(tree) -> float:
    """Host ms of one sketch forward (an edge's wire_view, the regional's
    merge of it into the edge's slot), the mean of 20 after the run."""
    edge, parent = tree.edges[0], tree.edges[0].parent
    rank = parent._child_ranks.get(edge.name, 0)
    t0 = time.perf_counter()
    for _ in range(20):
        parent.fleet.merge_client_delta(rank, {"sketches": edge.fleet.wire_view()})
    return (time.perf_counter() - t0) / 20 * 1e3


def _recording_tree(template: dict):
    """A HierarchyTree.build(8, publish_k=8) on the card whose node buffers
    record every merge (its effective weight and state dict, by reference)
    and every publish (its window and its output)."""
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree

    tree = HierarchyTree.build(HIER_SIM["hierarchy_edges"], publish_k=HIER_SIM["publish_k"],
                               engine=get_engine(), initial_model=template, device=DEV)
    rec = {}
    for node in tree.nodes():
        buf, log = node.buffer, {"window": [], "pubs": []}
        rec[node.name] = log

        def merge(rank, tree_, weight, staleness, _m=buf._merge_locked, _log=log):
            _log["window"].append((float(weight), tree_))
            return _m(rank, tree_, weight, staleness)

        def publish(_p=buf._publish_locked, _log=log):
            out = _p()
            if out is not None:
                _log["pubs"].append((_log["window"], out))
                _log["window"] = []
            return out

        buf._merge_locked, buf._publish_locked = merge, publish
    return tree, rec


def _hier_refold(tree, rec) -> list:
    """Each root publish's float64 host re-fold through the recorded tree:
    an edge's reference is the weighted mean of its window's client state
    dicts, a regional's and the root's the weighted mean of their children's
    references, with the weights each buffer folded (decayed, and a child's
    forwarded window weight)."""
    refs = {}
    for node in tree.edges + tree.regionals + [tree.root]:
        for window, out in rec[node.name]["pubs"]:
            acc, wsum = None, 0.0
            for w, t in window:
                x = refs.get(id(t))
                if x is None:
                    check(next(iter(t.values())).device.type == DEV,
                          f"{node.name}: an arrival off the card")
                    x = _f64_host(t)
                acc = w * x if acc is None else acc + w * x
                wsum += w
            refs[id(out)] = acc / wsum
    return [(out, refs[id(out)]) for _, out in rec["root"]["pubs"]]


def _f64_host(state: dict):
    """A state dict as one float64 host vector (one copy down)."""
    import numpy as np
    import torch

    return torch.cat([v.reshape(-1).float() for v in state.values()]).cpu().numpy() \
        .astype(np.float64)


def _of_scale_flat(out: dict, ref) -> float:
    """max over leaves of max |out - ref| / max |ref| (a flat float64 ref in
    the state dict's order)."""
    import numpy as np

    err, off = 0.0, 0
    for v in out.values():
        n = v.numel()
        got = v.reshape(-1).float().cpu().numpy().astype(np.float64)
        r = ref[off:off + n]
        err = max(err, float(np.abs(got - r).max() / max(np.abs(r).max(), 1e-30)))
        off += n
    return err


def hierarchy_fleet(template: dict, flat: dict) -> dict:
    """Phase 15 (a): simulate_async_rounds(hierarchy_edges=8) over the
    ResNet-56 state dict at 1,000 and 10,000 clients (and 1,000 again), as
    a user calls it; then the gate runs, the same event simulation over a
    recording tree with the card waited for after each submit and publish
    (phase 11 (c)'s discipline, so the server seconds compare)."""
    import torch

    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.core.distributed.hierarchy import FORWARD_COUNTER
    from fedml_tpu_torch.core.telemetry import sketches
    from fedml_tpu_torch.simulation.vmapped.async_driver import (AsyncEventSim, DelayModel,
                                                                 make_synthetic_delta_fn,
                                                                 simulate_async_rounds)

    sizes = ASYNC_SIM_CLIENTS + ASYNC_SIM_CLIENTS[:1]
    res = {"config": dict(HIER_SIM, regional_fanout=4, tol_of_scale=HIER_TOL), "entry": {},
           "gated": {}}
    for n in sizes:  # the entry point, timed by its own server_seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = simulate_async_rounds(n, HIER_SIM["publish_k"], template, HIER_SIM["publishes"],
                                      hierarchy_edges=HIER_SIM["hierarchy_edges"],
                                      gen_batch=HIER_SIM["gen_batch"], seed=HIER_SIM["seed"])
        torch.cuda.synchronize()
        check(stats["publishes"] == HIER_SIM["publishes"], f"{n} clients: {stats}")
        res["entry"].setdefault(str(n), []).append(
            {**stats, "run_wall_s": time.perf_counter() - t0,
             "rounds_per_hr_server_s": 3600.0 * stats["publishes"] / stats["server_seconds"]})
    traces = []
    for i, n in enumerate(sizes):
        sketches.reset()
        tree, rec = _recording_tree(template)
        sink = _synced_recording_sink(tree)
        f0 = tel.counter(FORWARD_COUNTER).value
        since = _last_span_seq()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = AsyncEventSim(sink, make_synthetic_delta_fn(seed=HIER_SIM["seed"]), n,
                            initial_model=template,
                            delay=DelayModel(n, seed=HIER_SIM["seed"]),
                            gen_batch=HIER_SIM["gen_batch"])
        stats = sim.run(HIER_SIM["publishes"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards = tel.counter(FORWARD_COUNTER).value - f0
        spans = _span_totals(since, HIER_SPANS)
        traces.append(sink.trace)
        check(tree.version == HIER_SIM["publishes"] == stats["publishes"],
              f"{n} clients: tree version {tree.version}, {stats}")
        check(forwards == sum(nd.forwards for nd in tree.nodes()),
              f"hierarchy.forwards counted {forwards}, the nodes "
              f"{[nd.forwards for nd in tree.nodes()]}")
        check(tree.device.type == DEV and all(
            v.device.type == DEV for _, out in rec["root"]["pubs"] for v in out.values()),
            "a root publish off the card")
        tree.flush_sketches()
        view = tree._root_sketch_view()
        st = view.quantiles["staleness"]
        check(st.count == len(sink.trace), f"root staleness count {st.count}, "
                                           f"{len(sink.trace)} client submissions")
        row = {**stats, "run_wall_s": wall,
               "rounds_per_hr_server_s": 3600.0 * stats["publishes"] / stats["server_seconds"],
               "forwards": {"edge": sum(e.forwards for e in tree.edges),
                            "regional": sum(r.forwards for r in tree.regionals)},
               "merges_by_tier": {"edge": sum(e.buffer.merges_total for e in tree.edges),
                                  "regional": sum(r.buffer.merges_total for r in tree.regionals),
                                  "root": tree.root.buffer.merges_total},
               "high_water_by_tier": {
                   "edge": max(e.buffer.depth_high_water for e in tree.edges),
                   "regional": max(r.buffer.depth_high_water for r in tree.regionals),
                   "root": tree.root.buffer.depth_high_water},
               "root_sketch_staleness": {"count": st.count, "p50": st.quantile(0.5),
                                         "p99": st.quantile(0.99)},
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "spans": spans, "sketch_hop_ms": _sketch_hop_ms(tree)}
        if i < 2:  # the re-fold gate at each size
            t1 = time.perf_counter()
            errs = [_of_scale_flat(out, ref) for out, ref in _hier_refold(tree, rec)]
            row["refold_of_scale_max"] = max(errs)
            row["refold_s"] = time.perf_counter() - t1
            check(len(errs) == HIER_SIM["publishes"], f"{len(errs)} root publishes re-folded")
            check(max(errs) <= HIER_TOL, f"{n} clients: a root publish is {max(errs):.3g} of "
                                         f"its scale from the float64 re-fold (HIER_TOL "
                                         f"{HIER_TOL:g})")
            res["gated"][str(n)] = row
        del tree, rec, sink, sim
        gc.collect()
        torch.cuda.empty_cache()
    sketches.reset()
    res["same_seed_same_trace"] = traces[0] == traces[2] and len(traces[0]) > 0
    check(res["same_seed_same_trace"], "the same seed gave another event trace")
    small, large = (str(n) for n in ASYNC_SIM_CLIENTS)
    res["gated_ratio_large_over_small"] = (res["gated"][large]["rounds_per_hr_server_s"]
                                           / res["gated"][small]["rounds_per_hr_server_s"])
    res["entry_ratio_large_over_small"] = (res["entry"][large][0]["rounds_per_hr_server_s"]
                                           / res["entry"][small][0]["rounds_per_hr_server_s"])
    res["flat_phase11"] = {n: {k: flat[n][k] for k in ("server_seconds", "rounds_per_hr_server_s")}
                           for n in (small, large) if n in flat}
    if "ratio_large_over_small" in flat:
        res["flat_phase11"]["ratio_large_over_small"] = flat["ratio_large_over_small"]
    say(f"  (a) the tree over ResNet-56: {res}")
    return res


def _resnet56_template() -> dict:
    """A ResNet-56 state dict on the card, initialised from the seed."""
    import fedml_tpu_torch

    args = fedml_tpu_torch.default_config("simulation", model="resnet56", dataset="cifar10",
                                          random_seed=0, using_gpu=DEV == "cuda")
    model = fedml_tpu_torch.model.create(args, 10, device=DEV)
    return {k: v.detach() for k, v in model.module.state_dict().items()}


def hierarchy_masked(template: dict) -> dict:
    """Phase 15 (b): HierarchyPrivacy over the ResNet-56 template, driven as
    JAX's tests drive its windows; then R5's tree is refused."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.aggregation.async_buffer import StalenessPolicy
    from fedml_tpu_torch.core.aggregation.bucketed import get_engine
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree
    from fedml_tpu_torch.core.privacy import HierarchyPrivacy, masking
    from fedml_tpu_torch.core.privacy.secagg_window import MASKED_LEAF
    from fedml_tpu_torch.models.convert import wire_vector
    from fedml_tpu_torch.simulation.vmapped.async_driver import make_synthetic_delta_fn

    cfg = HIER_MASKED
    n_edges, per, total = cfg["n_edges"], cfg["per_edge"], cfg["n_edges"] * cfg["per_edge"]
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        stacked = make_synthetic_delta_fn(seed=cfg["seed"])(template, list(range(total)), 0)
        deltas = []
        for i in range(total):
            vec = wire_vector({k: v[i] for k, v in stacked.items()}).cpu().numpy()
            scale = min(1.0, 0.9 * masking.QuantSpec().clip / float(np.abs(vec).max()))
            deltas.append((vec * np.float32(scale)).astype(np.float32))
        del stacked
        tree = HierarchyTree.build(n_edges, regional_fanout=cfg["regional_fanout"],
                                   publish_k=per, policy=StalenessPolicy(exponent=0.0),
                                   engine=get_engine(), device=DEV)
        hp = HierarchyPrivacy(tree, template, rng=np.random.default_rng(cfg["seed"]))
        spec = hp.spec
        ups = {}
        for e in tree.edges:
            orig = e.parent._submit_from_child

            def spy(child, weight, model, _orig=orig, _name=e.name):
                ups[_name] = model[MASKED_LEAF]
                return _orig(child, weight, model)

            e.parent._submit_from_child = spy
        cohorts = {e.name: list(range(i * per, (i + 1) * per)) for i, e in enumerate(tree.edges)}
        since = _last_span_seq()
        t0 = time.perf_counter()
        opened = hp.open_edge_windows(cohorts)
        key_s = time.perf_counter() - t0
        mask_ms = []
        for e in tree.edges:
            members = opened[e.name][1]
            for r in cohorts[e.name]:
                t1 = time.perf_counter()
                masked = members[r].mask(deltas[r])
                mask_ms.append((time.perf_counter() - t1) * 1e3)
                verdict = e.privacy.submit(r, masked, client_version=e.buffer.version)
                check(verdict == "accept", f"{e.name} rank {r}: {verdict}")
            e._maybe_publish()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    out = tree.latest_model()
    check(tree.version == 1 and out is not None, f"no root publish (version {tree.version})")
    check(all(v.device.type == DEV for v in out.values()), "the root publish is off the card")
    got = wire_vector(out).cpu().numpy()
    qsum = sum(masking.quantize_vector(d, spec) for d in deltas)
    honest = masking.dequantize_sum(masking.center_ring(np.mod(qsum, spec.ring), spec), total,
                                    spec)
    res = {"config": dict(cfg, spec=spec.as_dict(), d=int(got.size)),
           "bit_equal_honest_quantized_mean": bool(np.array_equal(got, honest)),
           "ledger_after": len(hp.ledger)}
    check(res["bit_equal_honest_quantized_mean"],
          f"the root publish is {float(np.abs(got - honest).max()):.3g} from the honest "
          "quantized mean")
    check(res["ledger_after"] == 0, f"{res['ledger_after']} ledger entries left at the root")
    blind = {}
    for i, e in enumerate(tree.edges):
        check(ups[e.name].device.type == DEV, f"{e.name} forwarded off the card")
        up = ups[e.name].cpu().numpy()
        part = masking.dequantize_sum(
            sum(masking.quantize_vector(deltas[r], spec) for r in cohorts[e.name]), per, spec)
        blind[e.name] = bool(np.all(up >= 0) and not np.allclose(up, part, atol=spec.clip))
    res["edges_blind"] = blind
    check(all(blind.values()), f"an edge's upward vector is close to its honest partial: {blind}")
    spans = _span_totals(since, ("secagg.unmask", "secagg.ring_pass", "secagg.root_unmask",
                                 "hierarchy.publish", "async.merge"))
    nbytes = int(got.size) * 4

    def per_ms(name):
        return 1e3 * spans[name]["s"] / max(1, spans[name]["count"])

    res.update({
        "key_exchange_s": key_s, "window_s": window_s,
        "mask_ms_per_client": sum(mask_ms) / len(mask_ms), "mask_ms_max": max(mask_ms),
        "edge_publish_ms": per_ms("secagg.unmask"),
        "regional_pass_ms": per_ms("secagg.ring_pass"),
        "root_strip_unmask_ms": per_ms("secagg.root_unmask"),
        "spans": spans,
        "bytes_per_ring_vector": nbytes,
        "bytes_forwarded": {"edge": nbytes * sum(e.forwards for e in tree.edges),
                            "regional": nbytes * sum(r.forwards for r in tree.regionals)}})
    r5 = HierarchyTree.build(HIER_R5["n_edges"], regional_fanout=HIER_R5["regional_fanout"],
                             publish_k=HIER_R5["per_edge"], policy=StalenessPolicy(exponent=0.0),
                             device=DEV)
    try:
        HierarchyPrivacy(r5, template, rng=np.random.default_rng(0))
        refused = None
    except ValueError as e:
        refused = str(e)
    res["r5_refused"] = refused
    check(refused is not None and "ring_bits=20 too small" in refused,
          f"R5's tree (8 x 16 under fanout 4) was not refused: {refused}")
    say(f"  (b) tier-masked SecAgg over ResNet-56: {res}")
    return res


def hierarchy_phase(flat: dict) -> dict:
    """Phase 15: (a) the async tree at full width, (b) tier-masked SecAgg
    ((c), no flash launch, is main's)."""
    from fedml_tpu_torch.core.telemetry import sketches

    template = _resnet56_template()
    try:
        return {"fleet": hierarchy_fleet(template, flat), "masked": hierarchy_masked(template)}
    finally:
        sketches.reset()


# -- phase 16: the message plane's other backends ----------------------------------

# phase 10 (b)'s federation at ResNet-20 (4 silos, 2 rounds), over each backend
MP_PROCS = dict(CS_PROCS, model="resnet20")
# comm_bench payloads: ResNet-56's state dict on the card, and a flat f32
# tensor of 64 MB on the card (the copy to the host is in every ping)
MP_BENCH_BIG = 64_000_000
MP_RESNET56_BYTES = 3_423_080  # 855,770 f32 params
MP_BENCH_REPS = {"resnet56": 20, "64mb": 10}
# bit-equal to INMEMORY: every wire carries f32 exactly (phase 10 (b)'s limit)
MP_TOL = CS_PROC_TOL


def _grpc_state() -> str:
    """"installed" when grpc imports; "not installed" when there is no such
    package (the card's machine may lack it); any other failure raises."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        return "not installed"
    import grpc  # noqa: F401 - an installed grpc that fails to import fails the phase

    return "installed"


# every block _on_free_ports has handed out in this process: phase 16 runs
# federations side by side, and a block drawn for one before another has
# bound its own is free to bind but taken
_PORTS_HANDED_OUT: set = set()


def _on_free_ports(run_id: str, backend: str, n: int) -> dict:
    """The base-port knob that puts rank r of ``run_id`` at ``b + r`` for a
    block [b, b + n) that is free now and shares no port with a block handed
    out before (both backends add the run id's offset)."""
    from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
    from fedml_tpu_torch.core.distributed.fedml_comm_manager import _run_id_offset

    key = "trpc_base_port" if backend == "TRPC" else "grpc_base_port"
    for _ in range(100):
        base = free_port_block(n)
        block = set(range(base, base + n))
        if not block & _PORTS_HANDED_OUT:
            _PORTS_HANDED_OUT.update(block)
            return {key: base - _run_id_offset(run_id)}
    raise SmokeFailure(f"no block of {n} ports apart from those handed out")


def _threaded(over: dict, run_id: str, backend: str, ref_w: dict) -> dict:
    """``over`` as silo threads of this process over ``backend``, cuDNN
    deterministic and TF32 off; its final params against ``ref_w``."""
    import torch

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        fed = _Federation(over, run_id, backend=backend)
        types = sorted({type((r.runner.server_manager if rank == 0 else
                              r.runner.client_manager).com_manager).__name__
                        for rank, r in fed.runners.items()})
        since = _last_span_seq()
        wall = fed.run()
        got = _cpu(fed.server.aggregator.get_global_model_params())
    from fedml_tpu_torch.core import telemetry as tel

    round_s = [r["dur_ns"] / 1e9 for r in tel.snapshot()["spans"]
               if r["seq"] > since and r["name"] == "server.round"]
    res = {"backend": backend, "managers": types, "run_wall_s": wall, "round_s": round_s,
           "final_params_err_of_scale_vs_inmemory": _of_scale(got, ref_w),
           "final_params_bit_equal": all(torch.equal(got[k], ref_w[k]) for k in ref_w)}
    check(res["final_params_err_of_scale_vs_inmemory"] <= MP_TOL,
          f"{run_id} over {backend}: final params "
          f"{res['final_params_err_of_scale_vs_inmemory']:.3g} of scale from INMEMORY's")
    return res


def _mp_trpc(tmp: str) -> tuple:
    """Phase 16 (a): the TRPC federation's processes, to their end."""
    run_id = "smoke_mp_trpc"
    over = dict(MP_PROCS, **_on_free_ports(run_id, "TRPC", int(MP_PROCS["client_num_per_round"])
                                           + 1))
    return over, _party_processes(os.path.join(tmp, "trpc"), over, run_id, "TRPC")


def _mp_web3(tmp: str) -> tuple:
    """Phase 16 (b): the MQTT_WEB3 federation's processes over a socket
    broker hosted here, to their end."""
    from fedml_tpu_torch.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker

    broker = SocketMqttBroker(port=0)
    try:
        return _party_processes(
            os.path.join(tmp, "web3"),
            dict(MP_PROCS, mqtt_socket=broker.address, cas_root=os.path.join(tmp, "web3", "cas")),
            "smoke_mp_web3", "MQTT_WEB3")
    finally:
        broker.stop()


def message_plane_processes(tmp: str, trpc: tuple, web3: tuple, ref_w: dict) -> dict:
    """Phase 16 (a) TRPC and (b) MQTT_WEB3: a server and 4 client processes
    over each (run by _mp_trpc and _mp_web3), phase 10 (b)'s federation,
    bit-equal to INMEMORY."""
    n, rounds = int(MP_PROCS["client_num_per_round"]), int(MP_PROCS["comm_round"])
    out = {}
    over, (results, spawned, got) = trpc
    res = {**_process_report(MP_PROCS, results, spawned, got, ref_w),
           "backend": "TRPC, a listener a process",
           "base_port": over["trpc_base_port"]}
    res["frames"] = res.pop("object_store")
    say(f"  (a) ResNet-20, 4 silos x {rounds} rounds, 5 processes over TRPC: {res}")
    check(res["frames"]["writes"] == 2 * n * rounds,
          f"TRPC payload frames {res['frames']['writes']}, want {2 * n * rounds}")
    check(res["final_params_err_of_scale_vs_inmemory"] <= MP_TOL,
          f"TRPC final params {res['final_params_err_of_scale_vs_inmemory']:.3g} of scale "
          "from INMEMORY's")
    out["trpc_processes_4"] = res

    cas = os.path.join(tmp, "web3", "cas")
    results, spawned, got = web3
    res = {**_process_report(MP_PROCS, results, spawned, got, ref_w),
           "backend": "MQTT_WEB3 over SocketMqttBroker, one LocalCASStore directory"}
    res["cas"] = res.pop("object_store")
    res["cas"]["cids"] = len([f for f in os.listdir(cas) if not f.endswith(".tmp")])
    res["cas"]["uploads"] = res["cas"]["writes"]
    say(f"  (b) ResNet-20, 4 silos x {rounds} rounds, 5 processes over MQTT_WEB3: {res}")
    check(res["cas"]["writes"] == 2 * n * rounds and res["cas"]["reads"] == 2 * n * rounds,
          f"CAS writes {res['cas']['writes']}, reads {res['cas']['reads']}")
    # each round's global goes to 4 clients as one object; the 4 uploads differ
    check(res["cas"]["cids"] == rounds * (1 + n),
          f"{res['cas']['cids']} cids for {res['cas']['writes']} uploads, want {rounds * (1 + n)}")
    check(res["final_params_err_of_scale_vs_inmemory"] <= MP_TOL,
          f"MQTT_WEB3 final params {res['final_params_err_of_scale_vs_inmemory']:.3g} of scale "
          "from INMEMORY's")
    out["web3_processes_4"] = res
    return out


def message_plane_threads(tmp: str, ref_w: dict, grpc_state: str) -> dict:
    """Phase 16 (c) GRPC and MPI, (d) the reference wire: phase 10 (b)'s
    federation as silo threads of this process, each bit-equal to
    INMEMORY."""
    n = int(MP_PROCS["client_num_per_round"])
    out = {}
    if grpc_state == "installed":
        for backend in ("GRPC", "MPI"):
            run_id = f"smoke_mp_{backend.lower()}"
            out[f"{backend.lower()}_threads_4"] = _threaded(
                dict(MP_PROCS, **_on_free_ports(run_id, backend, n + 1)), run_id, backend, ref_w)
            say(f"  (c) 4 silo threads over {backend}: {out[f'{backend.lower()}_threads_4']}")
    bucket = os.path.join(tmp, "bucket")
    out["ref_wire_mqtt_s3_threads_4"] = _threaded(
        dict(MP_PROCS, mqtt_s3_wire="fedml", mqtt_s3_bucket_dir=bucket), "smoke_mp_ref_mqtt",
        "MQTT_S3", ref_w)
    out["ref_wire_mqtt_s3_threads_4"]["bucket_objects"] = len(os.listdir(bucket))
    say(f"  (d) 4 silo threads over MQTT_S3, mqtt_s3_wire='fedml': "
        f"{out['ref_wire_mqtt_s3_threads_4']}")
    if grpc_state == "installed":
        run_id = "smoke_mp_ref_grpc"
        out["ref_wire_grpc_threads_4"] = _threaded(
            dict(MP_PROCS, grpc_wire="fedml", **_on_free_ports(run_id, "GRPC", n + 1)), run_id,
            "GRPC", ref_w)
        say(f"  (d) 4 silo threads over GRPC, grpc_wire='fedml': {out['ref_wire_grpc_threads_4']}")
    return out


def message_plane_bench(grpc_state: str) -> list:
    """Phase 16 (e): comm_bench's round trips over INMEMORY, TRPC and GRPC
    (when it imports) at ResNet-56's state dict and at 64 MB, both on the
    card."""
    from fedml_tpu_torch.core.distributed.communication import comm_bench

    template = _resnet56_template()
    check(comm_bench.payload_nbytes(template) == MP_RESNET56_BYTES,
          f"ResNet-56's payload is {comm_bench.payload_nbytes(template)} bytes")
    big = comm_bench.make_payload(MP_BENCH_BIG, DEV)
    rows = []
    for backend in [b for b in comm_bench.BACKENDS if b != "GRPC" or grpc_state == "installed"]:
        for label, payload in (("resnet56", template), ("64mb", big)):
            row = comm_bench.bench_backend(backend, payload=payload, reps=MP_BENCH_REPS[label])
            row["payload"] = label
            check(row["device"].startswith(DEV), f"comm_bench payload on {row['device']}")
            say(f"  (e) comm_bench {backend} {label}: rtt median {row['rtt_ms_median']:.4g} ms, "
                f"{row['mb_per_sec']:.5g} MB/s")
            rows.append(row)
    return rows


def message_plane_phase() -> dict:
    """Phase 16: the message plane's other backends, (a) TRPC and (b)
    MQTT_WEB3 across processes, side by side and beside the INMEMORY
    reference, (c) GRPC and MPI and (d) the reference wire in this process,
    then (e) comm_bench alone ((f), no flash launch, is main's)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = os.path.join(ROOT, ".smoke_run", "message_plane")
    shutil.rmtree(tmp, ignore_errors=True)
    grpc_state = _grpc_state()
    say(f"  grpc: {grpc_state}")
    try:
        with ThreadPoolExecutor(2) as pool:
            trpc, web3 = pool.submit(_mp_trpc, tmp), pool.submit(_mp_web3, tmp)
            ref_w = _inmemory_reference(MP_PROCS, "smoke_mp_ref")
            threads = message_plane_threads(tmp, ref_w, grpc_state)
            trpc, web3 = trpc.result(), web3.result()
        res = {"grpc": grpc_state, "config": {k: MP_PROCS[k] for k in (
            "model", "client_num_per_round", "comm_round", "batch_size")}}
        res.update(message_plane_processes(tmp, trpc, web3, ref_w))
        res.update(threads)
        res["comm_bench"] = message_plane_bench(grpc_state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# -- phase 17: the trust middleware (DP, attacks and defenses, contribution) --------

# (b)-(c): the sp front at ResNet-20 (SP_R20) on the CIFAR-10 surrogate, 2
# rounds; (b) with 4 Byzantine-random attackers of the 16 clients
TRUST_SP = dict(SP_R20, comm_round=2)
TRUST_ATTACK = dict(enable_attack=True, attack_type="byzantine", attack_mode="random",
                    byzantine_client_num=4)
# (a): each defense type's config on the 16 clients of (b)'s first round.
# Bulyan needs n >= 4f + 3, so it is told f = 3 of the 4 attackers
TRUST_DEFENSES = {
    "krum": {}, "multi_krum": {}, "coordinate_wise_median": {},
    "coordinate_wise_trimmed_mean": dict(beta=0.25), "rfa": {}, "geometric_median": {},
    "norm_diff_clipping": dict(norm_bound=5.0), "weak_dp": dict(stddev=0.001), "foolsgold": {},
    "3sigma": {}, "slsgd": dict(trim_param_b=4, alpha=0.1), "crfl": dict(crfl_sigma=0.01),
    "bulyan": dict(byzantine_client_num=3), "cclip": dict(tau=10.0, bucket_size=2),
    "cross_round": {}, "outlier_detection": {}, "residual_reweight": {},
    "robust_learning_rate": dict(robust_threshold=8), "soteria": {},
    "wbc": dict(client_idx=0, batch_idx=1), "3sigma_foolsgold": {}, "3sigma_geomedian": {},
}
# the card's fold against the same function on the CPU in float64 on the
# same (f32) inputs: ||card - cpu|| / ||cpu - w_global||. The fold sums in
# f32 on both (the bucketed engine); the card's medians and sorts are exact
# picks, its products over D and Bulyan's distances to the median run in
# float64 as the CPU's. 1e-4 is about 50x the f32 rounding of a 16-term sum
# relative to one round's update.
TRUST_FOLD_TOL = 1e-4
# (c): a draw's std against its sigma over one model's 272,474 coordinates
# (a standard error of 0.14%)
TRUST_DP_STD_RTOL = 0.01
TRUST_DP = {"cdp": dict(epsilon=500.0, clipping_norm=50.0),
            "ldp": dict(epsilon=500.0, clipping_norm=50.0),
            "nbafl": dict(epsilon=50.0, nbafl_C=5.0),
            "dp_clip": dict(clipping_norm=5.0, noise_multiplier=1.0)}
TRUST_DP_RUN = dict(TRUST_SP, client_num_per_round=4)  # 4 of 16 sampled: q = 0.25
# (d): the vmapped front, one round, 16 clients
TRUST_VMAP = dict(SP_R20, backend="vmap", comm_round=1)
# (f): exact Shapley and LOO over 4 clients (16 subsets), GTG over 16, the
# metric test_acc on the first TRUST_GTG_TEST test images for GTG
TRUST_SHAPLEY_CLIENTS = 4
TRUST_GTG_TEST = 512
TRUST_EFFICIENCY_TOL = 1e-6


def _trust_reset() -> None:
    """Every middleware singleton off again (an init without the knobs)."""
    import fedml_tpu_torch as fedml

    fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda"))


def _trust_sp(over: dict) -> tuple:
    """(b): run_simulation on the sp front; the first round's client list as
    the fold saw it (after the attack), the defense's selections a round,
    round s from the fedavg spans."""
    import math

    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender
    from fedml_tpu_torch.ml.aggregator import DefaultServerAggregator

    first, selections = [], []
    aggregate = DefaultServerAggregator.aggregate

    def recorded(self, pairs):
        if not first:
            first.append(list(pairs))
        out = aggregate(self, pairs)
        sel = getattr(FedMLDefender.get_instance().defender, "selected", None)
        if sel is not None:
            selections.append(list(sel))
        return out

    DefaultServerAggregator.aggregate = recorded
    since = _last_span_seq()
    try:
        out = fedml.run_simulation(args=fedml.default_config(
            "simulation", using_gpu=DEV == "cuda", **over))
    finally:
        DefaultServerAggregator.aggregate = aggregate
    spans = _span_sums(since)
    rounds = [spans[r]["fedavg.round"] for r in sorted(spans)]
    check(len(rounds) == 2 and math.isfinite(out["test_loss"]),
          f"sp run: rounds {rounds}, {out}")
    return first[0], selections, {"test_acc": out["test_acc"], "test_loss": out["test_loss"],
                                  "round_s": rounds}


def _trust_fold(name: str, pairs: list, w_global: dict) -> dict:
    """One defense's three hooks on ``pairs``; what it kept and flagged."""
    from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    over = {**TRUST_SP, **TRUST_ATTACK, **TRUST_DEFENSES[name]}
    d = FedMLDefender()
    d.init(SimpleNamespace(**dict(over, enable_defense=True, defense_type=name)))
    kept = d.defend_before_aggregation(pairs, w_global)
    fold = d.defend_on_aggregation(kept, FedMLAggOperator.agg, w_global)
    out = d.defend_after_aggregation(fold)
    ids = {id(t): i for i, (_, t) in enumerate(pairs)}
    defender = d.defender
    flags = {"kept": [ids.get(id(t)) for _, t in kept],
             "selected": getattr(defender, "selected", None)}
    if hasattr(defender, "get_malicious_client_idxs"):
        flags["three_sigma"] = defender.get_malicious_client_idxs()
    fg = getattr(defender, "_foolsgold", defender)
    if hasattr(fg, "memory"):
        flags["foolsgold_zero"] = [w <= 0 for w in fg.weights]
    return {"out": out, "kept_pairs": kept, "flags": flags}


def _trust_noise_std(name: str, res: dict, pairs: list, w_global: dict) -> float:
    """WeakDP's and CRFL's draws on the card: std over sigma."""
    import torch

    from fedml_tpu_torch.utils.pytree import tree_clip_by_global_norm

    if name == "weak_dp":
        diffs = [torch.cat([(o[k] - i[k]).reshape(-1) for k in i])
                 for (_, o), (_, i) in zip(res["kept_pairs"], pairs)]
        sigma = TRUST_DEFENSES[name]["stddev"]
    else:
        # the fold is the plain mean; CRFL clips it and adds its noise
        from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator

        clean = tree_clip_by_global_norm(FedMLAggOperator.agg(SimpleNamespace(), pairs), 15.0)
        diffs = [torch.cat([(res["out"][k] - clean[k]).reshape(-1) for k in clean])]
        sigma = TRUST_DEFENSES[name]["crfl_sigma"]
    return float(torch.cat(diffs).double().std()) / sigma


def trust_defenses(pairs: list, w_global: dict) -> dict:
    """(a): every defense type's fold on the card (timed, a fresh instance
    after a warm-up one) against the same function on the CPU in float64."""
    import torch

    host = [(n, {k: v.detach().to("cpu", torch.float64) for k, v in t.items()})
            for n, t in pairs]
    host_g = {k: v.detach().to("cpu", torch.float64) for k, v in w_global.items()}
    rows = {}
    for name in TRUST_DEFENSES:
        _trust_fold(name, pairs, w_global)  # warm-up: first calls of each kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = _trust_fold(name, pairs, w_global)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = _trust_fold(name, host, host_g)
        cpu_s = time.perf_counter() - t0
        row = {"ms": ms, "cpu_f64_s": cpu_s, **card["flags"]}
        if name in ("weak_dp", "crfl"):
            ratio = _trust_noise_std(name, card, pairs, w_global)
            check(abs(ratio - 1) <= TRUST_DP_STD_RTOL, f"{name}: draws' std / sigma {ratio}")
            row["std_over_sigma"] = ratio
        else:
            check(card["flags"] == ref["flags"],
                  f"{name}: card {card['flags']} != CPU float64 {ref['flags']}")
            got = {k: v.double().cpu() for k, v in card["out"].items()}
            num = sum(float(((got[k] - ref["out"][k]) ** 2).sum()) for k in got) ** 0.5
            den = sum(float(((ref["out"][k] - host_g[k]) ** 2).sum()) for k in got) ** 0.5
            row["err_of_update"] = num / den
            check(num <= TRUST_FOLD_TOL * den,
                  f"{name}: the card's fold is {num / den:.3g} of the update from the CPU's")
        rows[name] = row
        say(f"  (a) {name}: {row}")
    for name in ("multi_krum", "bulyan"):
        check(min(rows[name]["selected"]) >= TRUST_ATTACK["byzantine_client_num"],
              f"{name} kept an attacker: {rows[name]['selected']}")
    return rows


def trust_dp() -> dict:
    """(c): each DP solution through init and FedMLRunner on the sp front;
    each draw held to its frame's sigma, epsilon to the host accountant
    stepped with the scale the facade accounted each round."""
    import math

    import torch

    from fedml_tpu_torch.core.dp.budget_accountant.rdp_accountant import RDPAccountant
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    out = {}
    for sol, knobs in TRUST_DP.items():
        args, dataset, model, runner = _fedavg_runner(
            dict(TRUST_DP_RUN, enable_dp=True, dp_solution_type=sol, **knobs), DEV == "cuda")
        dp = FedMLDifferentialPrivacy.get_instance()
        frame = dp.frame
        draws, scales = [], []

        def local(grad, gen, extra=None, _f=frame.add_local_noise):
            noised = _f(grad, gen, extra)
            if sol == "dp_clip":  # the client clips its update and adds no noise
                return noised
            if sol == "nbafl":
                clean = {k: v / torch.clamp(v.abs() / frame.big_c, min=1.0)
                         for k, v in grad.items()}
                sigma = frame._sigma_u(int(extra["local_sample_num"]))
            else:
                clean, sigma = grad, frame.ldp.sigma
            draws.append(("local", sigma, torch.cat(
                [(noised[k] - clean[k]).reshape(-1) for k in grad]).double().std().item()))
            return noised

        def central(g, gen, _f=frame.add_global_noise):
            noised = _f(g, gen)
            scales.append(frame.get_rdp_scale())  # what the facade accounts next
            sigma = (frame.cdp.sigma if sol == "cdp" else
                     frame.sigma() if sol == "dp_clip" else frame.sigma_d())
            if sigma:
                draws.append(("central", sigma, torch.cat(
                    [(noised[k] - g[k]).reshape(-1) for k in g]).double().std().item()))
            return noised

        frame.add_local_noise, frame.add_global_noise = local, central
        since = _last_span_seq()
        runner.run()
        spans = _span_sums(since)
        hist = runner.runner.fl_trainer.metrics_history
        check(draws and all(abs(s / sigma - 1) <= TRUST_DP_STD_RTOL for _, sigma, s in draws),
              f"{sol}: draws' std against sigma {draws}")
        if sol == "ldp":  # accounted in global_clip, at the mechanism's sigma
            scales = [frame.get_rdp_scale()] * int(TRUST_DP_RUN["comm_round"])
        check(len(scales) == int(TRUST_DP_RUN["comm_round"]), f"{sol}: accounted {scales}")
        ref = RDPAccountant()
        for scale in scales:
            ref.step(noise_multiplier=scale, sample_rate=dp.sample_rate)
        eps = dp.get_epsilon(1e-5)
        check(eps == ref.get_epsilon(1e-5) and math.isfinite(eps),
              f"{sol}: epsilon {eps} != the host accountant's {ref.get_epsilon(1e-5)}")
        out[sol] = {"draws": len(draws), "kinds": sorted({k for k, _, _ in draws}),
                    "std_over_sigma_max_dev": max(abs(s / sg - 1) for _, sg, s in draws),
                    "sigma": sorted({sg for _, sg, _ in draws}), "epsilon": eps,
                    "sample_rate": dp.sample_rate, "rdp_scales": scales,
                    "test_acc": hist[-1]["test_acc"],
                    "round_s": [spans[r]["fedavg.round"] for r in sorted(spans)]}
    say(f"  (c) DP: {out}")
    return out


def trust_vmap() -> dict:
    """(d): the vmapped front with cdp and the coordinate median: the fold
    bit-equal to the hooks over the unstacked list, the fused path without
    middleware, R7's refusal."""
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.engine import StackedBucketedSink

    folds = []
    fold = StackedBucketedSink.fold

    def recorded(self, round_idx, w_global, result):
        gen = FedMLDifferentialPrivacy.get_instance().generators.get(DEV)
        state = gen.get_state()
        out = fold(self, round_idx, w_global, result)
        folds.append((self._agg, self._agg.get_model_params(), result, out, state))
        return out

    StackedBucketedSink.fold = recorded
    try:
        over = dict(TRUST_VMAP, enable_dp=True, dp_solution_type="cdp", epsilon=500.0,
                    clipping_norm=50.0, enable_defense=True, defense_type="coordinate_wise_median")
        since = _last_span_seq()
        args, dataset, model, runner = _fedavg_runner(over, DEV == "cuda")
        runner.run()
        with_mw = _span_totals(since, ("agg.aggregate_stacked", "fedavg.round"))
        agg, w_before, result, got, state = folds[0]
    finally:
        StackedBucketedSink.fold = fold
    # the same hooks over the unstacked list, the same draws
    stacked, weights = result.stacked
    FedMLDifferentialPrivacy.get_instance().generators.get(DEV).set_state(state)
    agg.set_model_params(w_before)
    lst = [(float(weights[i]), {k: v[i] for k, v in stacked.items()}) for i in range(len(weights))]
    want = agg.on_after_aggregation(agg.aggregate(agg.on_before_aggregation(lst)))
    check(all(torch_equal(got[k], want[k]) for k in want),
          "(d) the vmapped fold differs from the hooks over the unstacked list")
    check(with_mw["agg.aggregate_stacked"]["count"] == 0, f"(d) fused fold ran: {with_mw}")
    _trust_reset()
    since = _last_span_seq()
    _, _, _, plain = _fedavg_runner(dict(TRUST_VMAP, client_num_per_round=4), DEV == "cuda")
    plain.run()
    fused = _span_totals(since, ("agg.aggregate_stacked",))["agg.aggregate_stacked"]["count"]
    check(fused == 1, f"(d) without middleware the fused fold ran {fused} times")
    refused = None
    try:
        fedml.run_simulation(backend="vmap", args=fedml.default_config(
            "simulation", using_gpu=DEV == "cuda",
            **dict(PARROT, backend="vmap", enable_dp=True, dp_solution_type="ldp")))
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "R7" in refused, f"(d) R7 not refused: {refused}")
    res = {"fold_bit_equal_to_hooks": True, "hooked_round_s": with_mw["fedavg.round"]["s"],
           "fused_folds_without_middleware": fused, "r7_refused": refused.split(":")[0]}
    say(f"  (d) vmapped: {res}")
    return res


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def trust_cross_silo() -> dict:
    """(e): 16 INMEMORY silos, one round, multi-Krum and cdp: the pre-noise
    fold equal to the defense, the clip and the fold applied to the same
    arrivals."""
    from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender
    from fedml_tpu_torch.utils.pytree import tree_clip_by_global_norm

    over = dict(SILOS_R20, comm_round=1, enable_defense=True, defense_type="multi_krum",
                enable_dp=True, dp_solution_type="cdp", epsilon=500.0, clipping_norm=50.0)
    fed = _Federation(over, "smoke_trust_cs")
    agg = fed.server.aggregator.aggregator
    seen = []
    before, aggregate = agg.on_before_aggregation, agg.aggregate

    def rec_before(lst):
        out = before(lst)
        seen.append(("arrivals", list(lst)))
        return out

    def rec_aggregate(lst):
        out = aggregate(lst)
        seen.append(("fold", out))
        return out

    agg.on_before_aggregation, agg.aggregate = rec_before, rec_aggregate
    since = _last_span_seq()
    wall = fed.run()
    arrivals, fold = seen[0][1], seen[1][1]
    d = FedMLDefender()
    d.init(SimpleNamespace(**dict(over, client_num_per_round=16)))
    kept = d.defend_before_aggregation(arrivals)
    want = FedMLAggOperator.agg(agg.args, [(n, tree_clip_by_global_norm(t, 50.0)) for n, t in kept])
    check(all(torch_equal(fold[k], want[k]) for k in want),
          "(e) the cross-silo pre-noise fold differs from the defense over the arrivals")
    rows = _cs_round_split(since)
    res = {"silos": 16, "kept": sorted(d.defender.selected), "round_s": rows[0]["round_s"],
           "wall_s": wall,
           "epsilon": FedMLDifferentialPrivacy.get_instance().get_epsilon(1e-5)}
    say(f"  (e) cross-silo: {res}")
    return res


def trust_contribution(pairs: list) -> dict:
    """(f): exact Shapley and LOO over 4 honest clients, GTG over all 16,
    the metric the aggregator's test_acc of the subset model."""
    from fedml_tpu_torch.core.contribution import contribution_assessor_manager as cam
    from fedml_tpu_torch.data.dataset import ArrayDataset
    from fedml_tpu_torch.ml.aggregator import DefaultServerAggregator

    args, dataset, model, _ = _fedavg_runner(dict(TRUST_SP, comm_round=1), DEV == "cuda")
    agg = DefaultServerAggregator(model, args)
    test = dataset[3]

    def metric(params, data=test):
        agg.set_model_params(params)
        return float(agg.test(data, None, args)["test_acc"])

    four = pairs[TRUST_ATTACK["byzantine_client_num"]:][:TRUST_SHAPLEY_CLIENTS]
    t0 = time.perf_counter()
    phi = cam.exact_shapley(four, metric, empty_metric=0.0)
    shapley_s = time.perf_counter() - t0
    full = metric(cam.weighted_average(four))
    check(abs(sum(phi) - full) <= TRUST_EFFICIENCY_TOL,
          f"(f) Shapley efficiency: sum {sum(phi)} != v(all) - v(empty) {full}")
    loo = cam.leave_one_out(four, metric)
    small = ArrayDataset(test.x[:TRUST_GTG_TEST], test.y[:TRUST_GTG_TEST])
    t0 = time.perf_counter()
    gtg = cam.gtg_shapley(pairs, lambda p: metric(p, small))
    gtg_s = time.perf_counter() - t0
    res = {"shapley_4": phi, "loo_4": loo, "v_all": full, "shapley_s": shapley_s,
           "gtg_16": gtg, "gtg_s": gtg_s, "gtg_test_images": TRUST_GTG_TEST}
    say(f"  (f) contribution: {res}")
    return res


def trust_inversion() -> dict:
    """(g): reveal-labels on a batch's LR gradient and DLG on one image, on
    the card."""
    import torch

    from fedml_tpu_torch.core.security.attack.gradient_inversion import (
        dlg_reconstruct, reveal_labels_from_gradients)

    gen = torch.Generator(device=DEV).manual_seed(0)
    w = (0.01 * torch.randn(10, 784, generator=gen, device=DEV)).requires_grad_()
    x = torch.rand(8, 784, generator=gen, device=DEV)  # nonnegative pixels
    y = torch.randint(0, 10, (8,), generator=gen, device=DEV)
    loss = torch.nn.functional.cross_entropy(x @ w.T, y)
    (grad,) = torch.autograd.grad(loss, [w])
    mask = reveal_labels_from_gradients(grad)
    present = torch.zeros(10, dtype=torch.bool, device=DEV)
    present[y] = True
    check(torch_equal(mask, present), f"(g) revealed {mask.tolist()} for labels {y.tolist()}")

    d, c = 8, 4  # JAX's DLG test problem: one image of an LR
    rng = torch.Generator(device=DEV).manual_seed(1)
    p = (0.3 * torch.randn(d, c, generator=rng, device=DEV)).requires_grad_()
    xt = torch.randn(1, d, generator=rng, device=DEV)

    def grad_fn(params, xx, y_soft):
        logp = torch.log_softmax(xx.reshape(xx.shape[0], -1) @ params, dim=-1)
        return torch.autograd.grad(-(y_soft * logp).sum(-1).mean(), [params], create_graph=True)

    observed = [g.detach() for g in grad_fn(p, xt, torch.eye(c, device=DEV)[:1])]
    history = []
    t0 = time.perf_counter()
    rx, _ = dlg_reconstruct(grad_fn, p, observed, (1, d), c, iters=300, lr=0.1, history=history)
    dlg_s = time.perf_counter() - t0
    fall = history[0] / max(history[-1], 1e-30)
    check(fall >= 100, f"(g) DLG's match loss fell {fall:.3g}x, not 100x")
    corr = float(torch.corrcoef(torch.stack([rx.reshape(-1), xt.reshape(-1)]))[0, 1])
    res = {"labels_revealed": int(mask.sum()), "dlg_loss_first": history[0],
           "dlg_loss_last": history[-1], "dlg_fall": fall, "dlg_abs_corr": abs(corr),
           "dlg_s": dlg_s}
    say(f"  (g) inversion: {res}")
    return res


def trust_phase() -> dict:
    """Phase 17: the trust middleware at ResNet-20 (see the module
    docstring)."""
    import torch

    try:
        pairs, _, attacked = _trust_sp(dict(TRUST_SP, **TRUST_ATTACK))
        _, selections, defended = _trust_sp(dict(TRUST_SP, **TRUST_ATTACK, enable_defense=True,
                                                 defense_type="multi_krum"))
        check(len(selections) == 2 and all(min(s) >= 4 for s in selections),
              f"(b) multi-Krum kept an attacker: {selections}")
        defended["selected"] = selections
        say(f"  (b) sp, byzantine random x4: no defense {attacked}, multi_krum {defended}")
        # the first round's global: the seeded model both runs started from
        _, _, model, _ = _fedavg_runner(dict(TRUST_SP, comm_round=1), DEV == "cuda")
        res = {"sp": {"byzantine_no_defense": attacked, "byzantine_multi_krum": defended},
               "defenses": trust_defenses(pairs, model.params)}
        res["dp"] = trust_dp()
        _trust_reset()
        gc.collect()
        torch.cuda.empty_cache()
        res["vmap"] = trust_vmap()
        _trust_reset()
        gc.collect()
        torch.cuda.empty_cache()
        res["cross_silo"] = trust_cross_silo()
        _trust_reset()
        res["contribution"] = trust_contribution(pairs)
        res["inversion"] = trust_inversion()
    finally:
        _trust_reset()
    return res


# -- phase 18: FHE's ciphertext leaves and the sp simulator's other APIs ------------

# (b): phase 7's ResNet-56 sp federation, 16 clients, 2 rounds, rlwe at the
# JAX package's parameters (N 4096, 4 primes of 20 bits, delta 2^30,
# sigma 3.2); (c) phase 10's 16 INMEMORY silos, one round
FHE_SP = dict(RESNET, comm_round=2, enable_fhe=True, fhe_scheme="rlwe")
FHE_CS = dict(CROSS_SILO, comm_round=1, enable_fhe=True, fhe_scheme="rlwe")
FHE_PARITY_CHUNKS = 4   # (a): ring products on the card against np.convolve
FHE_SECRET = "fedml_tpu"  # the default fhe_secret
# (e), (f): phase 7's federation through TurboAggregate (4 ring groups) and
# FedAvg_seq (4 workers), 2 rounds each
TA_RUN = dict(RESNET, federated_optimizer="TA", ta_group_num=4, comm_round=2)
SEQ_RUN = dict(RESNET, federated_optimizer="FedAvg_seq", worker_num=4, comm_round=2)
# (g): the split models at the JAX package's widths (split_width 16,
# gkt_width 8) on phase 7's CIFAR-10 surrogate, 16 clients, 2 rounds; the
# card-against-CPU gate on the first round of 2 clients cut to 256 images,
# TF32 off: each step's loss within 1e-3 relative (Adam's steps turn f32
# noise in a gradient near 0 into up to lr of a weight, tests/test_torch_sp_zoo.py)
SPLIT_RUN = dict(RESNET, federated_optimizer="split_nn", comm_round=2)
GKT_RUN = dict(RESNET, federated_optimizer="FedGKT", comm_round=2)
SPLIT_PARITY_IMAGES = 256
SPLIT_LOSS_RTOL = 1e-3
# (h): decentralized online logistic regression, 16 clients streaming 2,000
# samples of 18 features, 200 iterations of batch 8; vertical FL, a host and
# two guests (8, 12, 20 features) over 20,000 rows, 3 epochs of batch 256.
# float64 on both devices: DSGD and VFL within 1e-10 of the CPU's (products
# summed in other orders), PushSum within 1e-5 (its push weights are
# float32, as in the JAX package)
DEC_SHAPE = dict(clients=16, samples=2000, features=18, iterations=200, batch=8)
VFL_SHAPE = dict(rows=20000, features=(8, 12, 20), epochs=3, batch=256)
DEC_TOL = {"dsgd": 1e-10, "pushsum": 1e-5}
VFL_TOL = 1e-10


class _Patched:
    """Replace class attributes for the length of a ``with`` block and put
    back exactly what was there (an inherited method stays inherited)."""

    def __init__(self, *patches):
        self.patches = patches  # (cls, name, fn)

    def __enter__(self):
        self.saved = [(cls, name, cls.__dict__.get(name)) for cls, name, _ in self.patches]
        for cls, name, fn in self.patches:
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for cls, name, old in self.saved:
            if old is None:
                delattr(cls, name)
            else:
                setattr(cls, name, old)
        return False


def _fhe_key_error_max(params) -> int:
    """max |e| of the key's error, re-derived from the shared secret as
    RLWEScheme derives the key (sha256 seed; s, a, then e)."""
    import hashlib

    import numpy as np

    seed = int.from_bytes(hashlib.sha256(FHE_SECRET.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    rng.integers(-1, 2, params.n)
    for p in params.primes:
        rng.integers(0, p, params.n, dtype=np.int64)
    return int(np.abs(np.rint(rng.normal(0, params.sigma, params.n))).max())


def fhe_parity() -> dict:
    """(a): keygen, encryption under one seeded generator and decryption
    residues on the card against the plain np.convolve version, N=4096."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.fhe.rlwe import RLWEContext, RLWEParams

    params = RLWEParams()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card = RLWEContext(params, seed=7, device=DEV, route="matrix")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    mats_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    plain = RLWEContext(params, seed=7, device="cpu")
    check(card.route == "matrix" and plain.route == "plain", "(a) routes")
    check(torch.equal(card.s.cpu(), plain.s) and all(
        torch.equal(a.cpu(), b) for a, b in zip(card.pk, plain.pk)), "(a) keys differ")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.5, FHE_PARITY_CHUNKS * params.n - 100).astype(np.float32))
    card._rng, plain._rng = np.random.default_rng(3), np.random.default_rng(3)
    ct_card = card.encrypt(x.to(DEV))
    ct_plain = plain.encrypt(x)
    check(ct_card.c0.shape[1] == FHE_PARITY_CHUNKS and torch.equal(ct_card.c0.cpu(), ct_plain.c0)
          and torch.equal(ct_card.c1.cpu(), ct_plain.c1), "(a) ciphertexts differ")
    both = ct_card * 0.75 + ct_card * 0.25
    both_plain = ct_plain * 0.75 + ct_plain * 0.25
    res_card = card.decrypt_residues([both])
    res_plain = plain.decrypt_residues([both_plain])
    check(torch.equal(res_card.cpu(), res_plain), "(a) decryption residues differ")
    dec = card.decode(res_card, [both])[0]
    err = float((dec.cpu() - x).abs().max())
    check(err < 1e-6, f"(a) decryption {err:.3g} from the plaintext")
    out = {"n": params.n, "primes": params.primes, "chunks": FHE_PARITY_CHUNKS,
           "keygen_s": keygen_s, "matrices_gb": mats_gb, "max_abs_err": err}
    del card
    say(f"  (a) keys, ciphertexts and residues equal to np.convolve's: {out}")
    return out


class _FheProbe:
    """Class-level wrappers around the port's RLWE scheme and the sp
    aggregator for (b) and (c): each encryption's plaintext (by the identity
    of its first ciphertext) and its ms and bytes, the error draws' largest
    magnitude, each fold's pairs and ms, each decryption's products and CRT
    ms and its output."""

    def __init__(self):
        import torch

        from fedml_tpu_torch.core.fhe import rlwe
        from fedml_tpu_torch.ml.aggregator import DefaultServerAggregator

        self.plain, self.enc_ms, self.ct_bytes, self.folds, self.decrypted = {}, [], [], [], []
        self.decodes = []
        self.products_ms, self.crt_ms, self.host_crt_ms, self.fold_ms = [], [], [], []
        self.err_max = 0
        targets = [(rlwe.RLWEScheme, "encrypt"), (rlwe.RLWEContext, "_draws"),
                   (rlwe.RLWEContext, "decrypt_residues"), (rlwe.RLWEContext, "decode"),
                   (DefaultServerAggregator, "aggregate")]
        enc, draws, residues, decode, aggregate = [getattr(c, n) for c, n in targets]
        self._decode = decode  # unwrapped: the host CRT's gate records nothing
        probe = self

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def w_encrypt(self_, tree, nonce):
            out, ms = timed(lambda: enc(self_, tree, nonce))
            first = next(iter(out.values()))
            probe.plain[id(first)] = {k: v.detach().clone() for k, v in tree.items()}
            probe.enc_ms.append(ms)
            probe.ct_bytes.append(sum(c.nbytes for c in out.values()))
            return out

        def w_draws(self_, total):
            u, e1, e2 = draws(self_, total)
            probe.err_max = max(probe.err_max, int(abs(e1).max()), int(abs(e2).max()))
            return u, e1, e2

        def w_residues(self_, cts):
            out, ms = timed(lambda: residues(self_, cts))
            probe.products_ms.append(ms)
            return out

        def w_decode(self_, res, cts, host_crt=None):
            out, ms = timed(lambda: decode(self_, res, cts, host_crt))
            probe.crt_ms.append(ms)
            probe.decrypted.append(out)
            # kept for the host CRT's gate after the run, outside the round
            probe.decodes.append((self_, res, list(cts)))
            return out

        def w_aggregate(self_, pairs):
            out, ms = timed(lambda: aggregate(self_, pairs))
            probe.fold_ms.append(ms)
            probe.folds.append(list(pairs))
            return out

        self._patch = _Patched(*[(c, n, fn) for (c, n), fn in zip(
            targets, (w_encrypt, w_draws, w_residues, w_decode, w_aggregate))]).__enter__()

    def close(self):
        self._patch.__exit__(None, None, None)

    def check_fold(self, i: int, what: str, params) -> dict:
        """Fold i's decryption against sum_i k_i rint(2^30 x_i) / 2^46 of
        the same plaintexts, within the worst-case noise bound
        sum_i k_i (2N + 1) B / 2^46 (B the largest error of the run) and half
        an f32 ulp; and its gap to the plain float64 weighted mean."""
        import numpy as np
        import torch

        pairs = self.folds[i]
        weights = np.asarray([float(n) for n, _ in pairs], np.float32)
        weights = weights / weights.sum()
        ks = [int(round(float(w) * 2 ** 16)) for w in weights]
        plains = [self.plain[id(next(iter(t.values())))] for _, t in pairs]
        names = list(plains[0])
        got = dict(zip(names, self.decrypted[i]))
        # the card's CRT (Garner digits) against the host's Python integers
        ctx, res, cts = self.decodes[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = self._decode(ctx, res, cts, True)
        self.host_crt_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(torch.equal(a, b) for a, b in zip(self.decrypted[i], host)),
              f"{what}: the card's CRT differs from the host's")
        b = max(self.err_max, _fhe_key_error_max(params))
        bound = sum(ks) * (2 * params.n + 1) * b / 2 ** 46
        worst = gap = 0.0
        for k in names:
            fixed = sum(kk * torch.round(p[k].double() * 2 ** 30).long()
                        for kk, p in zip(ks, plains)).double() / 2 ** 46
            g = got[k].double()
            ulp = (torch.nextafter(got[k].abs(), torch.tensor(float("inf"), device=g.device))
                   - got[k].abs()).double() / 2
            worst = max(worst, float(((g - fixed).abs() - ulp).max()))
            mean = sum(float(w) * p[k].double() for w, p in zip(weights, plains))
            gap = max(gap, float((g - mean).abs().max()))
        check(worst <= bound, f"{what}: decryption {worst:.3g} from the fixed-point sum, "
                              f"bound {bound:.3g}")
        return {"clients": len(pairs), "err_vs_fixed_point": worst, "noise_bound": bound,
                "error_draw_max": b, "gap_to_f32_fold": gap}


def fhe_sp(plain_round_s) -> dict:
    """(b): rlwe through init and FedMLRunner on the sp front."""
    import math

    import torch

    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE

    probe = _FheProbe()
    try:
        args, dataset, model, runner = _fedavg_runner(FHE_SP, DEV == "cuda")
        ctx = FedMLFHE.get_instance().scheme.ctx
        check(ctx.device.type == DEV and ctx.route == ("matrix" if DEV == "cuda" else "plain"),
              f"(b) FHE on {ctx.device}, route {ctx.route}")
        since = _last_span_seq()
        runner.run()
        spans = _span_sums(since)
        hist = runner.runner.fl_trainer.metrics_history
        check(len(probe.folds) == 2 and len(probe.decrypted) == 2 and len(probe.enc_ms) == 32,
              f"(b) {len(probe.folds)} folds, {len(probe.enc_ms)} encryptions")
        rounds = [probe.check_fold(i, f"(b) round {i}", ctx.params) for i in range(2)]
        check(all(math.isfinite(m["test_loss"]) for m in hist), f"(b) {hist}")
        res = {"rounds": rounds, "round_s": [spans[r]["fedavg.round"] for r in sorted(spans)],
               "plain_round_s_phase7": plain_round_s,
               "encrypt_ms_client": sum(probe.enc_ms) / len(probe.enc_ms),
               "ciphertext_bytes_client": probe.ct_bytes[0],
               "plaintext_bytes_client": sum(v.numel() * 4 for v in model.params.values()),
               "chunks_client": sum(-(-v.numel() // ctx.params.n) for v in model.params.values()),
               "fold_ms": probe.fold_ms, "decrypt_products_ms": probe.products_ms,
               "decrypt_crt_ms": probe.crt_ms, "host_crt_ms": probe.host_crt_ms,
               "test_acc": [m["test_acc"] for m in hist],
               "test_loss": [m["test_loss"] for m in hist]}
    finally:
        probe.close()
        _trust_reset()
        gc.collect()
        torch.cuda.empty_cache()
    say(f"  (b) sp, rlwe, 16 clients x 2 rounds: {res}")
    return res


def fhe_cross_silo() -> dict:
    """(c): 16 INMEMORY silos, one round of rlwe: the server's global
    against the fixed-point sum of the arrivals' plaintexts."""
    import torch

    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE

    probe = _FheProbe()
    try:
        fed = _Federation(FHE_CS, "smoke_fhe_cs")
        params = FedMLFHE.get_instance().scheme.ctx.params
        since = _last_span_seq()
        wall = fed.run()
        glob = fed.server.aggregator.get_global_model_params()
        check(len(probe.folds) == 1 and len(probe.folds[0]) == 16, "(c) one fold of 16")
        res = probe.check_fold(0, "(c)", params)
        check(all(torch.equal(glob[k], v) for k, v in zip(glob, probe.decrypted[0])),
              "(c) the server's global is not the decryption")
        res.update(round_s=_cs_round_split(since)[0]["round_s"], wall_s=wall,
                   fold_ms=probe.fold_ms[0], decrypt_crt_ms=probe.crt_ms[0],
                   host_crt_ms=probe.host_crt_ms[0])
    finally:
        probe.close()
        _trust_reset()
        gc.collect()
        torch.cuda.empty_cache()
    say(f"  (c) cross-silo, rlwe, 16 silos: {res}")
    return res


def fhe_refusals() -> dict:
    """(d): R7 (backend vmap), R10 (additive_mask), R11 (a byte backend)
    refused with ValueError before any round."""
    import fedml_tpu_torch as fedml

    since = _last_span_seq()
    cases = {"R7": lambda: fedml.run_simulation(backend="vmap", args=fedml.default_config(
                 "simulation", using_gpu=DEV == "cuda", **dict(PARROT, backend="vmap",
                                                              enable_fhe=True))),
             "R10": lambda: fedml.run_simulation(args=fedml.default_config(
                 "simulation", using_gpu=DEV == "cuda",
                 **dict(PARROT, enable_fhe=True, fhe_scheme="additive_mask"))),
             "R11": lambda: fedml.FedMLRunner(fedml.default_config(
                 "cross_silo", using_gpu=DEV == "cuda", enable_fhe=True, backend="MQTT_S3",
                 role="client", rank=1), DEV, None, None)}
    out = {}
    for tag, fn in cases.items():
        try:
            fn()
            out[tag] = "ran"
        except ValueError as e:
            out[tag] = "refused" if tag in str(e) else f"other: {e}"
    _trust_reset()
    check(all(v == "refused" for v in out.values()), f"(d) {out}")
    check(_last_span_seq() == since, "(d) a round started before a refusal")
    say(f"  (d) {out}")
    return out


def ta_run(plain_round_s) -> dict:
    """(e): TurboAggregate: each ring sum bit-equal to the plain field sum
    of the same quantized updates; the global within K/2 quantization steps
    of the float64 fold (each of the K weighted updates rounds by at most
    half a step) plus an f32 ulp."""
    import torch

    from fedml_tpu_torch.core.mpc.finite_field import flatten_finite, tree_to_finite
    from fedml_tpu_torch.simulation.sp import turboaggregate as ta
    from fedml_tpu_torch.utils.pytree import tree_scale

    rings = []
    ring_sum, ring_agg = ta.TurboAggregateTrainer._ring_sum, ta.TurboAggregateTrainer._ring_aggregate

    def w_sum(self_, w_locals):
        out = ring_sum(self_, w_locals)
        rings.append((list(w_locals), out))
        return out

    def w_agg(self_, w_locals):
        out = ring_agg(self_, w_locals)
        rings[-1] = rings[-1] + (out,)
        return out

    with _Patched((ta.TurboAggregateTrainer, "_ring_sum", w_sum),
                  (ta.TurboAggregateTrainer, "_ring_aggregate", w_agg)):
        _, _, _, runner = _fedavg_runner(TA_RUN, DEV == "cuda")
        since = _last_span_seq()
        runner.run()
        spans = _span_sums(since)
    check(len(rings) == 2, f"(e) {len(rings)} ring sums")
    gaps = []
    for w_locals, partial, glob in rings:
        total = sum(n for n, _ in w_locals)
        plain = sum(flatten_finite(tree_to_finite(tree_scale(w, n / total), ta._Q_BITS, ta._P))
                    for n, w in w_locals) % ta._P
        check(torch.equal(partial, plain), "(e) the ring sum differs from the field sum")
        step = 2.0 ** -ta._Q_BITS
        gap = max(float((glob[k].double() - sum(n / total * w[k].double() for n, w in w_locals))
                        .abs().max()) for k in glob)
        check(gap <= len(w_locals) / 2 * step + 1e-6, f"(e) global {gap:.3g} from the float fold")
        gaps.append(gap / step)
    res = {"groups": TA_RUN["ta_group_num"], "round_s": [spans[r]["fedavg.round"]
                                                           for r in sorted(spans)],
           "plain_round_s_phase7": plain_round_s, "gap_in_steps": gaps,
           "test_acc": runner.runner.fl_trainer.metrics_history[-1]["test_acc"]}
    say(f"  (e) TA: {res}")
    return res


def seq_run(plain_round_s) -> dict:
    """(f): FedAvg_seq with 4 workers: every client in exactly one queue;
    each round's global the fold of its 16 w_locals (FOLD_TOL of the float64
    weighted mean, as phase 7's)."""
    import torch

    from fedml_tpu_torch.simulation.sp.fedavg_seq import FedAvgSeqAPI

    marks, folds = [], []
    schedule, update = FedAvgSeqAPI._schedule, FedAvgSeqAPI._server_update

    def w_schedule(self_, cohort):
        marks.append([time.perf_counter()])
        return schedule(self_, cohort)

    def w_update(self_, w_global, w_locals):
        out = update(self_, w_global, w_locals)
        torch.cuda.synchronize()
        marks[-1].append(time.perf_counter())
        folds.append((list(w_locals), out))
        return out

    with _Patched((FedAvgSeqAPI, "_schedule", w_schedule),
                  (FedAvgSeqAPI, "_server_update", w_update)):
        _, _, _, runner = _fedavg_runner(SEQ_RUN, DEV == "cuda")
        runner.run()
    hist = runner.runner.fl_trainer.metrics_history
    errs = []
    for m in hist:
        check(sorted(i for q in m["schedule"] for i in q) == list(range(16))
              and len(m["schedule"]) == 4, f"(f) queues {m['schedule']}")
    for pairs, fold in folds:
        total = sum(n for n, _ in pairs)
        err = max(float(((fold[k].double() - sum(n * t[k].double() for n, t in pairs) / total)
                         .abs().max() / fold[k].double().abs().max().clamp_min(1e-30)))
                  for k in fold)
        check(err <= FOLD_TOL, f"(f) the fold is {err:.3g} from the weighted mean")
        errs.append(err)
    res = {"workers": SEQ_RUN["worker_num"], "round_s": [b - a for a, b in marks],
           "plain_round_s_phase7": plain_round_s,
           "makespan_s": [m["makespan"] for m in hist], "schedule": [m["schedule"] for m in hist],
           "fold_err_of_scale": errs, "test_acc": hist[-1]["test_acc"]}
    say(f"  (f) FedAvg_seq: {res}")
    return res


def _split_parity(opt: str) -> dict:
    """(g)'s gate: the first round of 2 clients cut to SPLIT_PARITY_IMAGES
    on the card against the CPU, TF32 off, from the same seeded init: each
    local step's loss within SPLIT_LOSS_RTOL."""
    import torch

    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.simulation.sp.fedgkt import FedGKTAPI
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNAPI

    over = dict(SPLIT_RUN if opt == "split_nn" else GKT_RUN, client_num_in_total=2,
                client_num_per_round=2, comm_round=1)
    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **over))
    dataset, _ = fedml.data.load(args)
    cut = {c: dataset[5][c].subset(list(range(SPLIT_PARITY_IMAGES))) for c in range(2)}
    dataset = list(dataset)
    dataset[5], dataset[4] = cut, {c: SPLIT_PARITY_IMAGES for c in range(2)}
    losses = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        for where in (DEV, "cpu"):
            if opt == "split_nn":
                api = SplitNNAPI(args, where, dataset)
                step = api._step
                seen = []

                def rec(x, y, step=step, seen=seen):
                    out = step(x, y)
                    seen.append(float(out))
                    return out

                api._step = rec
                api._train_client(0)
                api._train_client(1)
                losses[where] = seen
            else:
                api = FedGKTAPI(args, where, dataset)
                losses[where] = [api.train()[k] for k in ("client_loss", "server_loss")]
    card, cpu = losses[DEV], losses["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(len(card) == len(cpu) > 0 and rel <= SPLIT_LOSS_RTOL,
          f"(g) {opt}: card losses {card} against the CPU's {cpu}")
    return {"losses": card, "cpu_losses": cpu, "max_rel_diff": rel}


def split_runs() -> dict:
    """(g): split NN and FedGKT through FedMLRunner, 2 rounds on the card."""
    import math

    res = {}
    for opt, over in (("split_nn", SPLIT_RUN), ("FedGKT", GKT_RUN)):
        gate = _split_parity(opt)
        _, _, _, runner = _fedavg_runner(over, DEV == "cuda")
        t0 = time.perf_counter()
        runner.run()
        wall = time.perf_counter() - t0
        hist = runner.runner.fl_trainer.metrics_history
        check(len(hist) == 2 and all(math.isfinite(m["test_acc"]) for m in hist),
              f"(g) {opt}: {hist}")
        res[opt] = {"parity": gate, "s_a_round": wall / len(hist),
                    "test_acc": [m["test_acc"] for m in hist],
                    **{k: [m[k] for m in hist] for k in ("train_loss", "client_loss",
                                                        "server_loss") if k in hist[0]}}
    say(f"  (g) split NN and FedGKT: {res}")
    return res


def _dec_data():
    import numpy as np

    s = DEC_SHAPE
    rng = np.random.RandomState(0)
    w_true = rng.randn(s["features"])
    x = rng.randn(s["clients"], s["samples"], s["features"])
    return x, (x @ w_true > 0).astype(np.float64)


def decentralized_and_vfl() -> dict:
    """(h): DSGD, PushSum and vertical FL on the card against the CPU in
    float64; each loss falling."""
    import numpy as np
    import torch

    from fedml_tpu_torch.simulation.sp.classical_vertical_fl import (VerticalFederatedLearning,
                                                                     VflFixture)
    from fedml_tpu_torch.simulation.sp.decentralized import FedML_decentralized_fl

    def loss_fn(params, xb, yb):
        logit = xb @ params["w"] + params["b"]
        return torch.mean(torch.clamp(logit, min=0) - logit * yb
                          + torch.log1p(torch.exp(-torch.abs(logit))))

    s = DEC_SHAPE
    x, y = _dec_data()
    res = {}
    for mode, symmetric in (("dsgd", True), ("pushsum", False)):
        args = SimpleNamespace(b_symmetric=symmetric, iteration_number=s["iterations"],
                               learning_rate=0.3, batch_size=s["batch"],
                               topology_neighbors_num_undirected=4,
                               topology_neighbors_num_directed=2)
        runs = {}
        for where in (DEV, "cpu"):
            p0 = {"w": torch.zeros(s["features"], dtype=torch.float64),
                  "b": torch.zeros((), dtype=torch.float64)}
            t0 = time.perf_counter()
            out = FedML_decentralized_fl(s["clients"], (x, y), p0, loss_fn, args, device=where)
            runs[where] = (out, time.perf_counter() - t0)
        (card, card_s), (cpu, _) = runs[DEV], runs["cpu"]
        err = max(float((card["params"][k].cpu() - cpu["params"][k]).abs().max()
                        / cpu["params"][k].abs().max()) for k in cpu["params"])
        hist = card["loss_history"]
        check(err <= DEC_TOL[mode] and hist[-1] < hist[0],
              f"(h) {mode}: {err:.3g} from the CPU, loss {hist[0]:.4g} -> {hist[-1]:.4g}")
        res[mode] = {"err_of_scale": err, "loss_first": hist[0], "loss_last": hist[-1],
                     "s": card_s}
    v = VFL_SHAPE
    rng = np.random.RandomState(1)
    xs = [rng.randn(v["rows"], d) for d in v["features"]]
    yv = (sum(xx @ rng.randn(xx.shape[1]) for xx in xs) > 0).astype(np.float64)
    n_tr = v["rows"] * 4 // 5
    runs = {}
    for where in (DEV, "cpu"):
        vfl = VerticalFederatedLearning(list(v["features"]), learning_rate=0.5, device=where,
                                        dtype=torch.float64)
        fx = VflFixture(vfl)
        t0 = time.perf_counter()
        m = fx.fit([xx[:n_tr] for xx in xs], yv[:n_tr], [xx[n_tr:] for xx in xs], yv[n_tr:],
                   epochs=v["epochs"], batch_size=v["batch"])
        runs[where] = (vfl, fx, m, time.perf_counter() - t0)
    (cv, cf, cm, cs), (pv, pf, pm, _) = runs[DEV], runs["cpu"]
    err = max(float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
              for a, b in zip(cv.party_params, pv.party_params) for k in b)
    check(err <= VFL_TOL and cf.loss_list[-1] < cf.loss_list[0] and cm["test_acc"] == pm["test_acc"],
          f"(h) vfl: {err:.3g} from the CPU, {cm} against {pm}")
    res["vfl"] = {"err_of_scale": err, "loss_first": cf.loss_list[0],
                  "loss_last": cf.loss_list[-1], "test_acc": cm["test_acc"], "s": cs}
    say(f"  (h) decentralized and vertical FL, card against CPU in float64: {res}")
    return res


def fhe_sp_zoo_phase(fedavg: dict) -> dict:
    """Phase 18 (see the module docstring)."""
    import torch

    plain = fedavg["resnet56"]["round_s_mean_rounds_2_3"]
    res = {"fhe": {"parity": fhe_parity()}}
    gc.collect()
    torch.cuda.empty_cache()
    res["fhe"]["sp"] = fhe_sp(plain)
    res["fhe"]["cross_silo"] = fhe_cross_silo()
    res["fhe"]["refusals"] = fhe_refusals()
    res["ta"] = ta_run(plain)
    res["fedavg_seq"] = seq_run(plain)
    gc.collect()
    torch.cuda.empty_cache()
    res["split"] = split_runs()
    res["decentralized_vfl"] = decentralized_and_vfl()
    _trust_reset()
    return res


# -- phase 19: FedGAN, FedNAS, FedSeg and the rest of the model hub ----------------

# (a) FedGAN on the MNIST surrogate (28x28x1, 12,000 images), 4 clients of
# 3,000, all in every round, 2 rounds, Adam(2e-4, b1 0.5), batches of 64
GAN_RUN = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="homo",
               model="gan", federated_optimizer="FedGAN", client_num_in_total=4,
               client_num_per_round=4, comm_round=2, epochs=1, batch_size=64,
               learning_rate=2e-4, backend="sp")
# (b) FedNAS on the CIFAR-10 surrogate: the DARTS supernet at the hub's
# defaults (width 16, 3 cells of 3 steps), 4 clients of 3,000, 1 round
NAS_RUN = dict(random_seed=0, dataset="cifar10", data_cache_dir="", partition_method="homo",
               model="darts", federated_optimizer="FedNAS", client_num_in_total=4,
               comm_round=1, epochs=1, batch_size=64, learning_rate=0.025, darts_width=16,
               darts_layers=3, darts_steps=3, backend="sp")
# (c) FedSeg on the pascal_voc surrogate with unet (SegNetLite), 4 clients of
# 16 images, 2 rounds
SEG_RUN = dict(random_seed=0, dataset="pascal_voc", data_cache_dir="", model="unet",
               federated_optimizer="FedSeg", client_num_in_total=4, comm_round=2, epochs=1,
               batch_size=8, learning_rate=0.05, backend="sp")
# (a), (b): round 0 on the card against the CPU in float64, on shards cut to
# this many images (the run's code path at a size the host's CPU runs in
# seconds; FedNAS with 2 of its clients and batches of 16); the pair, the
# supernet and the losses within F64_TOL (relative to each leaf's scale)
GAN_PARITY_IMAGES, NAS_PARITY_IMAGES, NAS_PARITY_BATCH = 64, 32, 16
F64_TOL = 1e-9
# (c) card against CPU in float32, TF32 off: the params' update after 2
# rounds (4 SGD steps a client) within SEG_UPDATE_TOL (relative L2), the
# confusion matrices within SEG_CM_PIXELS of the 16,384 test pixels
SEG_UPDATE_TOL, SEG_CM_PIXELS = 1e-3, 16
# (d) one FedAvg round of each remaining hub model on its dataset, 2 clients,
# each shard cut to HUB_SHARD examples (one SGD step of 32) and the test set to
# HUB_TEST. Card against CPU from the same seeded params in float64 (params
# and float features): the forward on the first client's first batch and
# the round's update (relative L2) within HUB_F64_TOL. In float32 the round
# measures the dynamics, not the port: on the CPU, a client's 4-step
# EfficientNet-lite update moves by 15% when its params move by 1e-7
# (relative), and the card's f32 round of 4 steps read 7.6% from the CPU's
# while its logits read 3.3e-6. In float64 the card's round equals the
# CPU's: an ulp of gradient times the rate is below an ulp of the weight.
# Then the round in float32 on the card, timed. The text classifier's
# dropout is off in the comparison (the card's and the CPU's generators draw
# different masks); its timed round keeps it.
HUB_FEDAVG = dict(random_seed=0, data_cache_dir="", partition_method="homo",
                  federated_optimizer="FedAvg", client_num_in_total=2, client_num_per_round=2,
                  comm_round=1, epochs=1, batch_size=32, client_optimizer="sgd",
                  learning_rate=0.01, frequency_of_the_test=1, backend="sp")
HUB_RUNS = (("mobilenet", "cifar10"), ("mobilenet_v3", "cifar10"), ("efficientnet", "cifar10"),
            ("rnn", "shakespeare"), ("rnn_stackoverflow", "stackoverflow_nwp"),
            ("distilbert", "20news"), ("lr", "stackoverflow_lr"), ("lr", "lending_club"))
HUB_SHARD, HUB_TEST = 32, 64
HUB_F64_TOL = 1e-8


class _TimedHistory(list):
    """A metrics_history that records the time of each append: an API
    appends once a round, after the round's metrics are read back."""

    def __init__(self):
        super().__init__()
        self.times = [time.perf_counter()]

    def append(self, item):
        self.times.append(time.perf_counter())
        super().append(item)

    @property
    def round_s(self) -> list:
        return [b - a for a, b in zip(self.times, self.times[1:])]


def _as_f64(dataset):
    """The dataset tuple with its float arrays in float64 (token ids stay
    integers)."""
    from fedml_tpu_torch.data.dataset import ArrayDataset

    def f64(ds):
        x, y = (a.astype("float64") if a.dtype.kind == "f" else a for a in (ds.x, ds.y))
        return ArrayDataset(x, y)

    d = list(dataset)
    d[2], d[3] = f64(d[2]), f64(d[3])
    d[5] = {c: f64(ds) for c, ds in d[5].items()}
    d[6] = {c: f64(ds) for c, ds in d[6].items()}
    return tuple(d)


def _cut_shards(dataset, n: int, n_test: int = 0, clients: int = 0):
    """The dataset tuple with each train shard cut to its first ``n``
    examples (and the first ``clients`` shards, the test set to ``n_test``)."""
    import numpy as np

    d = list(dataset)
    keep = sorted(d[5])[:clients or None]
    d[5] = {c: d[5][c].subset(np.arange(min(n, len(d[5][c])))) for c in keep}
    d[4] = {c: len(d[5][c]) for c in keep}
    if n_test:
        d[3] = d[3].subset(np.arange(min(n_test, len(d[3]))))
    return tuple(d)


def _api_run(over: dict, dataset, dim: int, where: str, f64: bool = False,
             prepare=None) -> dict:
    """init, model.create on ``where``, FedMLRunner over ``dataset``; the
    API after the run, the start params, the wall and each round's s."""
    import torch

    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", using_gpu=where == "cuda", **over))
    model = fedml.model.create(args, dim, device=where)
    if f64:
        model.module.to(torch.float64)
        model.params = {k: v.to(torch.float64) for k, v in model.params.items()}
    if prepare is not None:
        prepare(model)
    p0 = _cpu(model.params)
    runner = fedml.FedMLRunner(args, torch.device(where), dataset, model)
    api = runner.runner.fl_trainer
    api.metrics_history = hist = _TimedHistory()
    t0 = time.perf_counter()
    runner.run()
    if where == "cuda":
        torch.cuda.synchronize()
    return {"api": api, "model": model, "p0": p0, "s": time.perf_counter() - t0,
            "round_s": hist.round_s, "hist": list(hist)}


def _of_scale(a: dict, b: dict) -> float:
    """max over leaves of max|a - b| / max|b|."""
    return max((a[k].double() - b[k].double()).abs().max().item()
               / max(b[k].double().abs().max().item(), 1e-30) for k in b)


def _f64_parity(name: str, over: dict, dataset, dim: int, params_of) -> dict:
    """Round 0 on the card and on the CPU in float64 from the same params."""
    import torch

    runs = {where: _api_run(over, dataset, dim, where, f64=True) for where in (DEV, "cpu")}
    card, cpu = runs[DEV], runs["cpu"]
    check(all(torch.equal(card["p0"][k], cpu["p0"][k]) for k in cpu["p0"]),
          f"{name}: the card and the CPU started from different params")
    err = _of_scale(_cpu(params_of(card["api"])), _cpu(params_of(cpu["api"])))
    losses = [(k, card["hist"][0][k], cpu["hist"][0][k]) for k in cpu["hist"][0]
              if k.endswith("loss")]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for _, a, b in losses)
    check(err <= F64_TOL and loss_rel <= F64_TOL,
          f"{name}: card against CPU in float64, params {err:.3g} of their scale, "
          f"losses {losses}")
    return {"params_of_scale": err, "loss_rel": loss_rel, "card_s": card["s"],
            "cpu_s": cpu["s"], "runs": runs}


def gan_run() -> dict:
    """(a): FedGAN through FedMLRunner."""
    import math

    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **GAN_RUN))
    dataset, dim = fedml.data.load(args)
    par = _f64_parity("(a) FedGAN", dict(GAN_RUN, comm_round=1),
                      _cut_shards(dataset, GAN_PARITY_IMAGES), dim, lambda api: api.model.params)
    par.pop("runs")
    run = _api_run(GAN_RUN, dataset, dim, DEV)
    hist = run["hist"]
    images = run["api"].generate(16)
    check(len(hist) == 2 and all(math.isfinite(m[k]) for m in hist for k in ("d_loss", "g_loss"))
          and images.shape == (16, 28, 28, 1) and abs(images).max() <= 1.0,
          f"(a) FedGAN: {hist}, images {images.shape}")
    res = {"parity_f64": par, "round_s": run["round_s"],
           "d_loss": [m["d_loss"] for m in hist], "g_loss": [m["g_loss"] for m in hist]}
    say(f"  (a) FedGAN: {res}")
    return res


def nas_run() -> dict:
    """(b): FedNAS through FedMLRunner."""
    import math

    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **NAS_RUN))
    dataset, dim = fedml.data.load(args)
    par = _f64_parity("(b) FedNAS", dict(NAS_RUN, client_num_in_total=2,
                                         batch_size=NAS_PARITY_BATCH),
                      _cut_shards(dataset, NAS_PARITY_IMAGES, NAS_PARITY_IMAGES, clients=2), dim,
                      lambda api: api.model.params)
    runs = par.pop("runs")
    genos = {w: runs[w]["api"].genotype() for w in runs}
    check(genos[DEV] == genos["cpu"], f"(b) FedNAS genotypes: {genos}")
    run = _api_run(NAS_RUN, dataset, dim, DEV)
    m = run["hist"][0]
    check(math.isfinite(m["weight_loss"]) and math.isfinite(m["arch_loss"]),
          f"(b) FedNAS: {m}")
    res = {"parity_f64": par, "parity_genotype": [list(g) for g in genos[DEV]],
           "round_s": run["round_s"], "test_acc": m["test_acc"],
           "weight_loss": m["weight_loss"], "arch_loss": m["arch_loss"],
           "genotype": [list(g) for g in run["api"].genotype()]}
    say(f"  (b) FedNAS: {res}")
    return res


def seg_run() -> dict:
    """(c): FedSeg through FedMLRunner, card against CPU in float32."""
    import math

    import torch

    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **SEG_RUN))
    dataset, dim = fedml.data.load(args)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
        runs = {where: _api_run(SEG_RUN, dataset, dim, where) for where in (DEV, "cpu")}
    card, cpu = runs[DEV], runs["cpu"]
    update = _rel(_cpu(card["api"].params), _cpu(cpu["api"].params), cpu["p0"])
    cm_diff = int((card["api"].last_confusion.cpu() - cpu["api"].last_confusion).abs().sum())
    hist = card["hist"]
    check(update <= SEG_UPDATE_TOL and cm_diff <= SEG_CM_PIXELS
          and all(math.isfinite(m["test_loss"]) for m in hist),
          f"(c) FedSeg: update {update:.3g} of the CPU's, confusion matrices {cm_diff} pixels "
          f"apart, {hist}")
    res = {"update_rel": update, "confusion_pixels_apart": cm_diff, "round_s": card["round_s"],
           "cpu_round_s": cpu["round_s"], "mIoU": [m["mIoU"] for m in hist],
           "pixel_acc": [m["pixel_acc"] for m in hist],
           "confusion": card["api"].last_confusion.cpu().tolist()}
    say(f"  (c) FedSeg: {res}")
    return res


def _dropout_off(model) -> None:
    """The text classifier's dropout sites at rate 0 (the parity round)."""
    for sub in model.module.modules():
        if hasattr(sub, "dropout_rate"):
            sub.dropout_rate = 0.0
        if hasattr(sub, "rate"):
            sub.rate = 0.0


def _card_cpu_round(tag: str, over: dict, dataset, dim: int) -> dict:
    """One FedAvg round on ``dataset`` (its shards cut to HUB_SHARD, the test
    set to HUB_TEST): card against CPU in float64 from the same seeded
    params, the first client's first batch's logits and the round's update
    within HUB_F64_TOL, then the round in float32 on the card, timed. The
    comparison runs without dropout (the card's and the CPU's generators
    draw different masks: the CNN's sites are calls of cnn.dropout, the text
    classifier's are rates, _dropout_off); the timed round keeps it."""
    import math

    import numpy as np
    import torch

    from fedml_tpu_torch.models import cnn

    dataset = _cut_shards(dataset, HUB_SHARD, HUB_TEST)
    f64 = _as_f64(dataset)
    x = torch.from_numpy(np.ascontiguousarray(f64[5][0].x[:HUB_FEDAVG["batch_size"]]))
    logits = {}

    def first_batch(where):
        def prepare(model):
            _dropout_off(model)
            with torch.no_grad():
                logits[where] = model.module(x.to(where)).cpu()
        return prepare

    keep, cnn.dropout = cnn.dropout, lambda x, rate, train, rng: x
    try:
        runs = {where: _api_run(over, f64, dim, where, f64=True, prepare=first_batch(where))
                for where in (DEV, "cpu")}
    finally:
        cnn.dropout = keep
    card, cpu = runs[DEV], runs["cpu"]
    check(all(torch.equal(card["p0"][k], cpu["p0"][k]) for k in cpu["p0"]),
          f"{tag}: the card and the CPU started from different params")
    logit_err = (logits[DEV] - logits["cpu"]).abs().max().item() / \
        logits["cpu"].abs().max().item()
    update = _rel(_cpu(card["api"].model_trainer.get_model_params()),
                  _cpu(cpu["api"].model_trainer.get_model_params()), cpu["p0"])
    timed = _api_run(over, dataset, dim, DEV)  # float32, dropout on
    m, mc, mt = card["hist"][0], cpu["hist"][0], timed["hist"][0]
    check(logit_err <= HUB_F64_TOL and update <= HUB_F64_TOL
          and math.isfinite(mt["test_loss"]),
          f"{tag}: in float64 logits {logit_err:.3g} of their scale, "
          f"update {update:.3g} of the CPU's; float32 {mt}")
    return {"params": timed["model"].num_params, "input_shape": list(timed["model"].input_shape),
            "train_examples": int(sum(dataset[4].values())),
            "f64_logits_of_scale": logit_err, "f64_update_rel": update,
            "f64_test_loss": m["test_loss"], "f64_cpu_test_loss": mc["test_loss"],
            "f64_card_s": card["s"], "f64_cpu_s": cpu["s"], "round_s": timed["round_s"],
            "test_loss": mt["test_loss"]}


def hub_round(name: str, dataset_name: str) -> dict:
    """(d): one FedAvg round of ``name`` on ``dataset_name``."""
    import fedml_tpu_torch as fedml

    over = dict(HUB_FEDAVG, model=name, dataset=dataset_name)
    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **over))
    t0 = time.perf_counter()
    dataset, dim = fedml.data.load(args)
    load_s = time.perf_counter() - t0
    over["input_shape"] = getattr(args, "input_shape", None)  # the table's width (R13)
    res = {**_card_cpu_round(f"(d) {name} on {dataset_name}", over, dataset, dim),
           "load_s": load_s}
    say(f"  (d) {name} on {dataset_name}: {res}")
    return res


def gan_nas_seg_hub_phase() -> dict:
    """Phase 19 (see the module docstring)."""
    import torch

    res = {"fedgan": gan_run(), "fednas": nas_run(), "fedseg": seg_run(), "hub": {}}
    for name, dataset_name in HUB_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        res["hub"][f"{name}/{dataset_name}"] = hub_round(name, dataset_name)
    return res


# -- phase 20: a user's own files: dataset readers, the data plane, HF llama ------------

# (a) each format written at its real widths, cut only in count: CIFAR-10
# python batches (5 of FILES_CIFAR_PER_BATCH 32x32x3 images, a test batch of
# as many), a fashion_mnist idx-ubyte drop (28x28), a LEAF femnist json
# (FILES_LEAF_WRITERS writers of 784 floats), with h5py a TFF
# fed_shakespeare h5 and the FedNLP 20news pair, with PIL a cinic10 image
# folder (10 classes of 32x32 png). Each loads twice through data_loader.load
# (the two bit-equal), then one sp FedAvg round of 2 clients on its model
# as phase 19 (d) runs one (_card_cpu_round).
FILES_RUNS = (("cifar10", "resnet20"), ("fashion_mnist", "lr"), ("femnist", "cnn"),
              ("fed_shakespeare", "rnn"), ("20news", "distilbert"), ("cinic10", "cnn"))
FILES_NEEDS = {"fed_shakespeare": "h5py", "20news": "h5py", "cinic10": "PIL"}
FILES_CIFAR_PER_BATCH, FILES_IDX_TRAIN, FILES_LEAF_WRITERS = 200, 600, 8
# (b) the C++ data plane: the CIFAR arrays tiled to STREAM_SAMPLES, streamed
# in batches of STREAM_BATCH for STREAM_EPOCHS epochs (the first 2 checked
# against a gather from the same files in the prefetcher's order)
STREAM_SAMPLES, STREAM_BATCH, STREAM_EPOCHS = 10_240, 128, 3  # whole batches: no tail
# (c) an HF llama checkpoint at Llama-2-7B's widths (BASELINE.md config 4),
# cut to HF_LAYERS layers, bf16 on disk; its logits on HF_LOGIT_TOKENS
# tokens on the card against the CPU in f32 (TF32 off) within HF_LOGITS_TOL
# of their scale (two f32 summation orders over K = 4096 and 11008); then
# HF_STEPS LoRA steps from dataset_path (bf16, seq 2048, batch 2, rank 8)
# and a greedy decode of HF_DECODE tokens through from_checkpoint
HF_LAYERS, HF_STEPS, HF_LOGIT_TOKENS, HF_DECODE = 1, 2, 16, 16
HF_LOGITS_TOL = 1e-4
HF_TOKENIZER_VOCAB = 512
HF_WORDS = ("federated", "silos", "train", "adapters", "on", "their", "own", "text", "and",
            "send", "only", "the", "low", "rank", "factors", "to", "a", "server", "that",
            "folds", "them", "into", "one", "global", "model", "each", "round")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _write_dataset_files(root: str, have: set) -> dict:
    """Each format's files under ``root`` (the cache dir); -> {dataset: the
    path its loader reads}."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(0)
    out = {}
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (FILES_CIFAR_PER_BATCH, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, FILES_CIFAR_PER_BATCH).tolist()}, f)
    out["cifar10"] = d
    d = os.path.join(root, "fashion_mnist")
    os.makedirs(d)
    for stem, arr in (("train-images-idx3-ubyte", rng.integers(0, 256, (FILES_IDX_TRAIN, 28, 28))),
                      ("train-labels-idx1-ubyte", rng.integers(0, 10, FILES_IDX_TRAIN)),
                      ("t10k-images-idx3-ubyte", rng.integers(0, 256, (100, 28, 28))),
                      ("t10k-labels-idx1-ubyte", rng.integers(0, 10, 100))):
        arr = np.asarray(arr, np.uint8)
        head = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
            int(n).to_bytes(4, "big") for n in arr.shape)
        with open(os.path.join(d, stem), "wb") as f:
            f.write(head + arr.tobytes())
    out["fashion_mnist"] = d
    d = os.path.join(root, "femnist")
    for split, n in (("train", 20), ("test", 5)):
        os.makedirs(os.path.join(d, split))
        users = {f"f_{i:04d}": {"x": np.round(rng.random((n, 784)), 4).tolist(),
                                "y": rng.integers(0, 62, n).tolist()}
                 for i in range(FILES_LEAF_WRITERS)}
        with open(os.path.join(d, split, "all_data_0.json"), "w") as f:
            json.dump({"users": list(users), "num_samples": [n] * len(users),
                       "user_data": users}, f)
    out["femnist"] = d
    text = " ".join(HF_WORDS)
    if "h5py" in have:
        import h5py

        d = os.path.join(root, "fed_shakespeare")
        os.makedirs(d)
        for split in ("train", "test"):
            with h5py.File(os.path.join(d, f"shakespeare_{split}.h5"), "w") as h5:
                for c in range(4):
                    snippets = [text[(c * 7 + j) % 40:] + " " + text for j in range(6)]
                    h5.create_dataset(f"examples/CLIENT_{c}/snippets",
                                      data=np.array([s.encode() for s in snippets], dtype="S300"))
        out["fed_shakespeare"] = d
        d = os.path.join(root, "20news")
        os.makedirs(d)
        labels = ["alt.atheism", "sci.space", "rec.autos", "comp.graphics"]
        n_train, n_test = 96, 32
        with h5py.File(os.path.join(d, "20news_data.h5"), "w") as f:
            f.create_dataset("attributes", data=json.dumps({"task_type": "text_classification"}))
            X, Y = f.create_group("X"), f.create_group("Y")
            for i in range(n_train + n_test):
                lab = labels[i % len(labels)]
                X.create_dataset(str(i), data=f"{lab.split('.')[-1]} {text} {i}".encode())
                Y.create_dataset(str(i), data=lab.encode())
        with h5py.File(os.path.join(d, "20news_partition.h5"), "w") as f:
            g = f.create_group("uniform")
            g.create_dataset("n_clients", data=2)
            pd = g.create_group("partition_data")
            for c in range(2):
                cg = pd.create_group(str(c))
                cg.create_dataset("train", data=np.arange(n_train)[c::2])
                cg.create_dataset("test", data=np.arange(n_train, n_train + n_test)[c::2])
        out["20news"] = d
    if "PIL" in have:
        from PIL import Image

        d = os.path.join(root, "cinic10")
        for split, n in (("train", 10), ("test", 2)):
            for c in range(10):
                cdir = os.path.join(d, split, f"class{c}")
                os.makedirs(cdir)
                for i in range(n):
                    Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                        os.path.join(cdir, f"img{i}.png"))
        out["cinic10"] = d
    return out


def _loads_equal(a, b) -> bool:
    import numpy as np

    same = a[0] == b[0] and a[1] == b[1] and a[4] == b[4] and a[7] == b[7]
    pairs = [(a[2], b[2]), (a[3], b[3])] + [(a[5][c], b[5][c]) for c in a[5]] + \
        [(a[6][c], b[6][c]) for c in a[6]]
    return same and sorted(a[5]) == sorted(b[5]) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        for p, q in pairs for x, y in ((p.x, q.x), (p.y, q.y)))


def files_round(dataset_name: str, model: str, cache: str, path: str) -> dict:
    """(a): the files of ``dataset_name`` through data_loader.load (twice),
    then one FedAvg round of ``model`` on them."""
    import fedml_tpu_torch as fedml

    over = dict(HUB_FEDAVG, model=model, dataset=dataset_name, data_cache_dir=cache)
    args = fedml.init(fedml.default_config("simulation", using_gpu=DEV == "cuda", **over))
    t0 = time.perf_counter()
    dataset, dim = fedml.data.load(args)
    load_s = time.perf_counter() - t0
    again, _ = fedml.data.load(fedml.init(fedml.default_config(
        "simulation", using_gpu=DEV == "cuda", **over)))
    check(_loads_equal(dataset, again), f"(a) {dataset_name}: two loads of the files differ")
    check(dataset[0] > 0 and len(dataset[5]) == 2, f"(a) {dataset_name}: {dataset[0]} examples")
    for k in ("input_shape", "vocab_size"):  # the loader's side effects, as in the JAX package
        if getattr(args, k, None) is not None:
            over[k] = getattr(args, k)
    mb = _dir_bytes(path) / 1e6
    res = {"model": model, "files_MB": mb, "load_s": load_s, "load_MB_per_s": mb / load_s,
           "output_dim": dim,
           **_card_cpu_round(f"(a) {model} on {dataset_name} files", over, dataset, dim)}
    say(f"  (a) {model} on {dataset_name} files: {res}")
    return res


def dataplane_run(x, y, tmp: str) -> dict:
    """(b): the C++ prefetcher over shards of the CIFAR arrays."""
    import numpy as np

    from fedml_tpu_torch.data import native_loader as nl
    from fedml_tpu_torch.data.dataset import ArrayDataset

    t0 = time.perf_counter()
    ok = nl.NativeBatchLoader.available()
    build_s = time.perf_counter() - t0
    check(ok, f"(b) the data plane did not build: {nl.build_error()}")
    reps = -(-STREAM_SAMPLES // len(x))
    ds = ArrayDataset(np.concatenate([x] * reps)[:STREAM_SAMPLES],
                      np.concatenate([y] * reps)[:STREAM_SAMPLES])
    t0 = time.perf_counter()
    paths = ds.save_shards(os.path.join(tmp, "cifar"))
    write_s = time.perf_counter() - t0
    n, bs = len(ds), STREAM_BATCH
    per_epoch = n // bs
    specs = [nl.shard_info(p) for p in paths]
    maps = [np.memmap(p, dtype=dt, mode="r", shape=dims, offset=16 + 8 * len(dims))
            for p, (dt, dims) in zip(paths, specs)]
    t0 = time.perf_counter()
    got = list(ArrayDataset.stream(paths, bs, seed=7, epochs=STREAM_EPOCHS))
    stream_s = time.perf_counter() - t0
    check(len(got) == STREAM_EPOCHS * per_epoch, f"(b) {len(got)} batches")
    for e in range(2):
        perm = nl.native_permutation(n, 7, e)
        for b in range(per_epoch):
            sel = perm[b * bs:(b + 1) * bs]
            bx, by = got[e * per_epoch + b]
            check(np.array_equal(bx, maps[0][sel]) and np.array_equal(by, maps[1][sel]),
                  f"(b) epoch {e} batch {b}: not the memmap's samples in the prefetcher's order")
    # the memmap path (the fallback without a toolchain) over the same files
    saved = nl._lib, nl._build_error
    nl._lib, nl._build_error = None, "the fallback, asked for"
    try:
        fb = list(ArrayDataset.stream(paths, bs, seed=7, epochs=1))
    finally:
        nl._lib, nl._build_error = saved
    def rows(batches):  # each sample as (its pixels' float64 sum, its label), sorted
        xs = np.concatenate([b[0] for b in batches]).reshape(n, -1).sum(axis=1, dtype=np.float64)
        return np.sort(xs + 1e6 * np.concatenate([b[1] for b in batches]))

    check(len(fb) == per_epoch and np.array_equal(rows(fb), rows(got[:per_epoch])),
          "(b) the memmap path's epoch holds other samples than the prefetcher's")
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    res = {"samples": n, "batch": bs, "epochs": STREAM_EPOCHS, "build_s": build_s,
           "shards_MB": mb, "write_s": write_s, "stream_s": stream_s,
           "batches_per_s": len(got) / stream_s, "MB_per_s": STREAM_EPOCHS * per_epoch * bs
           / n * mb / stream_s, "library": os.path.relpath(nl.lib_path(), ROOT)}
    say(f"  (b) data plane: {res}")
    return res


def hf_run(tmp: str, libs) -> dict:
    """(c): an HF llama checkpoint at Llama-2-7B's widths through
    model_name_or_path, dataset_path and from_checkpoint."""
    import dataclasses

    import numpy as np
    import torch

    from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.serving import LLMPredictor
    from fedml_tpu_torch.train.llm.checkpoint_import import (config_from_hf,
                                                             export_hf_checkpoint,
                                                             import_hf_checkpoint)
    from fedml_tpu_torch.train.llm.configurations import (DatasetArguments,
                                                          ExperimentArguments, ModelArguments)
    from fedml_tpu_torch.train.llm.llm_trainer import LLMTrainer
    from fedml_tpu_torch.train.llm.tokenizer import train_bpe

    cfg = TransformerConfig.llama2_7b(n_layers=HF_LAYERS, max_seq_len=T, dtype=torch.float32)
    ckpt, again = os.path.join(tmp, "llama"), os.path.join(tmp, "llama_again")
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    rng = np.random.default_rng(0)
    lines = [" ".join(HF_WORDS[i] for i in rng.integers(0, len(HF_WORDS), 24))
             for _ in range(1500)]
    with open(os.path.join(corpus, "silo.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    times, mark = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        times[what] = now - mark[0]
        mark[0] = now

    gen = torch.Generator(device=DEV).manual_seed(0)
    seeded = TransformerLM(cfg, device=DEV)
    seeded.reset_parameters(gen)
    params = params_to_jax(seeded)
    del seeded
    n_params = sum(v.size for v in _flat(params).values())
    lap("corpus_and_seeded_params")
    export_hf_checkpoint(params, cfg, ckpt, dtype=torch.bfloat16)
    lap("export")
    export_s = times["export"]
    train_bpe(lines, vocab_size=HF_TOKENIZER_VOCAB).save(os.path.join(ckpt, "tokenizer.json"))
    gb = os.path.getsize(os.path.join(ckpt, "model.safetensors")) / 1e9
    lap("tokenizer")
    imported = import_hf_checkpoint(ckpt)
    lap("import")
    import_s = times["import"]
    written, got = _flat(params), _flat(imported)
    check(written.keys() == got.keys(), "(c) the import's names differ from the export's")
    for k, v in written.items():  # compared as torch tensors: every core, not one
        check(got[k].dtype == np.float32 and torch.equal(
            torch.from_numpy(got[k]), torch.from_numpy(v).to(torch.bfloat16).float()),
            f"(c) imported {'/'.join(k)} differs from the written bf16 tensor")
    del params, written
    lap("import_check")
    export_hf_checkpoint(imported, config_from_hf(ckpt), again, dtype=torch.bfloat16)
    for name in ("model.safetensors", "config.json"):
        with open(os.path.join(ckpt, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            check(a.read() == b.read(), f"(c) re-exported {name} differs from the checkpoint's")
    shutil.rmtree(again)
    lap("reexport_and_compare")
    # the card's logits against the CPU's, f32, from the same import
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, HF_LOGIT_TOKENS)))
    state = params_from_jax(imported)
    logits = {}
    with torch.backends.cudnn.flags(allow_tf32=False):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for where in (DEV, "cpu"):
                m = TransformerLM(dataclasses.replace(cfg, attention_impl="xla", remat=False),
                                  device=where)
                m.load_state_dict(state)
                with torch.no_grad():
                    logits[where] = m(toks.to(where)).cpu()
                del m
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    logits_err = (logits[DEV] - logits["cpu"]).abs().max().item() / \
        logits["cpu"].abs().max().item()
    check(logits_err <= HF_LOGITS_TOL, f"(c) card logits {logits_err:.3g} of the CPU's scale")
    emb = torch.from_numpy(imported["embed"]["embedding"])
    del state, imported, logits
    gc.collect()
    lap("logits_card_and_cpu")
    # LoRA steps from the checkpoint and the corpus: the main path's kernels
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    trainer = LLMTrainer(
        ModelArguments(model_name_or_path=ckpt, seq_len=T, lora_rank=8, remat=True),
        DatasetArguments(dataset_path=corpus),
        ExperimentArguments(max_steps=HF_STEPS, per_device_batch_size=B, learning_rate=1e-4,
                            warmup_steps=1, output_dir=os.path.join(tmp, "trainer")),
        device=DEV)
    check(all(getattr(trainer.cfg, f) == getattr(cfg, f) for f in
              ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff")),
          f"(c) the trainer's geometry is not config.json's: {trainer.cfg}")
    metrics = trainer.train()  # builds the model: the import and overlay are in this lap
    lap("import_train_and_final_save")
    train_launches = dict(fa.launch_counts)
    by_design = {name: {d: n - by_design0[name][d] for d, n in libs.design_launches(name).items()
                        if n > by_design0[name][d]} for name in KERNELS}
    want = {"flash_fwd": 2 * HF_LAYERS * HF_STEPS, "flash_bwd_dq": HF_LAYERS * HF_STEPS,
            "flash_bwd_dkv": HF_LAYERS * HF_STEPS}
    check(train_launches == want, f"(c) flash launches {train_launches} != {want}")
    for name, (_, _, design) in KERNELS.items():
        check(by_design[name] == {design: want[name]},
              f"(c) {name}: launches by design {by_design[name]}, expected {design}")
    check(metrics["steps"] == HF_STEPS and np.isfinite(metrics["final_loss"]),
          f"(c) LoRA steps: {metrics}")
    check(torch.equal(trainer.model.embed.embedding.detach().cpu(), emb),
          "(c) the trained model's base embedding is not the checkpoint's")
    step_ms = B * T / metrics["tokens_per_sec"] * 1e3
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # serving the checkpoint: the decode path launches no flash kernel
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    pred = LLMPredictor.from_checkpoint(ckpt, device=DEV)
    load_pred_s = time.perf_counter() - t0
    lap("from_checkpoint")
    prompt = " ".join(HF_WORDS[:12])
    text = pred.predict({"prompt": prompt, "max_new_tokens": HF_DECODE})["text"]
    eos = pred._eos_id
    # timed without a stop token, so every request decodes all its tokens.
    # The decode loop runs to a multiple of 16 tokens (generation.generate),
    # so a token's ms is the difference of 2 * HF_DECODE and HF_DECODE tokens
    # over HF_DECODE, and the first token the HF_DECODE request less its
    # HF_DECODE - 1 later tokens
    pred._eos_id = None
    one_ms = _time_ms(lambda: pred.predict({"prompt": prompt, "max_new_tokens": HF_DECODE}), 3)
    two_ms = _time_ms(lambda: pred.predict({"prompt": prompt,
                                            "max_new_tokens": 2 * HF_DECODE}), 3)
    token_ms = (two_ms - one_ms) / HF_DECODE
    lap("decode")
    decode_launches = dict(fa.launch_counts)
    check(all(n == 0 for n in decode_launches.values()),
          f"(c) from_checkpoint's decode launched flash kernels: {decode_launches}")
    check(isinstance(text, str), "(c) from_checkpoint returned no text")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    res = {"layers": HF_LAYERS, "params": int(n_params), "checkpoint_GB": gb,
           "export_s": export_s, "export_GB_per_s": gb / export_s, "import_s": import_s,
           "import_GB_per_s": gb / import_s, "logits_of_scale": logits_err,
           "train": metrics, "step_ms": step_ms, "train_flash_launches": train_launches,
           "train_by_design": by_design, "from_checkpoint_s": load_pred_s,
           "first_token_ms": one_ms - (HF_DECODE - 1) * token_ms,
           "decode_ms_per_token": token_ms, "request_ms": {HF_DECODE: one_ms,
                                                            2 * HF_DECODE: two_ms},
           "times_s": times,
           "decode_flash_launches": decode_launches, "eos_id": eos, "decoded": text}
    say(f"  (c) HF import: {res}")
    return res


def files_phase(libs) -> dict:
    """Phase 20 (see the module docstring)."""
    import importlib.util

    import torch

    from fedml_tpu_torch.ops import flash_attention as fa

    have = {m for m in ("h5py", "PIL") if importlib.util.find_spec(m) is not None}
    runs = [(d, m) for d, m in FILES_RUNS if FILES_NEEDS.get(d, "numpy") in have | {"numpy"}]
    left = {d: f"{FILES_NEEDS[d]} is not installed" for d, m in FILES_RUNS
            if (d, m) not in runs}
    say(f"  formats on the card: {[d for d, _ in runs]}; left to the CPU tests: {left}")
    tmp = os.path.join(ROOT, ".smoke_run", "files")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        cache = os.path.join(tmp, "cache")
        t0 = time.perf_counter()
        paths = _write_dataset_files(cache, have)
        res = {"packages": sorted(have), "on_card": [d for d, _ in runs], "left_to_cpu": left,
               "write_s": time.perf_counter() - t0, "formats": {}}
        fa.reset_launch_counts()
        for dataset_name, model in runs:
            gc.collect()
            res["formats"][dataset_name] = files_round(dataset_name, model, cache,
                                                      paths[dataset_name])
        import fedml_tpu_torch as fedml

        args = fedml.default_config("simulation", dataset="cifar10", data_cache_dir=cache,
                                    client_num_in_total=2, using_gpu=False)
        cifar = fedml.data.load(args)[0][2]
        res["dataplane"] = dataplane_run(cifar.x, cifar.y, tmp)
        ab = dict(fa.launch_counts)
        check(all(n == 0 for n in ab.values()), f"(a), (b) launched flash kernels: {ab}")
        res["flash_launches_a_b"] = ab
        gc.collect()
        torch.cuda.empty_cache()
        res["hf"] = hf_run(tmp, libs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# -- phase 21: the serving front door --------------------------------------------------------

# (a) the int8 GEMM at Llama-2-7B's projection shapes, (K, N): q/k/v/o,
# gate/up, down, lm_head
INT8_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
INT8_MS = (1, 8, 16, 64, 128, 512)
INT8_NEW_MS = (16, 64, 128)  # short prompts' prefills: the library call gets INT8_LIB_ITERS_NEW
INT8_F32_CASES = ((8, 4096, 4096), (64, 4096, 4096))  # (M, K, N): gemv_warp, tiled_simt
# kernel against plain version, ||y - y_ref|| / ||y_ref|| over the output:
# bf16 outputs differ where the one cast of an f32 result rounds the other
# way after another summation order (at most one bf16 ulp, 2^-8 relative,
# an element, far less in norm); f32 outputs by summation order only
INT8_RTOL = {"bfloat16": 4e-3, "float32": 1e-5}
INT8_ITERS = 50
INT8_LIB_ITERS_NEW = 3  # torch._weight_int8pack_mm takes 19-146 ms a call at M=512
INT8_ROTATE_BYTES = 100e6  # weight copies cycled per timing: twice the 50 MB L2
INT8_ROW = (1, 4096, 11008)  # the kernels line's row: one decode step's gate/up projection
# (b) the no-copy gate: a B=1 decode step may allocate less than one bf16
# copy of the smallest projection (4096 x 4096 x 2 B)
NO_COPY_BYTES = 4096 * 4096 * 2
NO_COPY_CACHE = 512  # the cache length of that step (the attention's own scratch stays small)
# (c) the endpoint: the bench factory, deployed as a user deploys it
FRONT_SPEC = "fedml_tpu_torch.serving.bench_predictors:llm_bench_predictor"
FRONT_PROMPTS = ("federated benchmark serving", "endpoint throughput measure",
                 "serving endpoint", "measure federated throughput benchmark")
FRONT_MAX_NEW = 16
# the endpoint bench's batching (JAX's bench.py, _bench_llm_serving): each
# replica coalesces a 10 ms window of requests, up to 4, into one
# predict_many
FRONT_BATCH = {"FEDML_SERVE_MAX_BATCH": "4", "FEDML_SERVE_BATCH_WINDOW_MS": "10"}
# name -> (replicas, environment over the base). The flagship's 32000-entry
# head mostly emits ids past the bench tokenizer's 305, which decode to
# nothing, so its replies are held to the in-process predictor's beside a
# default-geometry endpoint (the tokenizer's vocab) whose texts must not be
# empty; that one serves each request through predict (no batching)
FRONT_ENDPOINTS = {
    "flagship": (2, {"FEDML_BENCH_FLAGSHIP": "1", **FRONT_BATCH}),
    "flagship_int8": (1, {"FEDML_BENCH_FLAGSHIP": "1", "FEDML_BENCH_INT8": "1", **FRONT_BATCH}),
    "default": (1, {"FEDML_SERVE_MAX_BATCH": "1"}),
}
# the load on the flagship's 2 replicas: the endpoint bench's 4 closed-loop
# clients, 64 requests, so that the p99 is a percentile of 64 latencies
FRONT_LOAD = dict(clients=4, requests_per_client=16)
FRONT_MEM_FRACTION = "0.1"


def device_ms(fn, iters: int = INT8_ITERS) -> float:
    """The device's ms a call: the mean over one window of ``iters``
    back-to-back calls, enqueued behind a sleep kernel so the host's launch
    cost is hidden (a decode-size call takes less time on the card than its
    launch takes on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 30 ms of cycles: the host queues the window meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_case(im, m: int, k: int, n: int, dtype, seed: int) -> dict:
    """One shape: the kernel against its plain version, then the times."""
    import itertools

    import torch

    from fedml_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    copies = max(1, int(-(-INT8_ROTATE_BYTES // (n * k))))
    ws = [(torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8),
           torch.rand(n, generator=g, device="cuda") * 1e-2 + 1e-4) for _ in range(copies)]
    wq, scale = ws[0]
    name = str(dtype).split(".")[-1]
    label = f"int8 GEMM M={m} K={k} N={n} {name}"
    libs = _build.kernels()
    d0 = libs.int8_design_launches()
    y = im.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    d1 = libs.int8_design_launches()
    ran = [d for d in d1 if d1[d] != d0[d]]
    design = im.design_for(m, dtype)
    check(ran == [design], f"{label}: launched {ran}, design_for names {design}")
    ref = im.int8_matmul_reference(x, wq, scale)
    check(bool(torch.isfinite(y).all().item()), f"{label}: not finite")
    rel = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
    check(rel <= INT8_RTOL[name], f"{label}: relative error {rel:.3g} > {INT8_RTOL[name]}")
    cyc = itertools.cycle(ws)
    ms = device_ms(lambda: im.int8_matmul(x, *next(cyc)))
    plain_ms = device_ms(lambda: im.int8_matmul_reference(x, *next(cyc)), 3)
    library, library_ms = "torch._weight_int8pack_mm", None
    lib_iters = INT8_ITERS if m <= 8 else INT8_LIB_ITERS_NEW if m in INT8_NEW_MS else 5
    try:
        lib_s = [(w, s.to(dtype)) for w, s in ws]
        cyc_l = itertools.cycle(lib_s)
        torch._weight_int8pack_mm(x, *lib_s[0])
        torch.cuda.synchronize()
        library_ms = device_ms(lambda: torch._weight_int8pack_mm(x, *next(cyc_l)), lib_iters)
    except (RuntimeError, NotImplementedError) as e:
        # no CUDA kernel for it in this torch: the bf16 product of the same
        # shape stands beside it, which is what bf16 decode pays
        library = f"torch.matmul on {name} weights (torch._weight_int8pack_mm raised: " \
                  f"{str(e).splitlines()[0][:120]})"
        wf = [w.to(dtype) for w, _ in ws[:max(1, int(-(-INT8_ROTATE_BYTES // (2 * n * k))))]]
        cyc_f = itertools.cycle(wf)
        library_ms = device_ms(lambda: torch.matmul(x, next(cyc_f).T))
    # what a bf16 (or f32) model pays for the same projection: F.linear on
    # weights already in x's dtype
    wd = [w.to(dtype) for w, _ in ws[:max(1, int(-(-INT8_ROTATE_BYTES // (2 * n * k))))]]
    cyc_d = itertools.cycle(wd)
    dense_ms = device_ms(lambda: torch.nn.functional.linear(x, next(cyc_d)))
    del wd
    esize = x.element_size()
    nbytes = n * k + m * k * esize + m * n * esize + n * 4  # wq, x, y, scale
    row = {"m": m, "k": k, "n": n, "dtype": name, "design": design, "rel_err": rel,
           "library_iters": lib_iters,
           "max_abs_err": (y.float() - ref.float()).abs().max().item(), "ms": ms,
           "plain_ms": plain_ms, **_bound(2.0 * m * n * k, nbytes, dtype),
           "library_ms": library_ms, "library": library, "weight_copies": copies,
           "dense_ms": dense_ms}
    row["share_of_bound"] = row["bound_ms"] / ms
    say(f"  {label} ({design}): rel {rel:.3g}, {ms * 1e3:.2f} us (bound {row['bound_ms'] * 1e3:.2f} us by "
        f"{row['bound_by']}, {row['share_of_bound']:.1%}), plain {plain_ms * 1e3:.1f} us, "
        f"library {library_ms * 1e3:.2f} us, dense {dense_ms * 1e3:.2f} us")
    return row


# projections of one Llama-2-7B layer by (K, N): q, k, v, o; gate, up; down
INT8_LAYER = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}


def int8_sweep(im) -> list:
    import torch

    rows = []
    for i, (k, n) in enumerate(INT8_SHAPES):
        for m in INT8_MS:
            rows.append(int8_case(im, m, k, n, torch.bfloat16, seed=100 + 10 * i + m))
    for m, k, n in INT8_F32_CASES:
        rows.append(int8_case(im, m, k, n, torch.float32, seed=7 + m))
    return rows


def int8_forward_gemm_ms(rows: list, m: int) -> dict:
    """The GEMMs of one SERVE_LAYERS-layer forward of M tokens (prefill
    logits for every position, as ``_prefill`` takes them), summed from the
    sweep's bf16 rows: the kernel, its plain version and F.linear on bf16
    weights."""
    by = {(r["k"], r["n"]): r for r in rows if r["m"] == m and r["dtype"] == "bfloat16"}
    counts = {**{kn: SERVE_LAYERS * c for kn, c in INT8_LAYER.items()}, (4096, 32000): 1}
    return {key: sum(c * by[kn][key] for kn, c in counts.items())
            for key in ("ms", "plain_ms", "dense_ms")}


def _state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _decode_step_extra_peak(model, cfg) -> float:
    """Bytes a B=1 decode step allocates beyond what lies on the card before
    it (a prompt prefilled into a NO_COPY_CACHE-long cache, then one step)."""
    import dataclasses

    import torch

    from fedml_tpu_torch.models.transformer import init_cache

    with torch.inference_mode():
        cache = init_cache(dataclasses.replace(cfg, max_seq_len=NO_COPY_CACHE), 1, DEV)
        toks = torch.arange(1, 65, device=DEV)[None]
        model(toks, torch.arange(64, device=DEV)[None], cache=cache)
        step = torch.tensor([[7]], device=DEV)
        pos = torch.tensor([[64]], device=DEV)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = model(step, pos, cache=cache)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out, cache
    return float(peak)


def int8_decode(im, libs) -> dict:
    """(b): in-process int8 decode at Llama-2-7B's widths, SERVE_LAYERS."""
    import dataclasses

    import torch

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.serving.quant import quantize_params_int8
    from fedml_tpu_torch.train.llm.generation import decode_model

    out = {}
    cfg, bf16 = _serve_model()
    state = bf16.state_dict()
    t0 = time.perf_counter()
    q_card = quantize_params_int8(state)
    torch.cuda.synchronize()
    out["quantize_card_s"] = time.perf_counter() - t0
    # the CPU quantizes layer 0 and lm_head: every projection shape, a
    # quarter of the time of the whole model
    t0 = time.perf_counter()
    q_cpu = quantize_params_int8({k: v.cpu() for k, v in state.items()
                                  if k.startswith(("layer_0.", "lm_head."))})
    out["quantize_cpu_s"] = time.perf_counter() - t0
    check(sum(name.endswith("kernel_q") for name in q_cpu) == 8,
          f"{len(q_cpu)} tensors of layer 0 and lm_head out of the CPU's quantization")
    for name, t in q_cpu.items():
        check(torch.equal(q_card[name].cpu(), t) and q_card[name].dtype == t.dtype,
              f"quantize_params_int8 on the card differs from the CPU's at {name}")
    n_q = sum(name.endswith("kernel_q") for name in q_card)
    check(n_q == 7 * cfg.n_layers + 1, f"{n_q} projections quantized")
    del q_cpu
    qcfg = dataclasses.replace(cfg, weight_quant="int8")
    int8 = decode_model(qcfg, q_card, device=DEV)
    del q_card
    out["resident_bytes"] = {"bf16": _state_bytes(bf16), "int8": _state_bytes(int8)}
    say(f"  quantized {n_q} projections on the card in {out['quantize_card_s']:.2f}s "
        f"(CPU, layer 0 and lm_head, {out['quantize_cpu_s']:.2f}s), bit-equal; resident weights "
        f"{out['resident_bytes']['int8'] / 1e9:.3f} GB int8 against "
        f"{out['resident_bytes']['bf16'] / 1e9:.3f} GB bf16")

    im.reset_launch_counts()
    fa.reset_launch_counts()
    designs0 = libs.int8_design_launches()
    # the design and rows M of every call in (b): a Python call and a dict
    # update a projection, under a microsecond of a token's milliseconds
    by_rows = {}
    wrapper = im.int8_matmul

    def tallied(x, wq, scale, **kw):
        m = x.numel() // x.shape[-1]
        key = f"{im.design_for(m, x.dtype)} M={m}"
        by_rows[key] = by_rows.get(key, 0) + 1
        return wrapper(x, wq, scale, **kw)

    im.int8_matmul = tallied
    try:
        _int8_decode_runs(im, out, cfg, qcfg, int8, bf16)
    finally:
        im.int8_matmul = wrapper
    out["launches_by_design_and_rows"] = dict(sorted(by_rows.items()))
    say(f"  int8 calls in (b) by design and rows: {out['launches_by_design_and_rows']}")
    out["launches"] = dict(im.launch_counts)
    check(sum(by_rows.values()) == out["launches"]["int8_gemm"],
          f"{sum(by_rows.values())} calls tallied, {out['launches']} launched")
    # each launch's design, as the C entry point counted it: decode rows
    # (M <= 8) and the prefills (M = B x the prompt's bucket)
    designs1 = libs.int8_design_launches()
    out["design_launches"] = {d: designs1[d] - designs0[d] for d in designs1}
    say(f"  int8 launches in (b) by design: {out['design_launches']}")
    check(sum(out["design_launches"].values()) == out["launches"]["int8_gemm"],
          f"the designs' launches {out['design_launches']} do not add up to the wrapper's "
          f"{out['launches']}")
    # each launch on the design design_for names for its rows: the wrapper's
    # tally by that rule against the C entry point's own counters
    check(out["design_launches"] == im.design_counts,
          f"launches by design {out['design_launches']}, design_for's {im.design_counts}")
    check(out["design_launches"]["tiled_simt"] == 0,
          f"a bf16 prefill launched tiled_simt: {out['design_launches']}")
    prefill = out["design_launches"]["sm90_wgmma_tma"]
    decode = out["design_launches"][im.design_for(im.GEMV_MAX_M, torch.bfloat16)]
    check(prefill > 0 and decode > 0,
          f"(b) ran {prefill} wgmma prefills and {decode} mma.sync decodes")
    out["flash_launches"] = dict(fa.launch_counts)
    check(out["launches"]["int8_gemm"] > 0, "the int8 kernel never launched in (b)")
    check(all(n == 0 for n in out["flash_launches"].values()),
          f"int8 decode launched flash kernels: {out['flash_launches']}")
    del int8, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _int8_decode_runs(im, out: dict, cfg, qcfg, int8, bf16) -> None:
    """(b)'s int8 work: the first token against the plain int8 path, the
    no-copy gate, ms a decoded token int8 against bf16."""
    import torch

    from fedml_tpu_torch.train.llm.generation import generate_batch

    g = torch.Generator(device=DEV).manual_seed(SERVE_SEED + 21)
    prompt = torch.randint(0, cfg.vocab_size, (2, 48), generator=g, device=DEV)
    with torch.inference_mode():
        logits = int8(prompt)[:, -1]
        torch.cuda.synchronize()
        per_forward = im.launch_counts["int8_gemm"]
        kernel = im.int8_matmul
        # the plain int8 path, on the card
        im.int8_matmul = lambda x, wq, scale, **_: im.int8_matmul_reference(x, wq, scale)
        try:
            plain = int8(prompt)[:, -1]
        finally:
            im.int8_matmul = kernel
    rel = _row_rel(logits, plain)
    out["first_token_vs_plain_worst_rel"] = rel.max().item()
    say(f"  first token's logits against the plain int8 path: worst row "
        f"{out['first_token_vs_plain_worst_rel']:.3g} (rtol {KEY_RTOL}); "
        f"{per_forward} int8 launches a forward")
    check(bool((rel <= KEY_RTOL).all().item()),
          f"int8 logits {rel.max().item():.3g} from the plain int8 path's")
    check(per_forward == 7 * cfg.n_layers + 1,
          f"{per_forward} int8 launches a forward, not one a projection")

    out["decode_step_extra_peak_bytes"] = {"int8": _decode_step_extra_peak(int8, qcfg),
                                           "bf16": _decode_step_extra_peak(bf16, cfg)}
    say(f"  B=1 decode step's extra peak: int8 {out['decode_step_extra_peak_bytes']['int8'] / 1e6:.2f}"
        f" MB, bf16 {out['decode_step_extra_peak_bytes']['bf16'] / 1e6:.2f} MB "
        f"(gate: int8 below {NO_COPY_BYTES / 1e6:.1f} MB)")
    check(out["decode_step_extra_peak_bytes"]["int8"] < NO_COPY_BYTES,
          "an int8 decode step allocated a widened copy's worth of memory")

    tok_ids = [list(range(3 + i, 40 + 3 * i)) for i in range(8)]
    ms_tok = {}
    for name, model, c in (("int8", int8, qcfg), ("bf16", bf16, cfg)):
        for b in (1, 8):
            prompts = tok_ids[:b]
            t16 = _time_ms(lambda: generate_batch(model, c, prompts, 16, device=DEV), 2)
            t48 = _time_ms(lambda: generate_batch(model, c, prompts, 48, device=DEV), 2)
            ms_tok[f"{name}_b{b}"] = (t48 - t16) / 32
    out["decode_ms_per_token"] = ms_tok
    say(f"  ms a decoded token (generate_batch): {ms_tok}")


def _prom_samples(text: str) -> dict:
    """Prometheus 0.0.4 text -> {name{labels}: value}; fails on a sample
    whose family no TYPE line declared before it."""
    typed, out = set(), {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        base = next((name[:-len(s)] for s in ("_bucket", "_sum", "_count")
                     if name.endswith(s) and name[:-len(s)] in typed), name)
        check(base in typed, f"/metrics sample of an undeclared family: {line!r}")
        out[key] = float(value)
    return out


def _http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _front_env(**over):
    """os.environ with ``over`` set (None removes), restored on exit."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        saved = {k: os.environ.get(k) for k in over}
        for k, v in over.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return scope()


def _dir_mtimes(path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in path.iterdir()} if path.is_dir() else {}


def _front_envs(tmp: str) -> dict:
    """Each endpoint's environment: this process's without the bench's and
    the replicas' knobs, then the endpoint's own."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("FEDML_BENCH_", "FEDML_SERVE_", "FEDML_REPLICA_"))}
    base.update(FEDML_REPLICA_MEM_FRACTION=FRONT_MEM_FRACTION,
                FEDML_FR_DIR=os.path.join(tmp, "crash"))
    return {name: {**base, **over} for name, (_, over) in FRONT_ENDPOINTS.items()}


def _front_references(envs: dict) -> dict:
    """The in-process LLMPredictor of each endpoint's seed and geometry, and
    its replies to FRONT_PROMPTS one at a time: through ``predict`` where
    the endpoint serves without batching, else through ``predict_many`` of
    the one request (what a replica's micro-batcher calls for a lone
    request)."""
    import torch

    from fedml_tpu_torch.serving.bench_predictors import llm_bench_predictor

    want = {}
    for name, env in envs.items():
        knobs = ("FEDML_BENCH_", "FEDML_SERVE_")
        over = {k: None for k in os.environ if k.startswith(knobs)}
        over.update({k: v for k, v in env.items() if k.startswith(knobs)})
        with _front_env(**over):
            ref = llm_bench_predictor()
        batched = env.get("FEDML_SERVE_MAX_BATCH", "1") != "1"
        reqs = [{"prompt": p, "max_new_tokens": FRONT_MAX_NEW} for p in FRONT_PROMPTS]
        want[name] = [ref.predict_many([r])[0] if batched else ref.predict(r) for r in reqs]
        del ref
    gc.collect()
    torch.cuda.empty_cache()
    return want


def _post_json(url: str, payload: dict, timeout: float = 120.0) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _front_load(gw) -> dict:
    """FRONT_LOAD's closed-loop clients through the gateway: requests/s and
    the latency percentiles."""
    import threading

    import numpy as np

    lat, fails = [], []

    def client(c):
        for r in range(FRONT_LOAD["requests_per_client"]):
            t0 = time.perf_counter()
            try:
                out = gw.predict({"prompt": f"measure endpoint run {c} req {r}",
                                  "max_new_tokens": FRONT_MAX_NEW}, timeout_s=120.0)
                check("text" in out, f"a reply without text: {out}")
                lat.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - counted and failed on below
                fails.append(repr(e))

    gw.reset_window()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(FRONT_LOAD["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not fails and not any(t.is_alive() for t in threads), f"load requests failed: {fails}")
    lat_ms = np.asarray(lat) * 1e3
    return {**FRONT_LOAD, "max_new_tokens": FRONT_MAX_NEW, "requests": len(lat),
            "wall_s": wall, "requests_per_s": len(lat) / wall,
            "tokens_per_s": len(lat) * FRONT_MAX_NEW / wall,
            **{f"p{q}_ms": float(np.percentile(lat_ms, q)) for q in (50, 90, 99)},
            "max_ms": float(lat_ms.max()), "gateway_qps": gw.signals()["qps"]}


def _deploy_side_by_side(mgr, envs: dict) -> tuple:
    """deploy_isolated of every endpoint at once, each in its environment;
    -> ({name: gateway}, {name: spawn-to-ready s}, the in-process replies,
    computed meanwhile)."""
    import threading

    deployed, spawn_s, errors = {}, {}, {}

    def deploy(name):
        t0 = time.perf_counter()
        try:
            deployed[name] = mgr.deploy_isolated(name, FRONT_SPEC, FRONT_ENDPOINTS[name][0],
                                                 env=envs[name])
            spawn_s[name] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - raised below, after every thread ended
            errors[name] = e

    threads = [threading.Thread(target=deploy, args=(name,)) for name in FRONT_ENDPOINTS]
    for t in threads:
        t.start()
    try:
        want = _front_references(envs)
    finally:
        for t in threads:
            t.join()
    for name, e in errors.items():
        raise SmokeFailure(f"deploy_isolated({name!r}) failed: {e!r}") from e
    return deployed, spawn_s, want


def endpoint_run(tmp: str) -> dict:
    """(c): deploy_isolated of the bench factory: 2 flagship bf16 replicas,
    1 flagship int8 replica and 1 default-geometry replica, all on the card."""
    import signal

    from fedml_tpu_torch.core.telemetry import statusz
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.serving.endpoint import EndpointManager
    from fedml_tpu_torch.serving.replica_controller import AutoScaler

    out = {}
    envs = _front_envs(tmp)
    libs_before = _dir_mtimes(_build.BUILD_DIR)
    mgr = EndpointManager()
    try:
        deployed, spawn_s, want = _deploy_side_by_side(mgr, envs)
        out["spawn_to_ready_s"] = spawn_s
        say(f"  deploy_isolated of the three endpoints side by side, spawn-to-ready: {spawn_s} s")
        # every reply, from every replica, equals the in-process predictor's
        for name, g in deployed.items():
            got = [g.predict({"prompt": p, "max_new_tokens": FRONT_MAX_NEW}) for p in FRONT_PROMPTS]
            check(got == want[name], f"{name}: the replicas' replies differ from the in-process "
                                     f"LLMPredictor's: {got} != {want[name]}")
            for r in g.replica_set.healthy():
                check(_post_json(r.url + "/predict", {"prompt": FRONT_PROMPTS[0],
                                                      "max_new_tokens": FRONT_MAX_NEW})
                      == want[name][0], f"{name}: replica {r.id} answers otherwise")
        check(all(w["text"] for w in want["default"]),
              f"a default-geometry text is empty: {want['default']}")
        out["text_chars"] = {name: [len(w["text"]) for w in ws] for name, ws in want.items()}
        say(f"  replies equal to the in-process LLMPredictor's ({len(FRONT_PROMPTS)} prompts an "
            f"endpoint, {FRONT_MAX_NEW} tokens; predict_many of one request where the replica "
            f"batches, predict where not); characters of text: {out['text_chars']}")
        gw, gw8 = deployed["flagship"], deployed["flagship_int8"]

        # load through the gateway at the bench's batching: requests/s and latency
        out["load"] = _front_load(gw)
        say(f"  load through the gateway (2 flagship bf16 replicas): {out['load']}")
        batches = {}
        for r in gw.replica_set.healthy():
            doc = json.loads(_http_get(r.url + "/statusz"))
            batches[r.id] = doc["batching"]["recent_batch_sizes"]
        out["recent_batch_sizes"] = batches
        say(f"  the replicas' last batches under that load: {batches}")
        check(max(max(b) for b in batches.values()) >= 2,
              f"no replica coalesced requests under the load: {batches}")

        # the telemetry the processes expose
        gw.replica_set.register_statusz()
        server = statusz.StatuszServer(
            port=0, service="gateway",
            gauges_fn=lambda: gw.prom_gauges() + gw.replica_set.prom_gauges())
        server.start()
        try:
            doc = json.loads(_http_get(f"http://127.0.0.1:{server.port}/statusz"))
            check(doc["sections"]["replicas"]["desired"] == 2
                  and len(doc["sections"]["replicas"]["replicas"]) == 2,
                  f"/statusz replicas section: {doc['sections'].get('replicas')}")
            gw_samples = _prom_samples(_http_get(f"http://127.0.0.1:{server.port}/metrics"))
        finally:
            server.stop()
        for key in ('fedml_serving_replicas{state="ready"}', "fedml_serving_gateway_qps",
                    "fedml_serving_request_seconds_count"):
            check(key in gw_samples, f"the gateway's /metrics lacks {key}")
        check(gw_samples['fedml_serving_replicas{state="ready"}'] == 2.0, "2 ready replicas")
        replica_metrics = {}
        for name, g in deployed.items():
            for r in g.replica_set.healthy():
                samples = _prom_samples(_http_get(r.url + "/metrics"))
                check(samples.get("fedml_predictor_ready") == 1.0
                      and 'fedml_alert_active{slo="ttft_p99_seconds"}' in samples,
                      f"{name} replica {r.id}: /metrics lacks the serving families")
                check(("fedml_serving_last_batch_size" in samples)
                      == (FRONT_ENDPOINTS[name][1].get("FEDML_SERVE_MAX_BATCH") != "1"),
                      f"{name} replica {r.id}: the batch-size gauge does not match its batching")
                doc = json.loads(_http_get(r.url + "/statusz"))
                check(doc["service"] == "inference_runner" and doc["flight_recorder"]["installed"],
                      f"{name} replica {r.id}: /statusz {doc}")
                replica_metrics[r.id] = {
                    "endpoint": name, "int8_gemm_launches": samples.get(
                        "fedml_ops_int8_gemm_launches_total", 0.0),
                    "last_batch_size": samples.get("fedml_serving_last_batch_size"),
                    "alerts_firing": sum(v for k, v in samples.items()
                                         if k.startswith("fedml_alert_active"))}
        out["replica_metrics"] = replica_metrics
        say(f"  replicas' /metrics: {replica_metrics}")
        for rid, row in replica_metrics.items():
            check((row["int8_gemm_launches"] > 0) == (row["endpoint"] == "flagship_int8"),
                  f"replica {rid} ({row['endpoint']}): {row['int8_gemm_launches']} int8 launches")
        # the children loaded the kernels the parent had built: none rebuilt
        # one (they run with NO_BUILD_ENV, under which a missing library raises)
        check(_dir_mtimes(_build.BUILD_DIR) == libs_before, "a replica child wrote into the kernels' build directory")

        # a replica dies: every request is still answered, the corpse evicted
        victim = gw.replica_set.healthy()[0]
        os.kill(victim.proc.pid, signal.SIGKILL)
        victim.proc.wait(timeout=30)
        got = [gw.predict({"prompt": p, "max_new_tokens": FRONT_MAX_NEW}) for p in FRONT_PROMPTS]
        check(got == want["flagship"], "replies after the SIGKILL differ")
        t0 = time.perf_counter()
        gw.replica_set.reconcile()
        out["respawn_s"] = time.perf_counter() - t0
        check(victim not in gw.replica_set.replicas and len(gw.replica_set.healthy()) == 2,
              "the killed replica was not evicted and replaced")
        got = [gw.predict({"prompt": p, "max_new_tokens": FRONT_MAX_NEW}) for p in FRONT_PROMPTS]
        check(got == want["flagship"], "replies after the replacement differ")
        say(f"  SIGKILL of replica {victim.id}: every request answered, corpse evicted, "
            f"replacement ready in {out['respawn_s']:.1f}s")

        # one autoscaler tick maps the observed QPS to a count
        gw.reset_window()
        for p in FRONT_PROMPTS:
            gw.predict({"prompt": p, "max_new_tokens": 4})
        qps = gw.signals()["qps"]
        scaler = AutoScaler(gw, target_qps_per_replica=qps / 1.5, min_replicas=1, max_replicas=2,
                            cooldown_s=0.0)
        want_n = scaler.desired_replicas()
        got_n = scaler.tick()
        out["autoscaler"] = {"observed_qps": qps, "target_qps_per_replica": qps / 1.5,
                             "desired": want_n, "after_tick": got_n}
        say(f"  AutoScaler.tick: {out['autoscaler']}")
        check(want_n == got_n == 2, f"the autoscaler tick gave {got_n}, its policy {want_n}")
    finally:
        gateways = list(mgr.endpoints.values())
        children = [r for g in gateways for r in g.replica_set.replicas]
        for name in list(mgr.endpoints):
            mgr.undeploy(name)
        for r in children:
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait(timeout=30)
    check(all(r.proc.poll() is not None for r in children), "a replica child outlived the phase")
    out["children_reaped"] = len(children)
    return out


def front_door_phase(libs) -> dict:
    """Phase 21: the int8 GEMM, in-process int8 decode, the endpoint."""
    import torch

    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import int8_matmul as im

    # registers, spills and shared memory of each instance (phase 2 prints them)
    res = {"int8_ptxas": [line for line in _build.ptxas_report()
                          if line.startswith(("gemv", "tiled", "wgmma_kernel"))]}
    t0 = time.time()
    say("  (a) the int8 GEMM against its plain version")
    res["int8_gemm"] = int8_sweep(im)
    res["int8_gemm_s"] = time.time() - t0
    res["forward_gemm_ms"] = {f"m{m}": int8_forward_gemm_ms(res["int8_gemm"], m) for m in INT8_MS}
    say(f"  the GEMMs of one {SERVE_LAYERS}-layer forward (int8 kernel, plain, bf16 F.linear), "
        f"ms: {res['forward_gemm_ms']}")
    res["int8_designs_after_sweep"] = libs.int8_design_launches()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    say(f"  (b) in-process int8 decode at Llama-2-7B's widths, {SERVE_LAYERS} layers")
    res["decode"] = int8_decode(im, libs)
    res["decode_s"] = time.time() - t0
    tmp = os.path.join(ROOT, ".smoke_run", "front_door")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    t0 = time.time()
    say("  (c) the endpoint: deploy_isolated of the bench factory, 2 flagship bf16 replicas, "
        "1 flagship int8 replica, 1 default-geometry replica")
    fa.reset_launch_counts()
    try:
        res["endpoint"] = endpoint_run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["endpoint_s"] = time.time() - t0
    res["endpoint_parent_flash_launches"] = dict(fa.launch_counts)
    check(all(n == 0 for n in fa.launch_counts.values()),
          f"the endpoint phase launched flash kernels: {fa.launch_counts}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs one CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fedml_tpu_torch", "ops", "csrc")):
        print("chip_smoke: run from a checkout of the repository (fedml_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import flash_attention as fa

    t_start = time.time()
    say("== 1. device")
    card = card_line()
    say(f"  {card}; torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    say("== 2. build")
    t0 = time.time()
    _build.kernels()
    say(f"  built with nvcc (one process per source) in {time.time() - t0:.1f}s")
    report = _build.ptxas_report()
    for line in report:
        say(f"  ptxas: {line}")
    sm90 = [line for line in report if "_sm90<" in line]
    check(len(sm90) == WGMMA_INSTANCES * len(KERNELS),
          f"expected {WGMMA_INSTANCES} wgmma instances per kernel: {sm90}")
    check(all("spill stores 0 B, loads 0 B" in line for line in sm90), "a wgmma kernel spills")
    # the int8 GEMM's tensor-core designs (gemv_mma, sm90_wgmma_tma)
    int8_tc = [line for line in report if line.startswith(("gemv_mma_kernel", "wgmma_kernel"))]
    check(len(int8_tc) >= 2, f"the int8 GEMM's tensor-core instances are missing: {int8_tc}")
    check(all("spill stores 0 B, loads 0 B" in line for line in int8_tc),
          "an int8 tensor-core kernel spills")
    notes = _build.ptxas_notes()
    check(not notes, f"ptxas performance advisories: {notes}")

    say("== 3. kernels against their plain versions")
    t0 = time.time()
    bf16, f32 = torch.bfloat16, torch.float32
    errs = kernel_case(fa, B, T, HQ, HQ, D, True, bf16)  # the main path's shape
    kernel_case(fa, B, T, HQ, HQ, D, False, bf16)
    kernel_case(fa, B, T, HQ, 8, D, True, bf16)       # GQA
    kernel_case(fa, B, 2000, HQ, HQ, D, True, bf16)   # ragged T
    kernel_case(fa, B, T, HQ, HQ, D, True, f32)
    say(f"  every compiled instance: {instance_sweep(fa)} cases passed")
    timing = time_kernels(fa, B, T, HQ, HQ, D, bf16)
    for name, row in timing.items():
        say(f"  {name}: " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in row.items()))
    say(f"  K2+K3 {timing['flash_bwd_dq']['ms'] + timing['flash_bwd_dkv']['ms']:.4g} ms, "
        f"SDPA's backward (dQ+dK+dV) {timing['flash_bwd_dq']['library_ms']:.4g} ms")
    gqa = time_bwd_gqa(fa, B, T, HQ, 8, D, bf16)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        say(f"  {name} at Hq={HQ} Hkv=8: " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in gqa[name].items()))
    say(f"  K2+K3 at Hq={HQ} Hkv=8 {gqa['k2_plus_k3_ms']:.4g} ms, SDPA's backward with "
        f"enable_gqa {gqa['sdpa_bwd_ms']:.4g} ms")
    # phase 22's attention shapes: each kernel against its plain version and timed
    head_errs, head_timing = {}, {}
    for label, geom in (("d96", PHI3), ("d256", GEMMA2B)):
        hq, hkv, d = geom["n_heads"], geom["n_kv_heads"], geom["d_model"] // geom["n_heads"]
        head_errs[label] = kernel_case(fa, B, T, hq, hkv, d, True, bf16)
        head_timing[label] = time_kernels(fa, B, T, hq, hkv, d, bf16)
        for name, row in head_timing[label].items():
            say(f"  {name} at Hq={hq} Hkv={hkv} D={d}: " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    say(f"  phase {time.time() - t0:.1f}s")

    tmp = os.path.join(ROOT, ".smoke_run")
    shutil.rmtree(tmp, ignore_errors=True)
    libs = _build.kernels()

    def lora_main_path():
        say("== 4. train step (LLMTrainer.train)")
        trained = train_phase(tmp)
        say("== 5. client round (LLMClientTrainer)")
        client_phase(tmp, trained["adapters"])

    t0 = time.time()
    try:
        _, launches, by_design = _launched(fa, libs, lora_main_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  phases 4-5 {time.time() - t0:.1f}s; launches on the main path: {launches}; "
        f"by design (the C entry points' counts): {by_design}")
    # per step and layer: the forward, its recompute under remat, one dQ, one
    # dK/dV; the main path is bf16, so every launch on the wgmma design
    _check_launches("phases 4-5", launches, by_design, N_LAYERS, TRAIN_STEPS + ROUND_STEPS, 2,
                    "sm90_wgmma_tma")

    say(f"== 6. serve (Llama-2-7B's widths, {SERVE_LAYERS} of its 32 layers, bf16, "
        "max_seq_len 4096)")
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    serve = serve_phase()
    serve_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the serve phase: {serve_launches}")
    # decode runs the plain masked attention (generation.decode_model forces
    # attention_impl="xla", as the JAX package does): no kernel launches here
    check(all(n == 0 for n in serve_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the serve phase launched flash kernels: {serve_launches}")

    say("== 7. FedAvg round (sp simulator: Parrot config 1, ResNet-56 x 16 clients)")
    # the phase is host-bound: start it without the serving phase's garbage
    # and cached blocks
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    fedavg = fedavg_phase()
    fedavg_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the FedAvg phase: {fedavg_launches}")
    # the FedAvg path runs convolutions, GroupNorm, GEMMs and the fold: no
    # TPU kernel has a counterpart on it, so no flash kernel may launch
    check(all(n == 0 for n in fedavg_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the FedAvg phase launched flash kernels: {fedavg_launches}")

    say("== 8. vmapped FedAvg round (backend vmap: ResNet-56 x 16 clients)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    fedavg["vmap"] = vmap_phase()
    vmap_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the vmapped phase: {vmap_launches}")
    check(all(n == 0 for n in vmap_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the vmapped phase launched flash kernels: {vmap_launches}")

    say("== 9. algorithm zoo (FedNova, SCAFFOLD, FedDyn, Mime at Parrot config 1's shape)")
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    fedavg["zoo"] = zoo_phase()
    zoo_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the zoo phase: {zoo_launches}")
    check(all(n == 0 for n in zoo_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the zoo phase launched flash kernels: {zoo_launches}")

    say("== 10. cross-silo front (Octopus): ResNet-56 x 16 silos over INMEMORY, 4 silo "
        "processes over MQTT_S3")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    cross_silo = cross_silo_phase(fedavg["resnet56"])
    cs_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the cross-silo phase: {cs_launches}")
    # in this process: the parity gate, the timed federation and the wire
    # checks (the party processes import the same code and run no attention)
    check(all(n == 0 for n in cs_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the cross-silo phase launched flash kernels: {cs_launches}")

    say("== 11. async federation (FedBuff) and the compressed uplink: ResNet-56 x 16 (the "
        "compressed uplink at ResNet-20)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    asyncfed = async_phase()
    async_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the async phase: {async_launches}")
    # async folds, compression and ResNet training run no attention
    check(all(n == 0 for n in async_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the async phase launched flash kernels: {async_launches}")

    say("== 12. resilience: a 16-silo quorum federation, the sp, cross-silo and async SIGKILL "
        "drills (ResNet-56)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    resilience = resilience_phase()
    res_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the resilience phase: {res_launches}")
    # (e) checkpoints, quorum folds and ResNet training run no attention (the
    # drill processes import the same code and count their own)
    check(all(n == 0 for n in res_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the resilience phase launched flash kernels: {res_launches}")

    say("== 13. privacy: windowed SecAgg, the dropout drill, DP (sync, async, secagg+dp), the "
        "masked topk uplink (ResNet-20 x 16 silos)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    privacy = privacy_phase()
    priv_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the privacy phase: {priv_launches}")
    # (e) masking, the ring fold, unmasking, DP noise and ResNet training run
    # no attention
    check(all(n == 0 for n in priv_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the privacy phase launched flash kernels: {priv_launches}")

    say("== 14. secure aggregation fronts: SecAgg and LightSecAgg, ResNet-20 x 16 silos")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    secure = secure_phase()
    secure_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the secure phase: {secure_launches}")
    # (c) quantization, the field sums and products, and ResNet training run
    # no attention
    check(all(n == 0 for n in secure_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the secure phase launched flash kernels: {secure_launches}")

    say("== 15. hierarchy: the edge->regional->root tree and tier-masked SecAgg, ResNet-56")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    hierarchy = hierarchy_phase(asyncfed["fleet"])
    hier_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the hierarchy phase: "
        f"{hier_launches}")
    # (c) folds, host masks and sketches run no attention
    check(all(n == 0 for n in hier_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the hierarchy phase launched flash kernels: {hier_launches}")

    say("== 16. the message plane's other backends: TRPC and MQTT_WEB3 across processes, GRPC "
        "and MPI, the reference wire (ResNet-20), comm_bench (ResNet-56's state dict)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    message_plane = message_plane_phase()
    mp_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the message-plane phase: "
        f"{mp_launches}")
    # (f) transports, codecs and ResNet training run no attention (the party
    # processes import the same code and count their own)
    check(all(n == 0 for n in mp_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the message-plane phase launched flash kernels: {mp_launches}")

    say("== 17. the trust middleware: every defense's fold, attacks, DP, the vmapped and "
        "cross-silo fronts, contribution, gradient inversion (ResNet-20)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    trust = trust_phase()
    trust_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the trust phase: {trust_launches}")
    # (h) robust statistics, noise draws, ResNet training and the inversion
    # attacks run no attention
    check(all(n == 0 for n in trust_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the trust phase launched flash kernels: {trust_launches}")

    say("== 18. FHE's ciphertext leaves (rlwe on the sp and cross-silo fronts) and the sp "
        "simulator's other APIs (TA, FedAvg_seq, split NN, FedGKT, decentralized, vertical FL)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    fhe_zoo = fhe_sp_zoo_phase(fedavg)
    fhe_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the FHE and sp-zoo phase: "
        f"{fhe_launches}")
    # (i) ring products, folds, the split models and the decentralized and
    # vertical learners run no attention
    check(all(n == 0 for n in fhe_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the FHE and sp-zoo phase launched flash kernels: {fhe_launches}")

    say("== 19. FedGAN, FedNAS and FedSeg, and one FedAvg round of each remaining hub model "
        "(MobileNet v1/v3, EfficientNet-lite, the LSTMs, the text classifier, LR on "
        "stackoverflow_lr and lending_club)")
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    by_design0 = {name: libs.design_launches(name) for name in KERNELS}
    t0 = time.time()
    hub = gan_nas_seg_hub_phase()
    hub_launches = dict(fa.launch_counts)
    say(f"  phase {time.time() - t0:.1f}s; flash launches in the hub phase: {hub_launches}")
    # (e) convolutions, LSTMs and the text classifier's plain attention run
    # no flash kernel
    check(all(n == 0 for n in hub_launches.values())
          and all(libs.design_launches(name) == by_design0[name] for name in KERNELS),
          f"the hub phase launched flash kernels: {hub_launches}")

    say("== 20. a user's own files: the native dataset readers into FedAvg rounds, the C++ data "
        f"plane, an HF llama checkpoint at Llama-2-7B's widths ({HF_LAYERS} layer) into LoRA "
        "steps and from_checkpoint")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    files = files_phase(libs)
    say(f"  phase {time.time() - t0:.1f}s; flash launches: (a)-(b) {files['flash_launches_a_b']}, "
        f"(c) LoRA steps {files['hf']['train_flash_launches']}, (c) decode "
        f"{files['hf']['decode_flash_launches']}")

    say("== 21. the serving front door: the int8 GEMM, int8 decode at Llama-2-7B's widths "
        f"({SERVE_LAYERS} layers), deploy_isolated of the bench factory (flagship bf16 and int8, "
        "default geometry)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    front = front_door_phase(libs)
    say(f"  phase {time.time() - t0:.1f}s; int8 launches in (b) {front['decode']['launches']}, "
        f"flash launches in (b) {front['decode']['flash_launches']}, in (c)'s parent "
        f"{front['endpoint_parent_flash_launches']}")

    say("== 22. head dims 96 and 256 (Phi-3-mini's and Gemma-2B's attention widths) and "
        "JAX's test geometry (16) in f32 and float16, through attention_impl='auto'")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    head_dims = head_dims_phase(libs)
    say(f"  phase {time.time() - t0:.1f}s; (c) {head_dims['tiny_s']:.1f}s")

    say("== 23. result")
    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], **timing[name],
                     "design": "+".join(sorted(by_design[name]))})
    # the instances at phase 22's head dims: launches in its (a) and (b),
    # error and times at their attention shapes in phase 3
    for label, part in (("d96", "phi3"), ("d256", "gemma2b")):
        geom = head_dims[part]["geometry"]
        for name, (source, replaces, _) in KERNELS.items():
            rows.append({"name": f"{name}.{label}", "route": "cuda", "source": source,
                         "replaces": replaces, "launches": head_dims[part]["launches"][name],
                         "max_abs_err": head_errs[label][name], **head_timing[label][name],
                         "shape": f"B={B} T={T} Hq={geom['n_heads']} Hkv={geom['n_kv_heads']} "
                                  f"D={head_dims[part]['head_dim']} bf16 causal",
                         "design": "+".join(sorted(head_dims[part]["by_design"][name]))})
    # the int8 GEMM: one row a design that (b)'s int8 decode launched, its
    # times at gate/up's shape (K 4096, N 11008): a decode row at M=1, the
    # prefill at M=512; launches are (b)'s by design
    for design, n_launched in front["decode"]["design_launches"].items():
        if not n_launched:
            continue
        mine = [r for r in front["int8_gemm"] if r["design"] == design]
        at = [r for r in mine if (r["k"], r["n"]) == INT8_ROW[1:] and r["dtype"] == "bfloat16"]
        int8_row = min(at, key=lambda r: r["m"]) if at[0]["m"] <= 8 else max(at, key=lambda r: r["m"])
        rows.append({"name": f"int8_gemm.{design}", "route": "cuda",
                     "source": "fedml_tpu_torch/ops/csrc/int8_gemm.cu",
                     "replaces": "none: no TPU kernel (fedml_tpu/models/transformer.py:149, "
                                 "lax.dot_general on the int8 operand)",
                     "launches": n_launched,
                     "max_abs_err": max(r["max_abs_err"] for r in mine),
                     "ms": int8_row["ms"], "plain_ms": int8_row["plain_ms"],
                     "bound_ms": int8_row["bound_ms"], "bound_by": int8_row["bound_by"],
                     "library_ms": int8_row["library_ms"],
                     "shape": f"M={int8_row['m']} K={int8_row['k']} N={int8_row['n']} bf16",
                     "design": design})
    say(f"  total {time.time() - t_start:.1f}s")
    print(json.dumps({"serve": {"card": card, **serve}}), flush=True)
    print(json.dumps({"fedavg": {"card": card, "flash_launches": fedavg_launches,
                                 "vmap_flash_launches": vmap_launches,
                                 "zoo_flash_launches": zoo_launches, **fedavg}}), flush=True)
    print(json.dumps({"cross_silo": {"card": card, "flash_launches": cs_launches, **cross_silo}}),
          flush=True)
    print(json.dumps({"async": {"card": card, "flash_launches": async_launches, **asyncfed}}),
          flush=True)
    print(json.dumps({"resilience": {"card": card, "flash_launches": res_launches,
                                     **resilience}}), flush=True)
    print(json.dumps({"privacy": {"card": card, "flash_launches": priv_launches, **privacy}}),
          flush=True)
    print(json.dumps({"secure_fronts": {"card": card, "flash_launches": secure_launches,
                                        **secure}}), flush=True)
    print(json.dumps({"hierarchy": {"card": card, "flash_launches": hier_launches,
                                    **hierarchy}}), flush=True)
    print(json.dumps({"message_plane": {"card": card, "flash_launches": mp_launches,
                                        **message_plane}}), flush=True)
    print(json.dumps({"trust": {"card": card, "flash_launches": trust_launches, **trust}}),
          flush=True)
    print(json.dumps({"fhe_sp_zoo": {"card": card, "flash_launches": fhe_launches, **fhe_zoo}}),
          flush=True)
    print(json.dumps({"gan_nas_seg_hub": {"card": card, "flash_launches": hub_launches,
                                          **hub}}), flush=True)
    print(json.dumps({"files": {"card": card, **files}}), flush=True)
    print(json.dumps({"front_door": {"card": card, **front}}), flush=True)
    print(json.dumps({"head_dims": {"card": card, **head_dims}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
