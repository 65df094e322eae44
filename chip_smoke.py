#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--ckpt-dir DIR] [--out FILE]
                          [--lifecycle-dir DIR]

Phases, one line each (plus details):
  1. card    — nvidia-smi name and power limit, torch and CUDA versions;
  2. build   — nvcc builds the codec kernels (K1-K5) and flash attention
               (K6) from the sources under src/repro_torch/kernels/*/csrc
               into build/, one nvcc process per source, all at once;
  3. kernels — each kernel against its plain torch version on the card, at
               the main paths' shapes: K1-K4 bitwise (the qwen3-8b
               embedding leaf, a stacked MLP leaf, a ragged length, a leaf
               with clean blocks), median times beside the HBM bound; K5
               bitwise, all four lanes (the embedding, a stacked 8-layer
               MLP leaf, a bf16 KV-cache leaf, a ragged length, a leaf with
               -0.0, denormals and inf and the same with its last element
               changed), timed beside its bound on the embedding and on
               the bf16 KV-cache leaf (path 6's largest); K6 at the
               serving shape in bf16 (2e-2), an fp32 case (2e-6), a ragged
               length, a query offset and window + softcap in fp32 and in
               bf16 at head_dim 128, gemma2's long prefill (1 x 4608,
               window 4096, softcap 50), its odd layers, a query offset, a
               256-token prefill,
               window 128 + softcap 50, a ragged length and fp32 cases at
               head_dim 256, each on the route route() gives it (wgmma for
               bf16 at head_dim 64/128/256, SIMT otherwise) and
               bit-identical on repeat; the serving shape timed beside its
               bound and scaled_dot_product_attention, one call at a time
               and back to back (in turns K6 SDPA SDPA K6), the long prefill
               beside its bound (no library call computes softcapped
               attention; at most 1.0 ms) and head_dim 256 at each of path
               9's prefill lengths beside its bound; the three wgmma
               kernels must show 0 spill bytes in ptxas's report;
  4. train path on qwen3-8b at full width (d_model 4096, 32/8 heads,
               head_dim 128, d_ff 12288, vocab 151936 padded to 152064)
               with num_layers cut from 36 to 2: train 3 steps -> image A
               (lossless) -> 1 step -> image B (opt/m delta8 against A,
               opt/v bf16, parent A) -> restore B on the card -> check ->
               2 more steps from the restored and from the live state. The
               codec kernels' counters are zeroed just before and read just
               after; all four must have launched. Its tensors and its
               mem:// tier are released afterwards;
  5. serve path on qwen3-8b at full width and full depth (36 layers,
               8,191,783,936 params, fp32 on the card): engine A generates
               32 tokens for 4 prompts of 2048 tokens; engine B generates
               16, checkpoints its live session through CheckpointSession
               (lossless, so the image carries the migration record and its
               digest) and is deleted; engine C resumes the session
               (digest verified) and generates to 32. C's tokens must equal
               A's exactly, and K6 must have launched once per layer for
               each of the two prefills, every launch on the wgmma route
               (counters zeroed just before, read just after). Then one
               decode step and one prefill run under torch.profiler for the
               kernel-time breakdown and K6's share of it; then the dry
               run's record of the prefill step (LM.prefill, 4 x 2048, a
               (1, 1) mesh, traced on meta) against the card: the step once
               under FlopCounterMode and StepCost, its FLOPs and bytes
               accessed equal to the record's (K6 one op,
               repro_torch::flash_attention_fwd, on both), its device peak
               above what was allocated before it within 5% of the
               record's temp, and the record's bytes and FLOPs bounds each
               at most the median of 5 prefills under CUDA events
               (`dryrun:` lines with the card's name and power limit);
  6. pre-copy path on qwen3-8b at full width with num_layers cut from 36
               to 4 (the image holds the weights): engine A generates 32
               tokens; engine P generates 8, then pre-dump round 0 through
               ServeEngine.checkpoint(mode="pre_dump", weights=True) of
               {"params", "session"} (every leaf written), 12 and round 1
               (every params leaf reused, the cache written), 16 and the
               residual dump through ServeEngine.checkpoint with the
               migration record (the cache's bytes stored, not the
               weights'); a lazy restore through CheckpointSession
               (skeleton, first fault of the embedding, materialize with
               the deferred digest check); engine D resumes through
               ServeEngine.resume_from(lazy=True), adopting the image's
               weights, and continues to 32 tokens, which must equal A's;
               an eager restore of the same image must equal the lazy one
               bitwise. K5 must have classified every fp32/bf16 leaf on
               the card once in each of the 3 passes, K6 run
               once per layer for each of the 2 prefills (A and P; D
               resumes a session and only decodes), K1-K4 not at all.
               K5's classification of the tree is timed beside the JAX
               package's host route (blake2b of the digest's host capture),
               and the path's own host peak RSS is sampled.
  7. lifecycle path: preempt-to-migrate of a training job through the
               port's CLI (python -m repro_torch.launch.train --full
               --layers 1 --device cuda), each run a fresh process under a
               small wrapper that reads the child's launch counters, clocks
               and memory peaks (runpy + atexit): a run with --ckpt-dir
               file://... and --predump-rounds 1, SIGTERMed after the line
               of step 3 (paths 13 and 6 beside it on a thread), which
               must print the pre-dump round, the preemption and the durable
               image and exit 85; then --resume, side by side with a
               reference run of 10 steps (path 12 (b) and path 17's record
               beside them on a thread), which must report
               "(migrated: SIGTERM)", verify the digest and log losses
               within 1e-5 relative of the reference's. K5 must classify
               every fp32 leaf of the train state once in the round and once
               in the residual dump, K1-K4 and K6 not run. The images go to
               a temporary directory (--lifecycle-dir), checked first for
               room for two images, removed afterwards.
  8. remote path: the train path's configuration at 1 layer (path 7's)
               through a faulty
               simulated object store (remote://chip-remote?latency_ms=2
               &bw_mbps=1000&fail_rate=0.02&max_consecutive=1&seed=<seed>,
               virtual clock: network time simulated, not slept): train 3
               steps -> image A (lossless) -> 1 step -> image B (opt/m
               delta8 against A, opt/v bf16) -> restore B on the card
               through cache+remote://chip-remote?front=hostB&cache=<dir>, a
               fresh hot front on local disk standing for another compute
               resource -> the train path's bit rules -> 2 steps from the
               restored and from the live state; then a lazy restore of B
               through front=hostC faulting params/embed/tok (a 1 MiB ranged
               read, then the whole leaf) and the same fault again on
               hostC's warm front, which must cost 0 remote GETs. Multipart
               parts and retried transient faults must both be > 0; K1-K4
               must have launched (counters zeroed just before). The
               store's objects and the fronts' directories are released
               at the end;
  9. plane path: the live serving plane (Table-1 row 16) on gemma2-2b at
               full width, 14 of 26 layers (fp32
               on the card, bf16 compute, head_dim 256, window 4096 on the
               even layers, softcaps 50/30) through SessionManager (8 slots
               of 4800 positions) under seeded Poisson traffic
               (TrafficGenerator, rate 0.5 per tick, prompts 256-2048,
               targets up to 32) plus long0 (a 4608-token prompt, past the
               window): reference R runs 24 ticks with nov0 submitted at
               tick 12; the source runs 12, drains and checkpoints into
               mem:// (lossless, digest recorded); replica B restores
               eagerly, submits nov0 and runs to 24; replica C restores
               lazily, serves nov0 while the old sessions are restoring,
               completes the restore (deferred digest check) and runs to
               24. Every session's tokens in B and C must equal R's, and
               K6 must have launched once per layer per prefill, all on the
               wgmma route (counters zeroed just before, read just after);
               then long0's prefill (1 x 4608: window 4096 on the even
               layers, softcap 50, head dim 256) against the dry run's
               record, as path 5's (the record traced beside path 7's
               resume);
 10. archs: deepseek-67b and mistral-large-123b (2 layers) and
               musicgen-large (full depth) at full width: ServeEngine
               prefill 1 x 2048 and 8 greedy tokens, K6 once per layer on
               the wgmma route;
 11. fleet path: a preemption wave through repro_torch.fleet. One
               FleetCoordinator over 5 hosts x 8 devices (SimCluster's
               topology, registry and planner), one simulated store
               (remote://chip-fleet?latency_ms=2&bw_mbps=1000&agg_mbps=4000
               &knee=4&seed=<seed>, virtual clock), every root
               cache+remote://chip-fleet?front=<host>&prefix=<job> with the
               trainers' hot fronts on local disk (cache=<dir>/<host>/<job>),
               dump_concurrency 4. Jobs: 2 trainers of gemma2-2b at full
               width (num_layers cut from 26 to 2, the only cut: 745.6M
               params, params + m + v 8.95 GB fp32 on the card; batch 1 x
               512 from seeded numpy; CodecPolicy(optimizer="delta8",
               device="auto")) and 18 SimJobs (3 leaves x 4 MiB on the card,
               lossless), one coordinator for all. Admit and tick; wave 0
               gives every job a base image; every job is restored on its
               planned host and steps 2 more; 2 node failures are armed at
               MigrateRequest ordinals (T1's host at the first request of
               T1's batch, a host drawn from the seed at the first request of
               a drawn batch); wave 1: T0's moments are encoded by K1
               against wave 0's image, T1 is lost and re-placed from wave 0
               by the planner; the rest are restored on their planned hosts,
               T0's moments decoded by K3. Must hold: both waves complete, 2
               hosts failed, every lost job re-placed on a live host, every
               SimJob bit-identical by digest, T0 by the train path's rules
               (params and step bitwise, moments within each block's
               scale/2 of the drained live moments, 2 continued steps' losses
               within 1e-5 / 1e-3), T1's replayed losses equal to the ones
               its first incarnation logged (1e-5), the coordinator's frames
               equal to the transports' plus heartbeats, K1 and K3 launched
               and K5 and K6 not (counters zeroed just before, read just
               after), the path's host peak RSS under 96 GiB;
 12. socket path: the fleet over real Unix-domain sockets
               (repro_torch.fleet.transport): (a) after path 9 beside
               path 16, (b) on a thread beside path 7's resume.
               (a) In process: SimCluster(transport="socket") on 4 hosts x 4
               devices, a UDS CoordinatorServer, every job behind a
               WorkerAgent: one musicgen-large trainer at full width
               (d_model 2048, 32/32 heads, d_ff 8192, vocab 2048; num_layers
               cut from 48 to 4, the only cut: 209,733,632 params, 2.52 GB of
               fp32 params + m + v on the card; batch 1 x 512;
               CodecPolicy(optimizer="delta8", device="auto"); images on
               local disk through file://) and 6 SimJobs (3 x 4 MiB on the
               card, lossless). Wave 0 gives every job a raw image; every
               job is restored (the trainer adopts its delta8 baseline) and
               steps 2 more, the trainer's losses equal to its drained
               incarnation's on the same batches (1e-5); wave 1 runs under
               one seeded host failure and a cut of the connection 10 bytes
               into the trainer's MigrationTicket reply: the MigrateRequest
               executes once and its replay is answered from the worker's
               dedup window. Must hold: SimJobs bit-identical by digest, the
               trainer by the train path's rules, the lost jobs re-placed,
               every coordinator<->job interaction a frame the server took
               off a socket, K1, K4 and K3 launched and K2, K5 and K6 not
               (counters zeroed just before, read just after). (b) Across
               processes: examples/fleet_multiprocess_torch.py --serve with
               its journal on disk under 3 --worker subprocesses (a SimJob
               of 3 x 4 MiB each, on the card in its own CUDA context), twice
               side by side: the control run, and one whose coordinator
               SIGKILLs itself after the 2nd committed dump (rc must be
               -SIGKILL) and is restarted from its journal while the workers
               redial; both waves complete with equal digests;
 13. families path: the MoE, SSM and hybrid architectures at full
               width. (a) granite-moe-3b-a800m (full depth, 32 layers, 40
               experts top-8), dbrx-132b (2 of 40 layers: 16 experts top-4
               of d_ff 10752, 3.2 B params a layer), xlstm-350m (full
               depth: mLSTM, mLSTM, mLSTM, sLSTM x 6) and zamba2-1.2b (full
               depth, 38 mamba2 layers and a shared attention block applied
               7 times): ServeEngine prefill 1 x 2048 and 8 greedy tokens,
               K6 launched 32, 2, 0 and 7 times on the wgmma route; then
               one more prefill each of granite-moe (the MoE layers' and
               the dispatch's time under CUDA events) and xlstm (the sLSTM
               scans'). (b) zamba2-1.2b at full depth on the serve path's
               pattern: engine A 32 tokens for 4 prompts of 2048, engine B
               16 and a checkpoint of its session (38 mamba2 states, 7
               shared K/V caches), engine C resumes it and generates to 32:
               C's tokens equal A's and its final cache A's bitwise, the
               image's cache leaves are JAX's init_cache paths, shapes and
               dtypes, K6 14 on wgmma. (c)
               granite-moe-3b-a800m at full width, 32 -> 2 layers, through
               the train path's steps, images and checks, its aux metric
               reported, K1 9, K2 9, K3 12, K4 3 exactly;
 14. vision path: qwen2-vl-72b at full width (d_model 8192, 64/8 heads
               x 128, d_ff 29568, vocab 152064, M-RoPE sections 16/24/24),
               its vision frontend a stub (seeded patch embeddings and the
               grid's three position streams). (a) At 4 of 80 layers:
               LM.prefill(embeds=, positions=) of 1 x 2048 and 8 greedy
               tokens; two more prefills with 2-D positions and with three
               equal streams, bitwise equal logits, the grid's different;
               K6 12 on wgmma; K6 alone at this shape beside
               scaled_dot_product_attention (the same function here). (b)
               A session of 4 x 2048 and 16 tokens checkpointed after 8 as
               {cache, tokens, logits} through CheckpointSession, restored
               onto a (1, 1) mesh of the card (RestoreRequest(shardings=,
               mesh=) with the cache's cache_pspecs) and decoded to 16:
               tokens and every final cache leaf equal to the
               uninterrupted run's; K6 4 on wgmma, no codec kernel. (c) At
               1 of 80 layers: one train step on 1 x 512 embeddings with
               labels through AdamW; the gradients through compress_tree ->
               decompress_tree (a leaf at a time: within scale/2, the
               error state g - deq, wire bytes <= 0.26 of fp32);
 15. dry-run path: repro_torch.launch.dryrun, the planning tool. (a)
               The whole dry run (--all --both-meshes, no measurement) on
               the meta device into a temporary directory: 64 records, each
               n_params the element count of its arch's params tree; one
               line per arch with its largest per-device bytes and the cell
               that gives them. (b) measure_totals of qwen3-8b x train_4k,
               prefill_32k and decode_32k on the (16, 16) mesh record. (c)
               The card cross-check of the serve path's cache: the dry
               run's record (4 x 2081, 36 layers, a (1, 1) mesh) against
               kvcache.init_cache on the card (the train state's bytes and
               a step's FLOPs are checked at full depth in path 17(b));
               (d) examples/quickstart_torch.py and elastic_resize_torch.py
               as subprocesses on the card, side by side and beside path
               17: exit 0 and their printed invariants (the preemption
               drill repeats path 7 and runs in the CPU tests);
 16. crash path (on a thread beside paths 9 and then 12 (a), which
               hold 13 and 10 GB of the card while this path's trainers run
               in child processes): a node
               failure during a dump, through the port's CLI
               in fresh processes under path 7's wrapper, gemma2-2b at full
               width with 2 of 26 layers (8.95 GB lossless), batch 2 x 512,
               10 steps, --ckpt-every 4 to a file:// tier: (a) a reference
               run beside (b) the victim, SIGKILLed once its step-8 dump
               has put a file into the pool and before that dump's
               manifest exists (the pool polled every 20 ms): rc -SIGKILL,
               no step-8 manifest, the registry's latest image step 4
               with its manifest digest verified; after gc no
               unreferenced chunk (the dead writer's temporary files
               inside gc's quiet period kept); (c) --resume in a new
               process restores step 4 onto the card (every chunk's
               SHA-256 verified), re-dumps step 8 and logs losses within
               1e-5 relative of the reference's (bitwise equality
               reported); no kernel launched in (a) or (c);
 17. remat path (on a thread from the start of path 15(d), whose
               examples leave the card and host mostly idle):
               rematerialisation in the trainer, gemma2-2b at full
               width (d_model 2304, 8/4 heads x 256, d_ff 9216, vocab
               256000, window 4096, softcaps 50/30). (a) At 2 of 26 layers,
               1 x 4096: one loss and backward pass under each remat policy
               (none, dots, full) from the same params: the device peak
               above the state, the bytes kept for the backward pass
               (models.model.saved_for_backward), the forward + backward ms
               under CUDA events, the bytes per layer (the 4-layer forward's
               less the 2-layer one's, halved) extrapolated to 26 layers;
               the loss and every gradient under dots and full within 1e-5
               of each leaf's largest magnitude of those under none
               (bitwise equality reported); the same pass traced on meta
               (launch/stepcost.py): its peak within 5% of the card's.
               (b) All 26 layers, 2 x 4096, the default dots policy,
               AdamW: the dry run's record on a (1, 1) mesh (traced beside
               path 7's resume) against the card (params + optimizer-state
               bytes equal to the train state on the card and to the
               record's alias, its counted step FLOPs, the recompute
               included, equal to FlopCounterMode's count of the first
               real step, its argument + temp within 5% of the steps'
               device peak above what was allocated before the state); 3
               more steps under CUDA events, the TFLOP/s and share of the
               dense bf16 peak and the record's bytes and FLOPs bounds
               (each at most the median step) on `dryrun:` lines with the
               card's name and power limit. (c) The state after those 4
               steps dumped through CheckpointSession to file:// under
               CodecPolicy(optimizer="bf16", device="auto"): K2 encodes
               every moment leaf on the card (its launches counted, zeroed
               just before), params lossless; one more live step; the live
               state freed, the image restored onto the card (chunk
               SHA-256 and K2's payload digests verified) and the same step
               taken from it: its loss equal to the live step's bitwise;
               the host peak under 90 GB;
 18. mesh path (`spmd:` lines; in a child process, `--spmd-child`,
               beside path 11, so its device peak and its interpreter are
               its own): rank 0's per-device program of production
               cells on the card, under a fake process group of
               256 (launch/mesh.fake_group: collectives move no data) on
               the (16, 16) mesh at full width, qwen3-8b: (a) train_4k
               (dots, 8 microbatches, 16 of 256 rows a rank) at 2 of 36
               layers, with and without --cast-once; (b) prefill_32k (2 of
               32 rows, the cache split over the sequence) at 4 of 36
               layers. Each step's arguments are DTensors whose local
               shards alone live on the card; the dry run's record of the
               same program against it: the FLOPs StepCost counts on the
               card equal to
               the record's, the device peak above what was allocated
               before the state (train) or the step (prefill) within 5% of
               the record's argument + temp (train) or temp (prefill);
               the train step's median over 2 timed steps printed as the
               compute-only time of one of 256 cards; K6 launched once a
               layer on wgmma through its DTensor sharding rule. Each train
               record's totals_per_device FLOPs (its L1/L2 traces at the
               cell's microbatches) equal its whole-step trace and the
               card's count. (c) xlstm-350m at full width, whose 4 heads
               run whole on each rank's rows (sharding.local_rows):
               decode_32k (8 of 128 rows) and long_500k (1 row) at the full
               24 layers, and train at 4 of 24 layers (one m-m-m-s group),
               4 microbatches, train_4k's 256 rows with the sequence cut to
               512 for the script's time (at 4096 the step takes 114 s and
               350 s under StepCost: scripts/torch_xlstm_train_card.py), each
               against its record as (a) and (b) are. (d) After (a)'s steps,
               its state (rank 0's shards of the 19.58 GB unsharded qwen3-8b
               state at 2 layers) dumped through CheckpointSession under
               CodecPolicy(optimizer="bf16", device="auto") to file:// in a
               temporary directory, removed afterwards: every leaf gathered
               to rank 0 alone, one at a time, K2 encoding each moment leaf
               (its launches counted into the kernels line); rank 0's
               device peak above the state at most 2 x the largest leaf's
               unsharded bytes (the 2.49 GB embedding) + 1 GiB, where
               gathering the tree needs all 19.58 GB; the dump's seconds,
               leaves, unsharded bytes and the child's host RSS peak
               during it printed. (e) Then, on the same state, every
               other mode of a sharded state through the session: under
               (d)'s codec a pre-dump round, the 3 leaves SPMD_DIRTY
               changed on rank 0's shards, the residual dump (K5 once a
               pass over rank 0's local shards, the residual gathering
               only SPMD_DIRTY, K2 on the dirty moments); a lossless
               migrate (exit 85; its digest pass's seconds: every leaf
               gathered to rank 0 and hashed there); once path 11 has
               ended (the parent's ``--fleet-done`` file: the capture
               puts the state on this host), an async dump, its capture
               (the freeze) beside (d)'s sync seconds, wait(), the
               child's host RSS peak; each dump's rank-0 device peak
               within (d)'s limit, K5 and K2 counted into the kernels
               line. The records are traced on meta in a process of
               their own (``--spmd-records``) started with the script. The
               depth is cut for the path's time, not its memory (2 layers
               of train_4k take 12 GB). No loss is read: the fake
               collectives' outputs hold no values;
 19. capabilities: `criu check` of the port on the card
               (repro_torch.api.capabilities, one line each): every
               capability must be supported.
Then a JSON line of the kernels' numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero without
the last line. Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM HBM3 (NVIDIA data sheet). Each codec kernel does about a dozen
# scalar operations or fewer per element against the 6-9 bytes it moves,
# and the card does ~20 fp32/int32 operations per byte of HBM rate: every
# kernel's bound is the bytes it must move.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
REPLACES = {
    "delta_encode_digest": "src/repro/kernels/ckpt_codec/ckpt_codec.py:124",
    "bf16_encode_digest": "src/repro/kernels/ckpt_codec/ckpt_codec.py:148",
    "delta_decode": "src/repro/kernels/ckpt_codec/ckpt_codec.py:178",
    "delta_encode": "src/repro/kernels/ckpt_codec/ckpt_codec.py:50",
    "digest_blocks": "src/repro/kernels/ckpt_codec/ckpt_codec.py:165",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:110",
}
SOURCE = "src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SLAB = 2048          # blocks per plain-version call (bounds its temporaries)
# qwen3-8b has 36 layers: params + m + v are ~98 GB in fp32, more than one
# 80 GB card; at 2 layers they are 19.6 GB and fit with gradients
LAYERS = 2
# the lifecycle (path 7) and remote (path 8) trainers: 1 layer (17.3 GB),
# which keeps the whole script inside its time limit
LIFECYCLE_LAYERS = 1
# serve path: qwen3-8b at full depth, 4 prompts of 2048 tokens, 32 tokens
# generated, the session checkpointed after 16
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CUT = 4, 2048, 32, 16
# pre-copy path: the image holds the weights too, and the host holds the
# mem:// tier's copy of them beside the final dump's digest capture: at 36
# layers (32.8 GB) that would pass the machine's 96 GiB; 4 (8.1 GB) keep
# the whole script inside its time limit. Rounds after tokens 8 and 12, the
# residual dump after 16, the same prompts and 32 tokens as the serve path.
PRECOPY_LAYERS = 4
PRECOPY_ROUNDS, PRECOPY_CUT = (8, 12), 16
# K6 cases: label, B, Sq, Skv, H, KV, hd, dtype, window, softcap, tolerance,
# qk (q and k are randn times qk), rel. With rel False the tolerance bounds
# the max abs error; with rel True it bounds each element's error relative
# to the attention-weighted |v| at that element (the plain version with |v|
# in place of v): the scale of what bf16's rounding of p and of the output
# can move, which does not shrink with Skv as the outputs do. Where a
# softcap is on, qk 4 puts the logits (std 16) where the cap bends them.
GEMMA2_LONG_CASE = "gemma2 long prefill 1x4608 8/4 heads x256 bf16 window " \
    "4096 softcap 50"
FLASH_CASES = [
    ("serving 4x2048 32/8 heads x128 bf16", 4, 2048, 2048, 32, 8, 128,
     "bfloat16", 0, 0.0, 2e-2, 1.0, False),
    ("fp32 2x512 8/2 heads x128", 2, 512, 512, 8, 2, 128, "float32", 0, 0.0,
     2e-6, 1.0, False),
    ("ragged 2x1000 32/8 heads x128 bf16", 2, 1000, 1000, 32, 8, 128,
     "bfloat16", 0, 0.0, 2e-2, 1.0, False),
    ("q_offset Sq 128 Skv 384 fp32", 1, 128, 384, 4, 2, 64, "float32", 0, 0.0,
     2e-6, 1.0, False),
    ("window 128 + softcap 30 fp32", 1, 512, 512, 2, 1, 128, "float32", 128,
     30.0, 2e-6, 1.0, False),
    ("q_offset Sq 128 Skv 384 bf16 x128", 1, 128, 384, 4, 2, 128, "bfloat16",
     0, 0.0, 2e-2, 1.0, False),
    ("window 128 + softcap 30 bf16 x128", 1, 512, 512, 2, 1, 128, "bfloat16",
     128, 30.0, 2e-2, 1.0, False),
    # gemma2-2b's head dim 256 on the wgmma route (a two-stage K/V ring):
    # path 9's prefills on the even (window 4096) and odd (global) layers,
    # attention softcap 50; a query offset, the 16-CTA grid of a 256-token
    # prefill, a window that cuts inside the tiles
    (GEMMA2_LONG_CASE, 1, 4608, 4608, 8, 4, 256, "bfloat16", 4096, 50.0,
     2e-2, 4.0, True),
    ("gemma2 odd layers 1x4608 8/4 heads x256 bf16 softcap 50", 1, 4608,
     4608, 8, 4, 256, "bfloat16", 0, 50.0, 2e-2, 4.0, True),
    ("q_offset Sq 128 Skv 384 8/4 heads x256 bf16", 1, 128, 384, 8, 4, 256,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    ("gemma2 short prefill 1x256 8/4 heads x256 bf16 softcap 50", 1, 256,
     256, 8, 4, 256, "bfloat16", 0, 50.0, 2e-2, 4.0, True),
    ("window 128 + softcap 50 1x512 8/4 heads x256 bf16", 1, 512, 512, 8, 4,
     256, "bfloat16", 128, 50.0, 2e-2, 4.0, True),
    ("fp32 1x512 2/1 heads x256", 1, 512, 512, 2, 1, 256, "float32", 0, 0.0,
     2e-6, 1.0, False),
    ("fp32 1x512 2/1 heads x256 window 128 softcap 50", 1, 512, 512, 2, 1,
     256, "float32", 128, 50.0, 2e-6, 1.0, False),
    ("ragged 2x1000 8/4 heads x256 bf16", 2, 1000, 1000, 8, 4, 256,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    # the archs phase's prefills on the wgmma route: musicgen-large (MHA at
    # head dim 64), deepseek-67b and mistral-large-123b (GQA groups 8, 12);
    # deepseek's 1 x 2048 64/8 x 128 is also path 14's vision prefill
    ("musicgen 1x2048 32/32 heads x64 bf16", 1, 2048, 2048, 32, 32, 64,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    ("deepseek 1x2048 64/8 heads x128 bf16", 1, 2048, 2048, 64, 8, 128,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    ("mistral 1x2048 96/8 heads x128 bf16", 1, 2048, 2048, 96, 8, 128,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    # path 13's prefills: granite-moe-3b-a800m (GQA 3 at head dim 64),
    # dbrx-132b (GQA 6 at 128) and zamba2-1.2b's shared block at the
    # session's batch of 4 (its 1 x 2048 is musicgen's shape)
    ("granite-moe 1x2048 24/8 heads x64 bf16", 1, 2048, 2048, 24, 8, 64,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    ("dbrx 1x2048 48/8 heads x128 bf16", 1, 2048, 2048, 48, 8, 128,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    ("zamba2 session 4x2048 32/32 heads x64 bf16", 4, 2048, 2048, 32, 32, 64,
     "bfloat16", 0, 0.0, 2e-2, 1.0, True),
    # path 14's vision session: qwen2-vl-72b's 4 x 2048 at GQA 8, hd 128
    ("qwen2-vl session 4x2048 64/8 heads x128 bf16", 4, 2048, 2048, 64, 8,
     128, "bfloat16", 0, 0.0, 2e-2, 1.0, True),
]


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def cuda_ms(torch, fn, iters: int, warmup: int = 1, batch: int = 1) -> float:
    """Median of per-call CUDA-event times (ms). With batch > 1, each of the
    iters times batch back-to-back calls: the device's time per call, the
    host's launch work hidden behind the calls before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


# ----------------------------------------------------------------- kernels
def kernel_phase(torch, dev, seed):
    from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref

    B = ops.BLOCK
    w = ops.digest_weights(B, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def slabbed(fn, *args, per_block=2):
        """The plain version over SLAB blocks at a time, outputs joined;
        the first ``per_block`` args are split by block, the rest whole."""
        nblk = args[0].shape[0]
        outs = [fn(*[a[i:i + SLAB] for a in args[:per_block]],
                   *args[per_block:])
                for i in range(0, nblk, SLAB)]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat(outs)
        return tuple(torch.cat(parts) for parts in zip(*outs))

    as_bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def bits(t):
        return t.view(as_bits[t.dtype]) if t.dtype in as_bits else t

    def compare(a, b):
        """-> (bitwise equal, max abs error over the numeric outputs)."""
        if all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)):
            return True, 0.0
        return False, max(float((x.double() - y.double()).abs().max())
                          for x, y in zip(a, b) if x.dtype != torch.bool)

    n_embed = 152064 * 4096
    shapes = [("params/embed/tok 152064x4096", n_embed, 0),
              ("stack/b0/mlp/w_up 2x4096x12288", 2 * 4096 * 12288, 0),
              ("ragged 1000003", 1_000_003, 0),
              ("clean blocks (half) 2x4096x12288", 2 * 4096 * 12288, 0.5)]
    rows = {}
    for label, n, clean in shapes:
        x = torch.randn(n, generator=gen, device=dev)
        prev = x + 0.01 * torch.randn(n, generator=gen, device=dev)
        if clean:
            k = int(n * clean) // B * B
            prev[:k] = x[:k]
        xb, _ = ops._blocked(x, B)
        pb, _ = ops._blocked(prev, B)
        del x, prev
        nblk = xb.shape[0]
        timed = label.startswith("params/embed/tok")
        res = {}

        k1 = ckpt_codec.delta_encode_digest(xb, pb, w)
        p1 = slabbed(ref.delta_encode_digest_ref, xb, pb, w)
        res["delta_encode_digest"] = compare(k1, p1)
        k4 = ckpt_codec.delta_encode(xb, pb)
        p4 = slabbed(ref.delta_encode_ref, xb, pb)
        res["delta_encode"] = compare(k4, p4)
        k2 = ckpt_codec.bf16_encode_digest(xb, w)
        p2 = slabbed(ref.bf16_encode_digest_ref, xb, w, per_block=1)
        res["bf16_encode_digest"] = compare(k2, p2)
        q, s = k1[0], k1[1]
        k3 = ckpt_codec.delta_decode(q, s, pb)
        p3 = slabbed(ref.delta_decode_ref, q, s, pb, per_block=3)
        res["delta_decode"] = compare([k3], [p3])
        torch.cuda.synchronize()
        dirty = int(k1[2].sum())
        log(f"kernels: {label}: nblk={nblk} dirty={dirty} " + " ".join(
            f"{k}={'bit-identical' if ok else 'MISMATCH'}"
            for k, (ok, _) in res.items()))
        for k, (ok, e) in res.items():
            check(ok, f"{k} differs from its plain version on {label} "
                      f"(max abs err {e})")
        if clean:
            check(dirty < nblk, f"{label}: clean blocks were not detected")
        del k1, p1, k4, p4, k2, p2, k3, p3

        if timed:
            n_el = nblk * B
            wbytes = 2 * B * 4
            byte_count = {
                "delta_encode_digest": 9 * n_el + wbytes + 13 * nblk,
                "delta_encode": 9 * n_el + 5 * nblk,
                "bf16_encode_digest": 6 * n_el + wbytes + 8 * nblk,
                "delta_decode": 9 * n_el + 4 * nblk,
            }
            q, s = ckpt_codec.delta_encode(xb, pb)[:2]
            calls = {
                "delta_encode_digest": (
                    lambda: ckpt_codec.delta_encode_digest(xb, pb, w),
                    lambda: slabbed(ref.delta_encode_digest_ref, xb, pb, w)),
                "delta_encode": (
                    lambda: ckpt_codec.delta_encode(xb, pb),
                    lambda: slabbed(ref.delta_encode_ref, xb, pb)),
                "bf16_encode_digest": (
                    lambda: ckpt_codec.bf16_encode_digest(xb, w),
                    lambda: slabbed(ref.bf16_encode_digest_ref, xb, w,
                                    per_block=1)),
                "delta_decode": (
                    lambda: ckpt_codec.delta_decode(q, s, pb),
                    lambda: slabbed(ref.delta_decode_ref, q, s, pb,
                                    per_block=3)),
            }
            for k, (kern, plain) in calls.items():
                ms = cuda_ms(torch, kern, iters=10)
                plain_ms = cuda_ms(torch, plain, iters=2)
                rows[k] = {
                    "name": k, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[k], "launches": 0,
                    "max_abs_err": res[k][1], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": byte_count[k] / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes",
                    "library_ms": None, "shape": [nblk, B],
                    "bytes": byte_count[k]}
                log(f"kernels: {k} on {label}: {ms:.3f} ms (bound "
                    f"{rows[k]['bound_ms']:.3f} ms, {rows[k]['bound_ms'] / ms:.0%}"
                    f" of HBM peak), plain {plain_ms:.1f} ms")
            del q, s
        del xb, pb
        torch.cuda.empty_cache()
    rows["digest_blocks"] = digest_phase(torch, dev, gen, slabbed)
    return rows


def digest_phase(torch, dev, gen, slabbed):
    """K5 against its plain version, bitwise, all four lanes: one leaf at a
    time at the pre-copy path's shapes and edge cases, then grouped lists
    (mixed dtypes with empty, tiny, one-block, ragged and misaligned
    leaves; 200 leaves, more than the kernel's parameters hold; path 6's
    16 classified leaves), each list in one launch. The embedding, the
    bf16 KV-cache leaf and path 6's list are timed one call at a time and
    back to back beside the bytes bound and the integer-issue bound of
    the built kernel's main loops (cuobjdump)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import flatten_with_paths
    from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref
    from repro_torch.models.model import LM
    from repro_torch.training import abstract_train_state
    B = ops.BLOCK
    w = ops.digest_weights(B, dev)
    clocks = card_clocks()
    loops = k5_loops(str(ckpt_codec.LIB.build()), "digest_leaves")
    check(set(loops) == {"fp32", "bf16"},
          f"cuobjdump showed K5 main loops for {sorted(loops)}, not fp32 "
          f"and bf16")
    per_element = {}
    for k, lp in sorted(loops.items()):
        per_element[k] = {c: n / lp["elements"]
                          for c, n in sorted(lp["counts"].items())}
        log(f"kernels: digest_blocks {k} main loop: {lp['elements']} "
            f"elements a thread a trip, {lp['instructions'] / lp['elements']:.3f}"
            f" instructions an element (" + ", ".join(
                f"{c} {v:.3f}" for c, v in per_element[k].items())
            + f"); card {clocks['sms']} SMs, max SM clock "
            f"{clocks['max_sm_mhz']:.0f} MHz")

    def plain(x):
        n = x.numel()
        nblk = max(1, -(-n // B))
        xb = F.pad(x.reshape(-1), (0, nblk * B - n)).reshape(nblk, B)
        return torch.cat([
            torch.stack(slabbed(ref.digest_blocks_ref, xb, w, per_block=1)),
            torch.stack(slabbed(ref.mixed_lanes_ref, xb, w, per_block=1))])

    def plain_many(leaves):
        return torch.cat([plain(x) for x in leaves], dim=1)

    def timed(label, leaves, fn):
        """One call at a time and back to back (20 calls a timing), with
        the bytes bound (each input read once, the lanes written once) and
        the integer-issue bound (every block position's work, padding
        included, at the main loops' instructions an element)."""
        nblk = [max(1, -(-x.numel() // B)) for x in leaves]
        nbytes = sum(x.numel() * x.element_size() for x in leaves) \
            + 2 * B * 4 + 16 * sum(nblk)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        int_ms = sum(int_issue_ms(
            k * B, loops["bf16" if x.dtype == torch.bfloat16 else "fp32"],
            clocks["sms"], clocks["max_sm_mhz"] * 1e6)
            for k, x in zip(nblk, leaves))
        one = cuda_ms(torch, fn, iters=10)
        b2b = cuda_ms(torch, fn, iters=5, batch=20)
        plain_ms = cuda_ms(torch, lambda: plain_many(leaves), iters=2)
        bound = max(bytes_ms, int_ms)
        d = {"leaves": len(leaves), "ms": one, "ms_back_to_back": b2b,
             "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": "bytes" if bytes_ms >= int_ms else "operations",
             "bytes_bound_ms": bytes_ms, "int_bound_ms": int_ms,
             "shape": [sum(nblk), B], "bytes": nbytes}
        log(f"kernels: digest_blocks on {label} ({len(leaves)} leaves, "
            f"{sum(nblk)} blocks, one launch): one call {one:.4f} ms, back "
            f"to back {b2b:.4f} ms; bound {bound:.4f} ms by {d['bound_by']}"
            f" (bytes {bytes_ms:.4f} ms, integer issue {int_ms:.4f} ms): "
            f"{bound / one:.1%} of it one call, {bound / b2b:.1%} back to "
            f"back; plain {plain_ms:.1f} ms")
        return d

    def bitwise(label, leaves, grouped):
        before = (ckpt_codec.LAUNCHES["digest_blocks"],
                  ckpt_codec.LEAVES["digest_blocks"])
        if grouped:
            got = ckpt_codec.digest_blocks_many(leaves, w)
        else:
            got = ckpt_codec.digest_blocks(leaves[0], w)
        launched = (ckpt_codec.LAUNCHES["digest_blocks"] - before[0],
                    ckpt_codec.LEAVES["digest_blocks"] - before[1])
        want = plain_many(leaves)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        log(f"kernels: digest_blocks on {label}: {got.shape[1]} blocks, "
            f"{'bit-identical' if same else 'MISMATCH'} (4 lanes; "
            f"{launched[0]} launch over {launched[1]} leaves)")
        check(same, f"digest_blocks differs from its plain version on "
                    f"{label}")
        check(launched == (1, len(leaves)),
              f"digest_blocks on {label}: {launched[0]} launches over "
              f"{launched[1]} leaves, not one over {len(leaves)}")
        return got

    edge = torch.randn(3 * B + 5, generator=gen, device=dev)
    edge[:4] = torch.tensor([-0.0, 1e-40, -1e-45, float("inf")])
    edge_changed = edge.clone()
    edge_changed[-1] += 1.0
    L = PRECOPY_LAYERS
    kv_shape = (L, 4, 2081, 8, 128)
    cases = [
        ("params/embed/tok 152064x4096 fp32",
         torch.randn(152064 * 4096, generator=gen, device=dev)),
        (f"params/stack/b0/mlp/w_up {L}x4096x12288 fp32",
         torch.randn(L * 4096 * 12288, generator=gen, device=dev)),
        (f"session/cache/stack/b0/k {L}x4x2081x8x128 bf16",
         torch.randn(kv_shape, generator=gen, device=dev).to(
             torch.bfloat16).reshape(-1)),
        ("ragged 1000003 fp32",
         torch.randn(1_000_003, generator=gen, device=dev)),
        ("-0.0, denormals, inf; 3x16384+5 fp32", edge),
        ("the same with its last element changed", edge_changed),
    ]
    row, bf16, edge_lanes = None, None, []
    for label, x in cases:
        got = bitwise(label, [x], grouped=False)
        if label.startswith("-0.0") or label.startswith("the same"):
            edge_lanes.append(got)
        if row is None:          # the embedding: the row's own numbers
            t = timed(label, [x], lambda: ckpt_codec.digest_blocks(x, w))
            row = {"name": "digest_blocks", "route": "cuda",
                   "source": SOURCE, "replaces": REPLACES["digest_blocks"],
                   "launches": 0, "max_abs_err": 0.0, "library_ms": None,
                   **t, "per_element": per_element, "card": clocks}
        elif "bf16" in label:    # the largest bf16 leaf path 6 classifies
            bf16 = {"leaf": label, **timed(
                label, [x], lambda: ckpt_codec.digest_blocks(x, w))}
        del got
    check(not torch.equal(edge_lanes[0], edge_lanes[1]),
          "digest_blocks did not see a changed last element")
    del cases, x, edge, edge_changed

    # grouped lists, each in one launch
    rng = np.random.default_rng(7)
    mixed = []
    for i, n in enumerate([3 * B + 5, 5, 0, 2 * B + 9, 4096, B, 1_000_003,
                           B - 1]):
        t = torch.randn(n + 1, generator=gen, device=dev)
        t = t.to(torch.bfloat16) if i in (3, 7) else t
        mixed.append(t[1:] if i == 4 else t[:n])          # 4: misaligned
    check(mixed[4].data_ptr() % 16 != 0, "the misaligned view is aligned")
    bitwise("a mixed list (ragged, n 5, n 0, bf16, a misaligned view, one "
            "block, 1000003)", mixed, grouped=True)
    many = [torch.randn(int(n), generator=gen, device=dev).to(
        torch.bfloat16 if i % 3 == 2 else torch.float32)
        for i, n in enumerate(rng.integers(0, 70000, 200))]
    bitwise(f"200 leaves (more than the {ckpt_codec.PARAM_LEAVES} the "
            f"kernel's parameters hold)", many, grouped=True)
    del mixed, many
    lm = LM(CONFIG.replace(num_layers=L))
    shapes = [tuple(t.shape) for p, t in flatten_with_paths(
        abstract_train_state(lm)) if p.startswith("params/")]
    tree = [torch.randn(s, generator=gen, device=dev) for s in shapes] + [
        torch.randn(kv_shape, generator=gen, device=dev).to(torch.bfloat16)
        for _ in range(2)]
    label = f"path 6's {len(tree)} classified leaves (params at {L} layers, " \
            f"the KV cache's k and v)"
    bitwise(label, tree, grouped=True)
    grouped = {"list": label, **timed(
        label, tree, lambda: ckpt_codec.digest_blocks_many(tree, w))}
    del tree
    torch.cuda.empty_cache()
    row["bf16"] = bf16
    row["grouped"] = grouped
    return row


def flash_phase(torch, dev, seed):
    """K6 against its plain version at FLASH_CASES, each case on its route;
    times at the first (serving) case beside its bound and
    scaled_dot_product_attention."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.kernels.flash_attention.ref import reference_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    row = hd256 = None
    for (label, B, Sq, Skv, H, KV, hd, dtype, window, cap, tol, qk,
         rel) in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = (qk * torch.randn((B, Sq, H, hd), generator=gen,
                              device=dev)).to(dt)
        k = (qk * torch.randn((B, Skv, KV, hd), generator=gen,
                              device=dev)).to(dt)
        v = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dt)
        kw = dict(causal=True, window=window, softcap=cap)
        way = k6.route(dt, hd)
        k6.reset_launches()
        got = k6.flash_attention_fwd(q, k, v, **kw)
        want = reference_attention(q.float(), k.float(), v.float(), **kw)
        diff = (got.float() - want).abs()
        err = float(diff.max())
        if rel:                  # each element against its own scale
            mag = reference_attention(q.float(), k.float(), v.float().abs(),
                                      **kw)
            worst = float((diff / mag.clamp_min(1e-30)).max())
            what = (f"max abs err {err:.3g}, max err / attention-weighted "
                    f"|v| {worst:.3g} (tolerance {tol:g}, element-wise)")
            del mag
        else:
            worst = err
            what = f"max abs err {err:.3g} (tolerance {tol:g})"
        again = k6.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        log(f"kernels: flash_attention on {label} ({way} route"
            f"{f', q and k x{qk:g}' if qk != 1 else ''}): {what}; repeat "
            f"bit-identical: {same}")
        check(k6.ROUTE_LAUNCHES[way] == 2,
              f"flash_attention on {label} did not take the {way} route: "
              f"{k6.ROUTE_LAUNCHES}")
        check(worst < tol, f"flash_attention differs from its plain version "
                           f"on {label}: {what}")
        check(same, f"flash_attention is not deterministic on {label}")
        del got, want, again, diff
        if label == GEMMA2_LONG_CASE:
            hd256 = _time_long_prefill(torch, F, k6, reference_attention,
                                       (q, k, v), kw, way, err)
            hd256["max_rel_err"] = worst
            hd256["by_length"] = _time_plane_prefills(torch, k6, gen, dev)
        if row is None:        # the serving shape: time it
            ms = cuda_ms(torch, lambda: k6.flash_attention_fwd(q, k, v, **kw),
                         iters=20)
            plain_ms = cuda_ms(torch, lambda: reference_attention(
                q, k, v, **kw), iters=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention
            library_ms = cuda_ms(torch, lambda: lib(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
            bound_ms, bound_by, _, ops, nbytes = _bound(
                B, Sq, Skv, H, KV, hd, window, q.element_size())
            row = {"name": "flash_attention", "route": "cuda",
                   "source": FLASH_SOURCE,
                   "replaces": REPLACES["flash_attention"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "kernel_route": way,
                   "shape": [B, Sq, Skv, H, KV, hd],
                   "ops": ops, "bytes": nbytes}
            log(f"kernels: flash_attention on {label}: {way} route "
                f"{ms:.3f} ms (bound {row['bound_ms']:.3f} ms by "
                f"{row['bound_by']}: {ops / 1e9:.1f} GFLOP at 989 TFLOP/s "
                f"bf16, {nbytes / 1e6:.0f} MB at 3.35 TB/s; "
                f"{row['bound_ms'] / ms:.1%} of bound), plain "
                f"{plain_ms:.1f} ms, scaled_dot_product_attention "
                f"{library_ms:.3f} ms "
                f"({ms / library_ms:.2f}x its time)")
            # back to back, in turns (K6, SDPA, SDPA, K6), 20 calls a
            # timing: the device's time per call, the host's launch work
            # hidden behind the calls before it
            b2b = {"k6": [], "sdpa": []}
            calls = {"k6": lambda: k6.flash_attention_fwd(q, k, v, **kw),
                     "sdpa": lambda: lib(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)}
            for who in ("k6", "sdpa", "sdpa", "k6"):
                b2b[who].append(cuda_ms(torch, calls[who], iters=5,
                                        batch=20))
            row["ms_back_to_back"] = b2b["k6"]
            row["library_ms_back_to_back"] = b2b["sdpa"]
            log(f"kernels: flash_attention on {label} back to back (20 "
                f"calls a timing, in turns K6 SDPA SDPA K6): {way} route "
                f"{min(b2b['k6']):.4f}-{max(b2b['k6']):.4f} ms "
                f"({bound_ms / max(b2b['k6']):.1%}-"
                f"{bound_ms / min(b2b['k6']):.1%} of bound), "
                f"scaled_dot_product_attention {min(b2b['sdpa']):.4f}-"
                f"{max(b2b['sdpa']):.4f} ms; K6 / SDPA "
                f"{min(b2b['k6']) / max(b2b['sdpa']):.2f}-"
                f"{max(b2b['k6']) / min(b2b['sdpa']):.2f}x")
        del q, k, v
        torch.cuda.empty_cache()
    row["hd256"] = hd256
    return row


# K6 at gemma2's long prefill on the wgmma route may take at most this
LONG_PREFILL_MAX_MS = 1.0
# path 9's prefill lengths: the traffic's prompt support, nov0 and long0
PLANE_PREFILL_LENGTHS = (256, 300, 512, 1024, 2048, 4608)


def _bound(B, Sq, Skv, H, KV, hd, window, es=2):
    """(bound ms, bound_by, live pairs, ops, bytes) of one causal K6 call:
    its operations are the op's FLOP formula (flash_attention.flops)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flops, live_pairs)
    pairs = live_pairs(Sq, Skv, True, window)
    ops = flops(B, Sq, Skv, H, hd, True, window)
    nbytes = es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", pairs, ops, nbytes)


def _time_long_prefill(torch, F, k6, reference_attention, qkv, kw, way, err):
    """K6 at gemma2's long prefill (the wgmma route at head dim 256) beside
    its bound and its plain version; it must take at most
    LONG_PREFILL_MAX_MS. No single PyTorch call computes softcapped
    attention: SDPA is timed at the same shape without window and softcap,
    and reported as that other function."""
    q, k, v = qkv
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    ms = cuda_ms(torch, lambda: k6.flash_attention_fwd(q, k, v, **kw),
                 iters=10)
    plain_ms = cuda_ms(torch, lambda: reference_attention(q, k, v, **kw),
                       iters=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    bound_ms, bound_by, pairs, ops, nbytes = _bound(
        B, Sq, Skv, H, KV, hd, kw["window"], q.element_size())
    out = {"kernel_route": way, "shape": [B, Sq, Skv, H, KV, hd],
           "window": kw["window"], "softcap": kw["softcap"],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "library_note": "none (softcap)",
           "sdpa_causal_no_window_no_softcap_ms": sdpa_ms,
           "live_pairs": pairs, "ops": ops, "bytes": nbytes}
    log(f"kernels: flash_attention on {GEMMA2_LONG_CASE}: {way} route "
        f"{ms:.3f} ms (bound {out['bound_ms']:.4f} ms by {out['bound_by']}: "
        f"{pairs:,} live pairs, {ops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {out['bound_ms'] / ms:.1%} of "
        f"bound), plain {plain_ms:.1f} ms; library: none (softcap); "
        f"scaled_dot_product_attention at the same shape without window "
        f"and softcap (another function) {sdpa_ms:.3f} ms")
    check(way == "wgmma" and ms <= LONG_PREFILL_MAX_MS,
          f"K6 at gemma2's long prefill took {ms:.3f} ms on the {way} route "
          f"(at most {LONG_PREFILL_MAX_MS} ms on wgmma)")
    return out


def _time_plane_prefills(torch, k6, gen, dev):
    """K6 at head dim 256 (bf16, 8/4 heads, softcap 50) at each of path 9's
    prefill lengths, on the even layers (window 4096) and the odd (global),
    each beside its live-pair bound: the device time of back-to-back calls,
    taken in turns (even, odd, odd, even), and the time of one call alone,
    the host's launch work included."""
    rows, parts = [], []
    for S in PLANE_PREFILL_LENGTHS:
        q = (4 * torch.randn((1, S, 8, 256), generator=gen,
                             device=dev)).bfloat16()
        k, v = ((4 * torch.randn((1, S, 4, 256), generator=gen,
                                 device=dev)).bfloat16() for _ in range(2))
        row = {"S": S, "route": k6.route(q.dtype, 256)}
        for layers, window in (("even", 4096), ("odd", 0), ("odd", 0),
                               ("even", 4096)):
            def fn(window=window):
                return k6.flash_attention_fwd(q, k, v, causal=True,
                                              window=window, softcap=50.0)
            bound_ms, _, pairs, _, _ = _bound(1, S, S, 8, 4, 256, window)
            r = row.setdefault(layers, {"window": window, "ms": [],
                                        "call_ms": [], "bound_ms": bound_ms,
                                        "live_pairs": pairs})
            r["ms"].append(cuda_ms(torch, fn, iters=5, batch=20))
            r["call_ms"].append(cuda_ms(torch, fn, iters=10))
        rows.append(row)
        parts.append(f"{S}: " + ", ".join(
            f"{layers} {min(r['ms']):.4f}-{max(r['ms']):.4f} ms "
            f"({r['bound_ms'] / max(r['ms']):.1%}-"
            f"{r['bound_ms'] / min(r['ms']):.1%} of {r['bound_ms']:.4f}; "
            f"one call {min(r['call_ms']):.4f}-{max(r['call_ms']):.4f})"
            for layers, r in ((n, row[n]) for n in ("even", "odd"))))
        del q, k, v
    log(f"kernels: flash_attention at head_dim 256 by path 9's prefill "
        f"length ({rows[0]['route']} route, 1 x S, 8/4 heads, softcap 50; "
        f"even layers window 4096, odd layers global; back-to-back calls, "
        f"% of the live-pair bound): " + "; ".join(parts))
    return rows


# -------------------------------------------------------------- train path
def policy_b(path: str) -> str:
    if path.startswith("opt/m/"):
        return "delta8"
    return "bf16" if path.startswith("opt/v/") else "none"


def m_within_half_scale(got, live, prev):
    """delta8's bound, a slab of codec blocks at a time: every element
    within its block's scale/2, widened by 2^-12 relative for the fp32
    roundings of d = x - prev and of 1/scale (each ~2^-23 * amax, i.e.
    ~127 * 2^-23 of scale) and by one ulp of the value for the decode's
    own rounding. -> (holds, worst error / (scale/2))."""
    import torch

    from repro_torch.kernels.ckpt_codec import ops, ref
    B, n, worst, ok = ops.BLOCK, live.numel(), 0.0, True
    for lo in range(0, n, SLAB * B):
        hi = min(n, lo + SLAB * B)
        xb, _ = ops._blocked(live[lo:hi], B)
        pb, _ = ops._blocked(prev[lo:hi], B)
        _, scale, _ = ref.delta_encode_ref(xb, pb)
        half = torch.repeat_interleave(scale / 2, B)[:hi - lo]
        ax = live[lo:hi].abs()
        ulp = torch.nextafter(ax, torch.full_like(ax, float("inf"))) - ax
        e = (got[lo:hi] - live[lo:hi]).abs()
        ok &= bool((e <= half * (1 + 2 ** -12) + ulp).all())
        worst = max(worst, float((e / torch.clamp_min(half, 1e-30)).max()))
    return ok, worst


def check_restored_b(torch, state, tree, prev, policy=policy_b) -> float:
    """Image B's restore against the live state, by the train path's
    rules: leaves ``policy`` keeps lossless (params, step) bit-identical,
    bf16 leaves (opt/v under policy_b) the bf16 round trip of the live
    value bitwise, delta8 leaves (opt/m under policy_b) within each
    block's scale/2 of the live value (prev: the delta8 baseline, moved to
    the leaf's device one leaf at a time). -> worst delta8 error /
    (scale/2)."""
    from repro_torch.core import flatten_with_paths
    live = dict(flatten_with_paths(state))
    got = dict(flatten_with_paths(tree))
    check(set(live) == set(got), "restored leaves differ from the live ones")
    worst = 0.0
    for p, t in live.items():
        g = got[p]
        if policy(p) == "bf16":
            check(torch.equal(g.view(torch.int32),
                              t.to(torch.bfloat16).float().view(torch.int32)),
                  f"{p}: not the bf16 round trip of the live value")
        elif policy(p) == "delta8":
            ok, ratio = m_within_half_scale(g.reshape(-1), t.reshape(-1),
                                            prev[p].to(t.device).reshape(-1))
            check(ok, f"{p}: delta8 error above the block's scale/2 "
                      f"(worst error / (scale/2) = {ratio})")
            worst = max(worst, ratio)
        else:
            check(torch.equal(g, t), f"{p}: not bit-identical after restore")
    return worst


def continue_both(torch, step, tree, state, batches, label, final_step=6):
    """Train 2 steps from the restored tree (at step 4) and from the live
    state on the same batches -> ({"restored", "live"} losses, tree,
    state). Step 5's loss is computed from bit-identical params: it must
    agree to 1e-5 relative (the kernels are deterministic; the slack is for
    a cuBLAS algorithm choice). Step 6 starts from params updated with the
    lossy moments, which move a parameter by ~lr * 1e-2 relative; its loss
    must agree to 1e-3 relative. A tree restored at another step names the
    step it must reach (``final_step``)."""
    import numpy as np
    cont = {"restored": [], "live": []}
    for name, s in (("restored", tree), ("live", state)):
        for b in batches:
            s, m = step(s, b)
            cont[name].append(float(m["loss"]))
        if name == "restored":
            tree = s
        else:
            state = s
    log(f"{label}: continue 2 steps: restored losses {cont['restored']}, "
        f"live losses {cont['live']} (held to 1e-5 relative at step 5, "
        f"whose params are bit-identical, and 1e-3 at step 6, after one "
        f"update with the lossy moments)")
    r0, l0 = cont["restored"][0], cont["live"][0]
    r1, l1 = cont["restored"][1], cont["live"][1]
    check(abs(r0 - l0) <= 1e-5 * abs(l0), f"step 5 losses {r0} vs {l0}")
    check(abs(r1 - l1) <= 1e-3 * abs(l1), f"step 6 losses {r1} vs {l1}")
    check(all(np.isfinite(v) for v in cont["restored"] + cont["live"]),
          "non-finite loss after restore")
    check(int(tree["step"]) == final_step
          and tree["step"].dtype == torch.int32,
          "restored step counter did not continue")
    return cont, tree, state


def train_path(torch, dev, args, cfg=None, label="train"):
    """Path 4 (qwen3-8b at LAYERS layers), or the same steps on ``cfg``
    with its log lines under ``label`` (path 13's MoE trainer)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import as_tier, dump, flatten_with_paths, restore
    from repro_torch.core.storage import LocalDirTier
    from repro_torch.device import to_host
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step)

    if cfg is None:
        cfg = CONFIG.replace(num_layers=LAYERS)
    full_layers = get_config(cfg.name).num_layers
    lm = LM(cfg)
    experts = (f" experts={cfg.num_experts} top-{cfg.experts_per_token}"
               if cfg.num_experts else "")
    log(f"{label}: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff}{experts} vocab={cfg.vocab_size}->"
        f"{cfg.padded_vocab}; cut: num_layers {full_layers} -> "
        f"{cfg.num_layers} (the only cut); params={lm.n_params():,}")
    # a mem:// tier of its own per label: the cleanup below deletes the
    # chunks behind the tier's chunk index, which a later dump to the same
    # tier would trust
    root = (LocalDirTier(args.ckpt_dir, fsync="commit") if args.ckpt_dir
            else as_tier(f"mem://chip-smoke-{label}-{args.seed}"))
    rng = np.random.default_rng(args.seed)

    def batch():
        t = rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int64)
        return {"tokens": torch.from_numpy(t).to(dev)}

    t0 = time.time()
    state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                             device=dev)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in flatten_with_paths(state))
    log(f"{label}: init {time.time() - t0:.1f} s; train state "
        f"{state_bytes / 1e9:.2f} GB on the card")
    step = make_train_step(lm, OptConfig())
    out = {"state_bytes": state_bytes, "losses": [], "aux": [], "step_s": []}

    ckpt_codec.reset_launches()          # the main path's counts start here
    for _ in range(3):
        t0 = time.time()
        state, m = step(state, batch())
        loss = float(m["loss"])
        out["losses"].append(loss)
        out["aux"].append(float(m["aux"]))
        out["step_s"].append(time.time() - t0)
        check(np.isfinite(loss), f"loss {loss} is not finite")
    log(f"{label}: 3 steps, losses {out['losses']}, step s "
        f"{[round(s, 3) for s in out['step_s']]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    t0 = time.time()
    ra = dump(state, root, step=3, device=dev, device_codec="auto")
    out["dump_a_s"] = time.time() - t0
    log(f"{label}: image A {ra['image_id']} lossless in {out['dump_a_s']:.1f} s: "
        f"{ra['stats']['bytes_stored'] / 1e9:.2f} GB stored")
    prev = {p: to_host(t) for p, t in flatten_with_paths(state)
            if p.startswith("opt/m/")}

    state, m = step(state, batch())
    out["losses"].append(float(m["loss"]))
    out["aux"].append(float(m["aux"]))
    torch.cuda.synchronize()
    t0 = time.time()
    rb = dump(state, root, step=4, parent=ra["image_id"],
              codec_policy=policy_b, prev_host_tree=prev, device=dev,
              device_codec="auto")
    out["dump_b_s"] = time.time() - t0
    st = rb["stats"]
    log(f"{label}: image B {rb['image_id']} (parent {ra['image_id']}) in "
        f"{out['dump_b_s']:.1f} s: {st['bytes_stored'] / 1e9:.2f} GB stored, "
        f"{st['leaves_device']} leaves through the device codec stage")
    check(st["leaves_device"] > 0, "no leaf went through the device stage")
    # A's m is kept on the card for the check below: the host holds the
    # mem:// tier and, during restore, the decoded leaves (~60 GB at peak)
    prev = {p: torch.from_numpy(a).to(dev) for p, a in prev.items()}

    t0 = time.time()
    tree, man = restore(root, rb["image_id"], device=dev,
                        expected=abstract_train_state(lm))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    digests = sum(1 for r in man["leaves"] if "digest" in r["codec_meta"])
    log(f"{label}: restore B in {out['restore_s']:.1f} s; {digests} payload "
        f"digests re-derived from the stored bytes and verified")
    check(digests > 0, "image B carries no payload digest")

    out["m_err_over_half_scale"] = check_restored_b(torch, state, tree, prev)
    log(f"{label}: params and step bit-identical; opt/v equals the bf16 round "
        "trip of the live v bitwise; opt/m within each block's scale/2 "
        f"(worst error / (scale/2) = {out['m_err_over_half_scale']:.4f})")
    del prev

    out["continue"], tree, state = continue_both(
        torch, step, tree, state, [batch() for _ in range(2)], label)

    # read just after the train path: its kernels are K1-K4 (K5 runs on
    # the pre-copy path)
    launches = {k: v for k, v in ckpt_codec.LAUNCHES.items()
                if k != "digest_blocks"}
    out["launches"] = launches
    log(f"kernels: {label}-path launches " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the {label} path")
    if not args.ckpt_dir:      # release the images held in host memory
        root.delete("chunks")
        root.delete("images")
    return out


# -------------------------------------------------------------- serve path
def serve_path(torch, dev, args):
    import numpy as np

    from repro_torch.api import CheckpointSession
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core.storage import as_tier
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    cfg = CONFIG
    lm = LM(cfg)
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    log(f"serve: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, no cut); params={lm.n_params():,} ({pbytes / 1e9:.1f} GB "
        f"fp32 on the card), init {time.time() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    uri = f"mem://chip-smoke-serve-{args.seed}"
    out = {"params": lm.n_params()}

    torch.use_deterministic_algorithms(True)   # A, B and C must agree bitwise
    k6.reset_launches()                        # the serve path's counts
    ckpt_codec.reset_launches()
    a = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    a.submit(prompts)
    torch.cuda.synchronize()
    out["prefill_s"] = time.time() - t0
    kv = a.cache["stack"]["b0"]["k"][:, :, :SERVE_PROMPT]
    check(bool(torch.isfinite(kv).all()), "prefill wrote non-finite keys")
    t0 = time.time()
    want = a.generate(SERVE_GEN).copy()
    out["decode_s_per_token"] = (time.time() - t0) / (SERVE_GEN - 1)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(a.cache))
    del a, kv
    log(f"serve: engine A: prefill {SERVE_B}x{SERVE_PROMPT} in "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s_per_token']:.4f} "
        f"s/token to {SERVE_GEN} tokens; KV cache {cache_bytes / 1e9:.3f} GB "
        f"bf16")
    check(want.shape == (SERVE_B, SERVE_GEN) and want.min() >= 0
          and want.max() < cfg.vocab_size, "generated tokens out of range")

    b = ServeEngine(lm, params, max_len=max_len)
    b.submit(prompts)
    b.generate(SERVE_CUT)
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    receipt = b.checkpoint(sess, arch=cfg.name)
    out["dump_s"] = time.time() - t0
    out["image_bytes"] = receipt.stats["bytes_stored"]
    del b
    log(f"serve: engine B checkpointed at token {SERVE_CUT} as "
        f"{receipt.image_id} in {out['dump_s']:.2f} s: "
        f"{out['image_bytes'] / 1e9:.3f} GB stored; engine B deleted")

    c = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    res = c.resume_from(CheckpointSession(uri, device=dev))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    log(f"serve: engine C resumed {res.image_id} in {out['restore_s']:.2f} s, "
        f"digest_verified={res.digest_verified}")
    check(res.digest_verified is True, "the resumed session's digest was "
                                       "not verified")
    check(np.array_equal(c.generated(), want[:, :SERVE_CUT]),
          "the resumed session's tokens differ from engine A's")
    got = c.generate(SERVE_GEN)
    same = bool(np.array_equal(got, want))
    torch.use_deterministic_algorithms(False)
    launches = dict(k6.LAUNCHES)               # read just after the path
    routes = dict(k6.ROUTE_LAUNCHES)
    codec = dict(ckpt_codec.LAUNCHES)
    out["launches"] = launches
    out["k6_routes"] = routes
    out["tokens_equal"] = same
    log(f"serve: engine C tokens {'equal' if same else 'DIFFER FROM'} "
        f"engine A's at all {SERVE_B}x{SERVE_GEN}; first row "
        f"{got[0, :8].tolist()}...")
    log(f"kernels: serve-path launches flash_attention="
        f"{launches['flash_attention']} (wgmma route {routes['wgmma']}, "
        f"SIMT route {routes['simt']}; codec kernels "
        f"{sum(codec.values())}: the serve image is lossless)")
    check(same, "engine C's continuation differs from engine A's tokens")
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"flash_attention launched {launches['flash_attention']} times on "
          f"the serve path, not {2 * cfg.num_layers} (one per layer for each "
          f"of the two prefills)")
    check(routes == {"wgmma": 2 * cfg.num_layers, "simt": 0},
          f"the serve path's flash_attention launches did not all take the "
          f"wgmma route: {routes}")
    # where the time goes, after the counts were read: one decode step and
    # one prefill under torch.profiler, kernel time by name
    out["profile"] = {}
    for name, fn in (("decode step", c.step),
                     ("prefill", lambda: c.submit(prompts))):
        wall_ms, busy_ms, rows = device_breakdown(torch, fn)
        k6_ms = sum(ms for ms, k, _ in rows if "flash_fwd" in k)
        k6_n = sum(n for _, k, n in rows if "flash_fwd" in k)
        out["profile"][name] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                                "top": rows[:6], "k6_ms": k6_ms}
        log(f"serve: profile of one {name}: {wall_ms:.1f} ms wall under the "
            f"profiler, {busy_ms:.1f} ms of kernels ({busy_ms / wall_ms:.0%} "
            f"busy); K6 {k6_ms:.2f} ms x{k6_n} ({k6_ms / busy_ms:.1%} of the "
            f"kernel time); top: " + "; ".join(
                f"{k[:48]} {ms:.2f} ms x{n}" for ms, k, n in rows[:6]))
    del c
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's record of this prefill against the card
    out["record"] = prefill_against_record(
        torch, dev, lm, params, "qwen3-8b", SERVE_B, SERVE_PROMPT, args.seed,
        "path 5 (serve)")
    del params
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


# ------------------------------------------- a prefill against its record
PREFILL_REPS = 5        # timed prefills after the counted one


def dryrun_record(arch: str, kind: str, B: int, S: int, **kw) -> tuple:
    """The dry run's record of arch's B x S ``kind`` step on a (1, 1) mesh,
    traced on meta (CPU only) -> (record, seconds); ``kw`` as run_cell
    takes them (num_layers, microbatches)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.time()
    rec = dryrun.run_cell(arch, ShapeConfig(f"chip_{kind}", kind, S, B),
                          mesh=make_test_mesh((1, 1), device="meta"),
                          verbose=False, **kw)
    return rec, time.time() - t0


def prefill_against_record(torch, dev, lm, params, arch, B, S, seed, label,
                           planned=None) -> dict:
    """The step the dry run traces for a prefill cell,
    ``lm.prefill(params, tokens=...)``, on the card: once under
    FlopCounterMode and StepCost, then PREFILL_REPS times under CUDA
    events. Its counted FLOPs and bytes accessed must equal the record's,
    its device peak above what was allocated before it lie within
    REMAT_PEAK_TOL of the record's temp (StepCost's temp holds every
    storage the step allocates, its outputs, the cache and the logits,
    among them), and the record's bytes and FLOPs bounds be at most the
    median prefill. ``planned``: dryrun_record()'s result, traced where
    this process was idle; traced here when None. Run after the path's
    launch counts were read: these prefills launch K6 too. Resets the
    card's peak statistics: ``path_peak_device_gb`` is the path's peak
    before this check."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import TOKEN_DTYPE
    from repro_torch.launch.stepcost import StepCost

    cfg = lm.cfg
    out = {"path_peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec, out["record_s"] = planned or dryrun_record(
        arch, "prefill", B, S, num_layers=cfg.num_layers)
    mem, cost = rec["memory_analysis_per_device"], \
        rec["cost_analysis_per_device"]
    tot = rec["totals_per_device"]
    out.update(memory_analysis=mem, cost_analysis=cost,
               step_flops=tot["step_flops"], step_bytes=tot["step_bytes"])
    log(f"dryrun: {label}: the record of {cfg.name} prefill {B} x {S} at "
        f"{cfg.num_layers} layers, (1, 1) mesh: memory_analysis "
        f"{dryrun.memory_line(mem)}; {cost['flops']:,} FLOPs and "
        f"{cost['bytes accessed']:,} bytes accessed (one trace on meta; "
        f"{out['record_s']:.1f} s in all)")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S))).to(TOKEN_DTYPE).to(dev)

    def step():
        return lm.prefill(params, tokens=tokens)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc, StepCost() as sc:
        logits, cache = step()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == (B, cfg.padded_vocab)
    del logits, cache
    counted, nbytes = int(fc.get_total_flops()), sc.bytes_accessed
    check(finite and shape_ok, f"{label}: the counted prefill's logits are "
                               f"not finite or not [B, V]")
    times = []
    for _ in range(PREFILL_REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / 1e3)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() - base
    temp = mem["temp_size_in_bytes"]
    miss = temp / peak - 1
    bounds = {"bytes": cost["bytes accessed"] / HBM_BYTES_PER_S,
              "flops": cost["flops"] / BF16_OPS_PER_S}
    out.update(counted_flops=counted, counted_bytes=nbytes,
               card_stepcost_temp=sc.peak, peak_above_base=peak,
               base_device_bytes=base, planned_miss=miss, prefill_s=times,
               prefill_s_median=med, bound_s=bounds,
               bound_share=max(bounds.values()) / med)
    card = smi_line()
    log(f"dryrun: {card}: {label}: {cfg.name} {cfg.num_layers}-layer "
        f"prefill {B} x {S} counted on the card {counted:,} FLOPs "
        f"(FlopCounterMode) and {nbytes:,} bytes accessed (StepCost), the "
        f"record {cost['flops']:,} and {cost['bytes accessed']:,} "
        f"(extrapolated {tot['step_flops']:,} and {tot['step_bytes']:,})")
    log(f"dryrun: {card}: {label}: peak device memory {peak:,} B above the "
        f"{base / 1e9:.3f} GB allocated before the prefill, the record's "
        f"temp {temp:,} B ({100 * miss:+.2f}%; StepCost on the card "
        f"{sc.peak:,} B; output {mem['output_size_in_bytes']:,} B, inside "
        f"the temp)")
    log(f"dryrun: {card}: {label}: prefill median {med:.4f} s over "
        f"{PREFILL_REPS} (CUDA events; {min(times):.4f}-{max(times):.4f}); "
        f"the record's bounds: bytes {cost['bytes accessed']:,} / "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bounds['bytes']:.4f} s, "
        f"FLOPs {cost['flops']:,} / {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s = "
        f"{bounds['flops']:.4f} s; the larger is "
        f"{100 * out['bound_share']:.1f}% of the median")
    check(counted == cost["flops"] == tot["step_flops"],
          f"{label}: the card's prefill counts {counted} FLOPs, the record "
          f"{cost['flops']} (extrapolated {tot['step_flops']})")
    check(nbytes == cost["bytes accessed"] == tot["step_bytes"],
          f"{label}: the card's prefill counts {nbytes} bytes accessed, the "
          f"record {cost['bytes accessed']} (extrapolated "
          f"{tot['step_bytes']})")
    check(abs(miss) <= REMAT_PEAK_TOL,
          f"{label}: the record's temp {temp} B is {100 * miss:+.2f}% of the "
          f"card's peak {peak} B above what was allocated before the "
          f"prefill (limit {100 * REMAT_PEAK_TOL:g}%)")
    check(all(b <= med for b in bounds.values()),
          f"{label}: a bound of the prefill {bounds} exceeds its median "
          f"{med:.4f} s")
    return out


# ----------------------------------------------------------- pre-copy path
def precopy_path(torch, dev, args):
    """Pre-copy migration of a serving job (CRIU pre-dump -> residual dump
    -> lazy-pages restore), the tree {"params", "session"} classified on the
    card by K5 in every pass."""
    import numpy as np

    from repro_torch.api import CheckpointSession, RestoreRequest
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import (flatten_with_paths, get_default_executor,
                                  host_tree_by_path, read_manifest)
    from repro_torch.core.migration import MIGRATION_META_KEY
    from repro_torch.core.predump import (digest_pairs, lane_strings,
                                          leaf_digest, uses_lanes)
    from repro_torch.core.storage import as_tier
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.ckpt_codec.ops import classifier_lanes_many
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    cfg = CONFIG.replace(num_layers=PRECOPY_LAYERS)
    lm = LM(cfg)
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"precopy: {cfg.name} at full width; cut: num_layers "
        f"{CONFIG.num_layers} -> {cfg.num_layers} (the only cut: the image "
        f"holds the weights and the host their mem:// copy); params="
        f"{lm.n_params():,} ({pbytes / 1e9:.3f} GB fp32 on the card), init "
        f"{time.time() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    uri = f"mem://chip-smoke-precopy-{args.seed}"
    out = {"params": lm.n_params(), "layers": cfg.num_layers}

    torch.use_deterministic_algorithms(True)
    ckpt_codec.reset_launches()              # the path's counts start here
    k6.reset_launches()
    a = ServeEngine(lm, params, max_len=max_len)
    a.submit(prompts)
    want = a.generate(SERVE_GEN).copy()
    del a
    log(f"precopy: engine A generated {SERVE_B}x{SERVE_GEN} tokens "
        f"uninterrupted (the reference)")

    p = ServeEngine(lm, params, max_len=max_len)
    p.submit(prompts)

    def tree():
        return {"params": p.params, "session": p.session_state()}
    n_leaves = len(flatten_with_paths(tree()))
    n_params = len(flatten_with_paths(params))
    n_lanes = sum(1 for _, t in flatten_with_paths(tree())
                  if uses_lanes(t) and t.device.type == "cuda")
    cache_paths = [q for q, _ in flatten_with_paths(tree())
                   if q.startswith("session/cache/stack/")]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(p.cache))
    sess = CheckpointSession(uri, device=dev)

    def k5_pass(what, fn):
        """fn() once, checking that one K5 launch classified every
        fp32/bf16 leaf on the card exactly once in it."""
        before = (ckpt_codec.LAUNCHES["digest_blocks"],
                  ckpt_codec.LEAVES["digest_blocks"])
        t0 = time.time()
        rec = fn()
        dt = time.time() - t0
        n = ckpt_codec.LAUNCHES["digest_blocks"] - before[0]
        k = ckpt_codec.LEAVES["digest_blocks"] - before[1]
        check(n == 1 and k == n_lanes,
              f"{what}: digest_blocks launched {n} times over {k} leaves, "
              f"not once over the {n_lanes} fp32/bf16 leaves on the card")
        return rec, dt

    rounds = []
    for r, upto in enumerate(PRECOPY_ROUNDS):
        p.generate(upto)
        torch.cuda.synchronize()
        rec, dt = k5_pass(f"round {r}", lambda: p.checkpoint(
            sess, arch=cfg.name, mode="pre_dump", weights=True))
        st = rec.stats
        rounds.append({"image_id": rec.image_id, "s": dt,
                       "leaves_dirty": st["leaves_dirty"],
                       "leaves_clean": st["leaves_clean"],
                       "bytes_stored": st["bytes_stored"]})
        log(f"precopy: round {r} at token {upto} -> {rec.image_id} in "
            f"{dt:.2f} s through ServeEngine.checkpoint(mode=\"pre_dump\"): "
            f"{st['leaves_dirty']} dirty, {st['leaves_clean']} clean of "
            f"{n_leaves} leaves, {st['bytes_stored'] / 1e9:.3f} GB stored")
        check(rec.image_id == f"step_{upto:010d}p{r:02d}",
              f"round {r} wrote {rec.image_id}")
    out["rounds"] = rounds
    check(rounds[0]["leaves_clean"] == 0
          and rounds[0]["leaves_dirty"] == n_leaves,
          "round 0 (a cold tracker) did not write every leaf")
    m0, m1 = (read_manifest(sess.tier, r["image_id"])["leaves"]
              for r in rounds)
    r0 = {x["path"]: x for x in m0}
    r1 = {x["path"]: x for x in m1}
    reused = [q for q in r1 if q.startswith("params/")
              and r1[q]["chunks"] == r0[q]["chunks"]]
    check(rounds[1]["leaves_clean"] >= n_params and len(reused) == n_params,
          f"round 1 reused {rounds[1]['leaves_clean']} leaves, not every "
          f"one of the {n_params} params leaves")
    for q in cache_paths + ["session/generated"]:
        check(r1[q]["chunks"] != r0[q]["chunks"],
              f"{q} changed between the rounds but was not written")

    # the final (residual) dump through the engine: its migration record
    # holds the tree digest of a host capture that the engine takes and
    # drops; the dump itself gets the live tree and copies only the dirty
    # leaves to the host
    p.generate(PRECOPY_CUT)
    torch.cuda.synchronize()
    fin, dt = k5_pass("the residual dump", lambda: p.checkpoint(
        sess, arch=cfg.name, weights=True))
    out["residual_s"] = fin.duration_s
    out["capture_digest_s"] = dt - fin.duration_s
    st = fin.stats
    out["residual"] = {"image_id": fin.image_id,
                       "leaves_reused": st["leaves_reused"],
                       "bytes_stored": st["bytes_stored"],
                       "bytes_reused": st["bytes_reused"]}
    digest = read_manifest(sess.tier, fin.image_id)["meta"][
        MIGRATION_META_KEY]["state_digest"]
    log(f"precopy: residual dump at token {PRECOPY_CUT} -> {fin.image_id} "
        f"through ServeEngine.checkpoint in {out['residual_s']:.2f} s (apart "
        f"from the migration digest's host capture and SHA-256, "
        f"{out['capture_digest_s']:.2f} s); round 0, in effect the "
        f"monolithic dump of this tree, took {rounds[0]['s']:.2f} s. "
        f"{st['leaves_reused']} leaves reused ({st['bytes_reused'] / 1e9:.3f}"
        f" GB), {st['bytes_stored'] / 1e9:.3f} GB stored against a "
        f"{cache_bytes / 1e9:.3f} GB KV cache")
    check(fin.image_id == f"step_{PRECOPY_CUT:010d}",
          f"the final dump wrote {fin.image_id}")
    check(st["leaves_reused"] >= n_params,
          "the residual dump did not reuse every params leaf")
    check(0 < st["bytes_stored"] <= 1.05 * cache_bytes + 2 ** 20,
          f"the residual dump stored {st['bytes_stored']} bytes, more than "
          f"the {cache_bytes}-byte KV cache")
    # the JAX package's classifier on the same tree, for comparison:
    # capture it to the host, then blake2b every leaf on the cpu pool
    t0 = time.time()
    host = host_tree_by_path(tree())
    out["capture_s"] = time.time() - t0
    t0 = time.time()
    get_default_executor().map_cpu(leaf_digest, host.values())
    out["host_classify_s"] = time.time() - t0
    del host, p, tree
    gc.collect()

    # lazy (post-copy) resume, timed: skeleton, first fault, materialize
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    res = sess.restore(RestoreRequest(lazy=True, prefetch_order=("params",)))
    out["skeleton_s"] = time.time() - t0
    check(res.image_id == fin.image_id,
          f"the lazy restore picked {res.image_id}, not the final image")
    srv = res.state.server
    t0 = time.time()
    emb = res.state["params"]["embed"]["tok"]
    torch.cuda.synchronize()
    out["first_fault_s"] = time.time() - t0
    check(emb.device.type == "cuda" and tuple(emb.shape) == (
        cfg.padded_vocab, cfg.d_model), "the embedding did not fault in "
                                        "onto the card")
    t0 = time.time()
    state = res.state.materialize()
    torch.cuda.synchronize()
    out["materialize_s"] = time.time() - t0
    verified = srv.verify_tree_digest()
    log(f"precopy: lazy resume of {res.image_id}: skeleton in "
        f"{out['skeleton_s']:.3f} s, first fault of params/embed/tok in "
        f"{out['first_fault_s']:.3f} s, materialize (deferred digest "
        f"check included) in {out['materialize_s']:.2f} s; digest verified: "
        f"{verified}; server stats {srv.stats}")
    check(verified is True and srv.expected_digest == digest,
          "the lazy resume did not verify the tree digest")
    lazy_flat = dict(flatten_with_paths(state))
    check(all(t.device.type == "cuda" for t in lazy_flat.values()),
          "a materialized leaf is not on the card")
    del res, srv, emb, state
    gc.collect()

    # engine D resumes the job lazily through its own entry point: it
    # adopts the image's weights and session, then decodes to the end
    d = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    res_d = d.resume_from(CheckpointSession(uri, device=dev), lazy=True,
                          prefetch_order=("params",))
    torch.cuda.synchronize()
    out["engine_resume_s"] = time.time() - t0
    check(res_d.image_id == fin.image_id and res_d.digest_verified is True,
          f"ServeEngine.resume_from(lazy=True) gave {res_d.image_id}, digest "
          f"verified {res_d.digest_verified}")
    d_flat = {**{f"params/{q}": t for q, t in flatten_with_paths(d.params)},
              **{f"session/cache/{q}": t
                 for q, t in flatten_with_paths(d.cache)}}
    check(d.params is not params and all(
        t.device.type == "cuda" and torch.equal(t, lazy_flat[q])
        for q, t in d_flat.items()),
          "engine D did not adopt the image's weights and cache on the card")
    check(np.array_equal(d.generated(), want[:, :PRECOPY_CUT]),
          "the resumed session's tokens differ from engine A's")
    del res_d, d_flat
    got = d.generate(SERVE_GEN)
    same = bool(np.array_equal(got, want))
    out["tokens_equal"] = same
    log(f"precopy: engine D resumed through ServeEngine.resume_from(lazy="
        f"True) in {out['engine_resume_s']:.2f} s (digest verified); its "
        f"tokens {'equal' if same else 'DIFFER FROM'} engine A's at all "
        f"{SERVE_B}x{SERVE_GEN}")
    check(same, "engine D's continuation differs from engine A's tokens")
    del d

    # eager restore of the same image: bitwise the lazily materialized tree
    t0 = time.time()
    eager = CheckpointSession(uri, device=dev).restore(
        RestoreRequest(image_id=fin.image_id))
    torch.cuda.synchronize()
    out["eager_s"] = time.time() - t0
    eager_flat = dict(flatten_with_paths(eager.state))
    check(eager.digest_verified is True, "the eager restore's digest was "
                                         "not verified")
    check(lazy_flat.keys() == eager_flat.keys()
          and all(eager_flat[q].dtype == t.dtype
                  and torch.equal(eager_flat[q], t)
                  for q, t in lazy_flat.items()),
          "the eager restore differs from the lazy one")
    log(f"precopy: eager restore of {fin.image_id} in {out['eager_s']:.2f} s "
        f"(digest verified); bitwise equal to the lazy one at all "
        f"{len(eager_flat)} leaves")
    torch.use_deterministic_algorithms(False)
    del eager, eager_flat

    routes = dict(k6.ROUTE_LAUNCHES)
    launches = {"digest_blocks": ckpt_codec.LAUNCHES["digest_blocks"],
                "flash_attention": k6.LAUNCHES["flash_attention"],
                "codec K1-K4": sum(v for k, v in ckpt_codec.LAUNCHES.items()
                                   if k != "digest_blocks")}
    out["launches"] = launches
    out["k5_leaves"] = k5_leaves = ckpt_codec.LEAVES["digest_blocks"]
    log(f"kernels: pre-copy-path launches digest_blocks="
        f"{launches['digest_blocks']} (one a classification pass, 3 passes)"
        f" over {k5_leaves} leaves ({n_lanes} fp32/bf16 leaves on the card "
        f"x 3), flash_attention="
        f"{launches['flash_attention']} (2 prefills, A and P, x "
        f"{cfg.num_layers} layers: D resumes a session and only decodes; "
        f"wgmma route {routes['wgmma']}, SIMT route {routes['simt']}), "
        f"codec K1-K4 {launches['codec K1-K4']} (lossless image)")
    check(launches["digest_blocks"] == 3 and k5_leaves == 3 * n_lanes,
          f"digest_blocks launched {launches['digest_blocks']} times over "
          f"{k5_leaves} leaves, not 3 times over {3 * n_lanes}")
    check(launches["codec K1-K4"] == 0, "a codec kernel ran on the lossless "
                                        "pre-copy path")
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"not {2 * cfg.num_layers}")
    check(routes == {"wgmma": 2 * cfg.num_layers, "simt": 0},
          f"the pre-copy path's flash_attention launches did not all take "
          f"the wgmma route: {routes}")

    # K5's classification of the same tree (the dumped one), timed after
    # the counts were read, beside the host route above
    pairs = sorted(lazy_flat.items())
    digest_pairs(pairs)                    # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        digest_pairs(pairs)
        times.append(time.time() - t0)
    out["k5_classify_s"] = statistics.median(times)
    # the pass's parts: the grouped launch (CUDA events around the call),
    # the lanes to the host, blake2b of each leaf's lanes on the host
    items = [(p, t) for p, t in pairs if uses_lanes(t)]
    parts = {"kernel_ms": [], "d2h_ms": [], "hash_ms": []}
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lanes, cols = classifier_lanes_many([t for _, t in items])
        b.record()
        b.synchronize()
        parts["kernel_ms"].append(a.elapsed_time(b))
        t0 = time.time()
        host_lanes = lanes.cpu().numpy()
        parts["d2h_ms"].append((time.time() - t0) * 1e3)
        t0 = time.time()
        lane_strings(items, host_lanes, cols)
        parts["hash_ms"].append((time.time() - t0) * 1e3)
    out["k5_classify_parts_ms"] = {k: statistics.median(v)
                                   for k, v in parts.items()}
    out["k5_lane_bytes"] = host_lanes.nbytes
    tree_bytes = sum(t.numel() * t.element_size() for _, t in pairs)
    out["k5_bytes_bound_ms"] = tree_bytes / HBM_BYTES_PER_S * 1e3
    tree_gb = tree_bytes / 1e9
    pm = out["k5_classify_parts_ms"]
    log(f"precopy: classifying the {tree_gb:.2f} GB tree: K5 on the card "
        f"{out['k5_classify_s'] * 1e3:.1f} ms (host clock, lanes to host "
        f"and hashing included): the grouped launch {pm['kernel_ms']:.3f} ms"
        f" (CUDA events, one call), the {host_lanes.nbytes / 1e6:.2f} MB of "
        f"lanes to the host {pm['d2h_ms']:.3f} ms, blake2b of the lanes "
        f"{pm['hash_ms']:.3f} ms, beside the bytes bound "
        f"{out['k5_bytes_bound_ms']:.3f} ms; the JAX package's route "
        f"(blake2b of the host capture on the cpu pool) "
        f"{out['host_classify_s']:.2f} s, after a {out['capture_s']:.2f} s "
        f"device-to-host capture")
    del lazy_flat, pairs, params
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


# ---------------------------------------------------------- lifecycle path
# path 7: the training CLI in fresh processes, at the train path's width and
# depth (the same cut, for the same reason), K steps in all three runs (the
# LR schedule's total_steps depends on K); SIGTERM after the line of step
# LIFECYCLE_SIGNAL_AT, one pre-copy round
LIFECYCLE_STEPS, LIFECYCLE_SIGNAL_AT = 10, 3
LIFECYCLE_MODEL = ["--full", "--layers", str(LIFECYCLE_LAYERS)]
LIFECYCLE_BATCH = ["--global-batch", "2", "--seq-len", "512"]
# the child's own counters and clocks, read by a wrapper this script owns:
# the launcher runs unchanged under runpy, and an atexit hook prints what
# it measured as one JSON line on stderr (after sys.exit(85) too)
LIFECYCLE_WRAPPER = r"""
import atexit, json, os, runpy, sys, threading, time
import torch
from repro_torch.api.session import CheckpointSession as S
from repro_torch.kernels.ckpt_codec import ckpt_codec
from repro_torch.kernels.flash_attention import flash_attention as k6
rec = {"calls": {}}
# this process's own host peak, sampled every 20 ms from /proc/self/statm
# (ru_maxrss would carry the parent's peak across fork)
peak = [0]

def sample(page=os.sysconf("SC_PAGE_SIZE")):
    while True:
        with open("/proc/self/statm") as f:
            peak[0] = max(peak[0], int(f.read().split()[1]) * page)
        time.sleep(0.02)

threading.Thread(target=sample, daemon=True).start()

def timed(name, fn):
    def run(*a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        row = {"s": time.time() - t0}
        st = out.get("stats") if isinstance(out, dict) else None
        if st:
            row.update(bytes_stored=st["bytes_stored"],
                       leaves_reused=st.get("leaves_reused"),
                       image_id=out["image_id"])
        if hasattr(out, "digest_verified"):
            row.update(digest_verified=out.digest_verified,
                       image_id=out.image_id)
        rec["calls"].setdefault(name, []).append(row)
        return out
    return run

for name in ("pre_dump_round", "save", "restore", "migrate"):
    setattr(S, name, timed(name, getattr(S, name)))

@atexit.register
def report():
    rec["launches"] = {**ckpt_codec.LAUNCHES, **k6.LAUNCHES}
    rec["k5_leaves"] = ckpt_codec.LEAVES["digest_blocks"]
    rec["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.cuda.is_available() else 0)
    rec["host_peak_rss_bytes"] = peak[0]
    print("LIFECYCLE " + json.dumps(rec), file=sys.stderr, flush=True)

sys.argv = ["repro_torch.launch.train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__",
                 alter_sys=True)
"""


class Child:
    """One launcher process under the wrapper: stdout lines stamped on
    arrival, stderr to a file, the wrapper's record parsed at the end."""

    def __init__(self, flags, tmp, name, device, started: list):
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.err_path = os.path.join(tmp, f"{name}.stderr")
        self.metrics = os.path.join(tmp, f"{name}.json")
        self.t0 = time.time()
        with open(self.err_path, "w") as err:
            self.p = subprocess.Popen(
                [sys.executable, "-u", "-c", LIFECYCLE_WRAPPER, *flags,
                 "--device", str(device), "--metrics-file", self.metrics],
                env=env, stdout=subprocess.PIPE, stderr=err, text=True,
                cwd=tmp)
        started.append(self.p)          # the caller kills what is left
        self.lines = []                 # (seconds since start, line)

    def __iter__(self):
        for ln in self.p.stdout:
            self.lines.append((time.time() - self.t0, ln.rstrip("\n")))
            log(f"  [{self.lines[-1][0]:7.2f} s] {self.lines[-1][1]}")
            yield ln

    def finish(self, timeout=900, record=True):
        """Wait for the child -> its exit code. ``record``: the wrapper's
        record must be there (a SIGKILLed child never writes one)."""
        for _ in self:
            pass
        rc = self.p.wait(timeout=timeout)
        self.wall_s = time.time() - self.t0
        self.rc = rc
        if not record:
            return rc
        with open(self.err_path) as f:
            err = f.read()
        recs = [ln[len("LIFECYCLE "):] for ln in err.splitlines()
                if ln.startswith("LIFECYCLE ")]
        check(recs, f"no wrapper record from the child (rc {rc}); stderr "
                    f"ends: {err[-3000:]}")
        self.rec = json.loads(recs[-1])
        return rc

    def at(self, text):
        """Seconds since start of the first line holding ``text``."""
        for t, ln in self.lines:
            if text in ln:
                return t
        raise CheckFailed(f"no line with {text!r}")

    def losses(self) -> dict:
        with open(self.metrics) as f:
            return {r["step"]: r["loss"] for r in json.load(f)}


def lifecycle_path(torch, dev, args, beside=None, beside_resume=None):
    """Preempt-to-migrate of a training job through the port's CLI
    (python -m repro_torch.launch.train), in fresh processes: a reference
    run; a run SIGTERMed after step LIFECYCLE_SIGNAL_AT's line, which must
    take a pre-dump round, dump the migration image and exit 85; a
    --resume in a new process, which must verify the digest and continue
    with the reference's losses. K5 must classify every fp32 leaf of the
    train state on the card in the round and in the residual dump.
    ``beside`` (paths 13 and 6) runs on a thread while the preempted
    child runs alone, which holds a third of the card and leaves this
    process idle; its result is ``out["beside"]``. The reference runs
    beside the resume, once ``beside`` has returned: two lifecycle
    children and an in-process path would not fit the card together.
    ``beside_resume`` (work with little of the card: path 12 (b)'s
    subprocesses, path 17's trace on meta) runs on a thread beside those
    two; its result is ``out["beside_resume"]``."""
    import shutil
    import signal as _signal
    import tempfile

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import flatten_with_paths
    from repro_torch.models.model import LM
    from repro_torch.training import abstract_train_state

    cfg = CONFIG.replace(num_layers=LIFECYCLE_LAYERS)
    struct = flatten_with_paths(abstract_train_state(LM(cfg)))
    state_bytes = sum(t.numel() * t.element_size() for _, t in struct)
    n_fp32 = sum(1 for _, t in struct if t.dtype == torch.float32)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-lifecycle-",
                           dir=args.lifecycle_dir)
    out = {"leaves": len(struct), "fp32_leaves": n_fp32,
           "state_bytes": state_bytes, "dir": tmp}
    started = []
    try:
        # two full images (the round and the residual) on local disk
        need = 2 * state_bytes * 1.1 + 2e9
        free = shutil.disk_usage(tmp).free
        log(f"lifecycle: {cfg.name} at full width, num_layers {CONFIG.num_layers}"
            f" -> {cfg.num_layers}; train state "
            f"{state_bytes / 1e9:.2f} GB in {len(struct)} leaves ({n_fp32} "
            f"fp32); {tmp}: {free / 1e9:.1f} GB free, the two images need "
            f"{need / 1e9:.1f} GB")
        check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free, the "
                            f"lifecycle's two images need {need / 1e9:.1f} GB; "
                            f"pass --lifecycle-dir on a larger disk")
        base = (LIFECYCLE_MODEL + LIFECYCLE_BATCH
                + ["--steps", str(LIFECYCLE_STEPS), "--log-every", "1",
                   "--data-dir", os.path.join(tmp, "data")])
        ck = ["--ckpt-dir", "file://" + os.path.join(tmp, "ck")]

        log(f"lifecycle: the preempted run (SIGTERM after the line of step "
            f"{LIFECYCLE_SIGNAL_AT}, --predump-rounds 1)"
            + (" beside paths 13 and 6 in this process" if beside else ""))
        side = Beside(beside) if beside else None
        try:
            pre = Child(base + ck + ["--predump-rounds", "1"], tmp,
                        "preempted", dev, started)
            t_sig = None
            for ln in pre:
                if t_sig is None and f'"step": {LIFECYCLE_SIGNAL_AT},' in ln:
                    pre.p.send_signal(_signal.SIGTERM)
                    t_sig = time.time() - pre.t0
            rc = pre.finish()
            out["preempted_wall_s"] = pre.wall_s
        finally:
            if side:                    # its processes end with it
                side.thread.join()
        if side:
            out["beside"] = side.join()
        check(t_sig is not None, "the preempted run never logged step "
                                 f"{LIFECYCLE_SIGNAL_AT}")
        out["signal_to_exit_s"] = pre.wall_s - t_sig
        text = "\n".join(ln for _, ln in pre.lines)
        check(rc == 85, f"the preempted run exited {rc}, not 85")
        i_round = text.find("pre-dump round ->")
        i_pre = text.find("preemption (SIGTERM)")
        i_dur = text.find("migration image durable")
        check(0 <= i_round < i_pre < i_dur,
              "the preempted run did not print the pre-dump round, then the "
              "preemption, then the durable image")
        calls = pre.rec["calls"]
        rnd, (res_dump,) = calls["pre_dump_round"], calls["save"]
        check(len(rnd) == 1, f"{len(rnd)} pre-dump rounds, not 1")
        (mig,) = calls["migrate"]
        out.update(round_s=rnd[0]["s"], round_bytes=rnd[0]["bytes_stored"],
                   residual_s=res_dump["s"],
                   residual_bytes=res_dump["bytes_stored"],
                   residual_reused=res_dump["leaves_reused"],
                   migrate_s=mig["s"],
                   digest_s=mig["s"] - res_dump["s"],
                   preempted_peak_device_gb=pre.rec["peak_device_bytes"] / 1e9,
                   preempted_host_peak_gb=pre.rec["host_peak_rss_bytes"] / 1e9)
        launches = pre.rec["launches"]
        out["launches"] = launches
        log(f"lifecycle: signal -> exit 85: {out['signal_to_exit_s']:.2f} s")
        log(f"lifecycle: pre-dump round: {out['round_s']:.2f} s, "
            f"{out['round_bytes'] / 1e9:.3f} GB stored")
        log(f"lifecycle: residual dump: {out['residual_s']:.2f} s, "
            f"{out['residual_bytes'] / 1e9:.3f} GB stored, "
            f"{out['residual_reused']} leaves reused")
        log(f"lifecycle: residual bytes / round 0's: "
            f"{out['residual_bytes'] / out['round_bytes']:.4f} (every leaf "
            f"of a training state changes every step)")
        log(f"lifecycle: migrate {out['migrate_s']:.2f} s, of it the "
            f"migration digest's host capture and SHA-256 "
            f"{out['digest_s']:.2f} s")
        log("kernels: lifecycle-path launches (preempted child) " + " ".join(
            f"{k}={v}" for k, v in launches.items()))
        out["k5_leaves"] = pre.rec["k5_leaves"]
        log(f"kernels: lifecycle-path K5 launches {launches['digest_blocks']}"
            f" over {out['k5_leaves']} leaves (the round and the residual "
            f"dump, one launch each over the {n_fp32} fp32 leaves)")
        check(launches["digest_blocks"] == 2
              and out["k5_leaves"] == 2 * n_fp32,
              f"digest_blocks launched {launches['digest_blocks']} times "
              f"over {out['k5_leaves']} leaves in the preempted child, not "
              f"twice (the round and the residual dump) over "
              f"{2 * n_fp32} (the {n_fp32} fp32 leaves each time)")
        check(all(v == 0 for k, v in launches.items()
                  if k != "digest_blocks"),
              f"a kernel other than K5 ran on the lossless lifecycle path: "
              f"{launches}")

        # the reference beside the resume (its own copy of the seeded
        # data: the two would write the same shards at once); its lines
        # are read once the resume has exited
        log("lifecycle: resume (--resume, a fresh process) beside the "
            "reference run (no checkpoint dir)")
        t_phase = time.time()
        side = Beside(beside_resume) if beside_resume else None
        try:
            ref = Child(base[:-1] + [os.path.join(tmp, "data-reference")],
                        tmp, "reference", dev, started)
            res = Child(base + ck + ["--resume"], tmp, "resumed", dev,
                        started)
            res.finish()
            check(ref.finish() == 0, f"the reference run exited {ref.rc}")
        finally:
            if side:                    # its processes end with it
                side.thread.join()
        if side:
            out["beside_resume"] = side.join()
        out["resume_phase_wall_s"] = time.time() - t_phase
        want = ref.losses()
        check(sorted(want) == list(range(1, LIFECYCLE_STEPS + 1)),
              f"the reference logged steps {sorted(want)}")
        check(res.rc == 0, f"the resumed run exited {res.rc}")
        line = next((ln for _, ln in res.lines if "resumed from" in ln), "")
        check("(migrated: SIGTERM)" in line,
              f"the resume did not report the migration: {line!r}")
        (rst,) = res.rec["calls"]["restore"]
        check(rst["digest_verified"] is True,
              "the resume did not verify the migration image's digest")
        got = res.losses()
        at = int(line.split(" at step ")[1].split()[0])
        check(sorted(got) == list(range(at + 1, LIFECYCLE_STEPS + 1)),
              f"the resumed run logged steps {sorted(got)} after step {at}")
        pre_losses = pre.losses()
        worst = 0.0
        for s_, loss in list(got.items()) + list(pre_losses.items()):
            rel = abs(loss - want[s_]) / abs(want[s_])
            worst = max(worst, rel)
            check(rel <= 1e-5, f"step {s_}: loss {loss} vs the reference's "
                               f"{want[s_]} ({rel:.2e} relative)")
        t_resumed = res.at("resumed from")
        t_first = res.at(f'"step": {at + 1},')
        out.update(resume_step=at, restore_s=rst["s"],
                   resume_to_first_step_s=t_first,
                   resumed_line_to_first_step_s=t_first - t_resumed,
                   resumed_peak_device_gb=res.rec["peak_device_bytes"] / 1e9,
                   resumed_host_peak_gb=res.rec["host_peak_rss_bytes"] / 1e9,
                   reference_peak_device_gb=ref.rec["peak_device_bytes"] / 1e9,
                   reference_host_peak_gb=ref.rec["host_peak_rss_bytes"] / 1e9,
                   worst_rel_loss=worst, resumed_losses=got,
                   reference_losses=want)
        log(f"lifecycle: resumed {rst['image_id']} at step {at} (digest "
            f"verified); its {len(got)} losses and the preempted run's "
            f"{len(pre_losses)} within {worst:.2e} relative of the "
            f"reference's (limit 1e-5)")
        log(f"lifecycle: resume -> first step: {t_first:.2f} s from process "
            f"start (the restore {rst['s']:.2f} s, first step line "
            f"{out['resumed_line_to_first_step_s']:.2f} s after the resumed "
            f"line)")
        log(f"lifecycle: peak device memory (max_memory_allocated) reference "
            f"{out['reference_peak_device_gb']:.1f} GB, preempted "
            f"{out['preempted_peak_device_gb']:.1f} GB, resumed "
            f"{out['resumed_peak_device_gb']:.1f} GB; host peak RSS "
            f"{out['reference_host_peak_gb']:.1f} / "
            f"{out['preempted_host_peak_gb']:.1f} / "
            f"{out['resumed_host_peak_gb']:.1f} GB")
        check(res.rec["launches"]["digest_blocks"] == 0
              and ref.rec["launches"]["digest_blocks"] == 0,
              "K5 ran in a run without pre-copy")
    finally:
        for p in started:               # a failed check leaves none running
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------- remote path
REMOTE_URI = ("remote://chip-remote?latency_ms=2&bw_mbps=1000&fail_rate=0.02"
              "&max_consecutive=1&seed={seed}")
FRONT_URI = "cache+remote://chip-remote?front={front}&cache={cache}"


def remote_path(torch, dev, args):
    """The train path's state through a faulty object store onto a fresh
    host front: train 3 steps -> image A (lossless) into remote:// -> 1
    step -> image B (opt/m delta8 against A, opt/v bf16) into the same
    store -> restore B through cache+remote://...?front=hostB (a fresh hot
    front on local disk, standing for another compute resource) -> the
    train path's bit rules -> 2 steps from the restored and the live state
    -> a lazy restore of B through front=hostC faulting params/embed/tok,
    then the same fault again on hostC's warm front (0 remote GETs). The
    store's clock is virtual: its network seconds are simulated, never
    slept. K1-K4 must have launched (counters zeroed just before)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import as_tier, dump, flatten_with_paths, restore
    from repro_torch.core.lazy import lazy_restore
    from repro_torch.core.remote import reset_tier_registry
    from repro_torch.core.restore import read_manifest
    from repro_torch.device import to_host
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step)

    cfg = CONFIG.replace(num_layers=LIFECYCLE_LAYERS)
    lm = LM(cfg)
    uri = REMOTE_URI.format(seed=args.seed)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-remote-",
                           dir=args.lifecycle_dir)
    out = {"uri": uri}
    try:
        state_bytes = sum(t.numel() * t.element_size() for _, t in
                          flatten_with_paths(abstract_train_state(lm)))
        # hostB's front holds B and A's opt/m (the delta8 baseline), hostC's
        # the embedding
        need = 1.1 * state_bytes + 2e9
        free = shutil.disk_usage(tmp).free
        log(f"remote: {cfg.name} at full width, num_layers "
            f"{CONFIG.num_layers} -> {cfg.num_layers}; "
            f"store {uri}; hot fronts under {tmp}: {free / 1e9:.1f} GB free, "
            f"they need {need / 1e9:.1f} GB")
        check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free, the hot "
                            f"fronts need {need / 1e9:.1f} GB")
        remote = as_tier(uri)
        store = remote.store
        rng = np.random.default_rng(args.seed + 8)

        def batch():
            t = rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int64)
            return {"tokens": torch.from_numpy(t).to(dev)}

        state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                                 device=dev)
        step = make_train_step(lm, OptConfig())
        losses = []
        for _ in range(3):
            state, m = step(state, batch())
            losses.append(float(m["loss"]))
        check(all(np.isfinite(v) for v in losses), f"losses {losses}")

        ckpt_codec.reset_launches()      # the path's counts start here
        torch.cuda.synchronize()
        t0 = time.time()
        ra = dump(state, remote, step=3, device=dev, device_codec="auto")
        out["dump_a_s"] = time.time() - t0
        out["a_gb"] = ra["stats"]["bytes_stored"] / 1e9
        log(f"remote: image A {ra['image_id']} lossless in "
            f"{out['dump_a_s']:.2f} s wall: {out['a_gb']:.3f} GB stored")
        prev = {p: to_host(t) for p, t in flatten_with_paths(state)
                if p.startswith("opt/m/")}
        state, m = step(state, batch())
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        t0 = time.time()
        rb = dump(state, remote, step=4, parent=ra["image_id"],
                  codec_policy=policy_b, prev_host_tree=prev, device=dev,
                  device_codec="auto")
        out["dump_b_s"] = time.time() - t0
        out["b_gb"] = rb["stats"]["bytes_stored"] / 1e9
        log(f"remote: image B {rb['image_id']} (parent {ra['image_id']}) in "
            f"{out['dump_b_s']:.2f} s wall: {out['b_gb']:.3f} GB stored, "
            f"{rb['stats']['leaves_device']} leaves through the device "
            f"codec stage")
        check(rb["stats"]["leaves_device"] > 0,
              "no leaf went through the device stage")
        rs, ss = dict(remote.stats), dict(store.stats)
        out.update(parts=rs["parts_uploaded"],
                   multipart_uploads=rs["multipart_uploads"],
                   faults_injected=ss["faults_injected"],
                   retries=rs["retries"], store_gb=ss["bytes_in"] / 1e9,
                   simulated_dump_s=store.clock.now)
        log(f"remote: store after A and B: {out['parts']} multipart parts in "
            f"{out['multipart_uploads']} uploads, {out['faults_injected']} "
            f"transient faults injected, {out['retries']} retried; "
            f"{out['store_gb']:.3f} GB in; simulated network time "
            f"{out['simulated_dump_s']:.2f} s (simulated, not slept)")
        check(out["parts"] > 1, "no multipart upload")
        check(out["faults_injected"] > 0 and out["retries"] > 0,
              "no transient fault was injected and retried")
        prev = {p: torch.from_numpy(a).to(dev) for p, a in prev.items()}

        front_b = as_tier(FRONT_URI.format(front="hostB",
                                           cache=os.path.join(tmp, "hostB")))
        gets0, clock0 = store.stats["gets"], store.clock.now
        t0 = time.time()
        tree, man = restore(front_b, rb["image_id"], device=dev,
                            expected=abstract_train_state(lm))
        torch.cuda.synchronize()
        out["restore_b_s"] = time.time() - t0
        out["restore_gets"] = store.stats["gets"] - gets0
        out["simulated_restore_s"] = store.clock.now - clock0
        payload = sum(1 for r in man["leaves"] if "digest" in r["codec_meta"])
        manifests = [read_manifest(front_b, i)["image_id"]
                     for i in (rb["image_id"], ra["image_id"])]
        nchunks = sum(len(r["chunks"]) for r in man["leaves"])
        log(f"remote: restore B through front=hostB (empty hot front on "
            f"local disk) in {out['restore_b_s']:.2f} s wall, "
            f"{out['restore_gets']} remote GETs, simulated network time "
            f"{out['simulated_restore_s']:.2f} s; {payload} payload digests "
            f"re-derived from the stored bytes and verified, the manifest "
            f"digests of {' and '.join(manifests)} verified on read, "
            f"{nchunks} chunks' SHA-256 verified")
        check(payload > 0, "image B carries no payload digest")
        check(front_b.stats["cold_reads"] > 0, "restore B never read the "
                                               "remote store")
        out["m_err_over_half_scale"] = check_restored_b(torch, state, tree,
                                                        prev)
        log("remote: params and step bit-identical; opt/v equals the bf16 "
            "round trip of the live v bitwise; opt/m within each block's "
            f"scale/2 (worst error / (scale/2) = "
            f"{out['m_err_over_half_scale']:.4f})")
        del prev
        # B's embedding, for the lazy faults below (the steps update the
        # live tensors in place)
        want_tok = state["params"]["embed"]["tok"].clone()
        out["continue"], tree, state = continue_both(
            torch, step, tree, state, [batch() for _ in range(2)], "remote")
        out["continue_equal"] = out["continue"]["restored"] == \
            out["continue"]["live"]
        out["launches"] = {k: v for k, v in ckpt_codec.LAUNCHES.items()
                           if k != "digest_blocks"}
        log("kernels: remote-path launches " + " ".join(
            f"{k}={v}" for k, v in out["launches"].items()))
        for k, v in out["launches"].items():
            check(v > 0, f"kernel {k} was not launched on the remote path")
        del tree, state

        # post-copy onto a third host: skeleton, a ranged fault and the
        # embedding, then the same fault again on the now-warm front
        front_c = as_tier(FRONT_URI.format(front="hostC",
                                           cache=os.path.join(tmp, "hostC")))
        gets0 = store.stats["gets"]
        t0 = time.time()
        lazy, _, srv = lazy_restore(front_c, rb["image_id"], prefetch=False,
                                    device=dev)
        out["lazy_skeleton_s"] = time.time() - t0
        t0 = time.time()
        head = srv.read_range("params/embed/tok", 0, 1 << 20)
        out["lazy_range_s"] = time.time() - t0
        check(head == to_host(want_tok).tobytes()[:1 << 20],
              "the ranged read of params/embed/tok differs from the live "
              "leaf")
        t0, clock0 = time.time(), store.clock.now
        tok = lazy["params"]["embed"]["tok"]
        torch.cuda.synchronize()
        out["lazy_fault_s"] = time.time() - t0
        out["simulated_fault_s"] = store.clock.now - clock0
        out["lazy_gets"] = store.stats["gets"] - gets0
        check(torch.equal(tok, want_tok), "the faulted params/embed/tok is "
                                          "not bit-identical")
        del tok, lazy, srv
        gets0 = store.stats["gets"]
        lazy, _, srv = lazy_restore(front_c, rb["image_id"], prefetch=False,
                                    device=dev)
        t0 = time.time()
        tok = lazy["params"]["embed"]["tok"]
        torch.cuda.synchronize()
        out["warm_fault_s"] = time.time() - t0
        out["warm_gets"] = store.stats["gets"] - gets0
        check(torch.equal(tok, want_tok), "the warm fault of "
                                          "params/embed/tok is not "
                                          "bit-identical")
        log(f"remote: lazy restore of B through front=hostC: skeleton "
            f"{out['lazy_skeleton_s']:.3f} s, a 1 MiB ranged read of "
            f"params/embed/tok {out['lazy_range_s']:.3f} s, first fault of "
            f"params/embed/tok ({want_tok.numel() * 4 / 1e9:.2f} GB) "
            f"{out['lazy_fault_s']:.2f} s wall with {out['lazy_gets']} "
            f"remote GETs (simulated network time "
            f"{out['simulated_fault_s']:.2f} s); the same fault on hostC's "
            f"warm front "
            f"{out['warm_fault_s']:.2f} s with {out['warm_gets']} remote GETs "
            f"(skeleton included)")
        check(out["lazy_gets"] > 0, "the first fault read nothing remote")
        check(out["warm_gets"] == 0, f"the warm fault cost "
                                     f"{out['warm_gets']} remote GETs, not 0")
        out["gets"] = store.stats["gets"]
        out["simulated_total_s"] = store.clock.now
        del tok, lazy, srv, want_tok
    finally:
        reset_tier_registry()             # the store's objects go with it
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -------------------------------------------------------------- plane path
# path 9: gemma2-2b at full width and depth through SessionManager. Pool:
# 8 slots of 4800 positions (8 x 4800 x 106,496 B of bf16 KV = 4.09 GB);
# traffic as below (seed 0: the pool first fills at tick 17 and, after the
# cut, stays full with a queue); one scripted 4608-token prompt passes the
# 4096 window of the even layers; R runs PLANE_TICKS ticks, the source
# PLANE_CUT, and the replicas the rest; at the cut every slot but one is
# busy, and nov0, arriving then, takes the last.
PLANE_SLOTS, PLANE_PAGE = 8, 4800
# gemma2-2b cut from 26 layers to 14 (7 of its 13 local/global pairs):
# the schedule depends on the slots only, and with path 12 (a) after it
# the path ends about when path 16 beside it does
PLANE_LAYERS = 14
PLANE_TRAFFIC = dict(rate=1.5, prompt_support=(256, 512, 1024, 2048),
                     target_max=32)
PLANE_LONG = (4608, 48)        # long0: prompt tokens, target
PLANE_NOV = (300, 8)           # nov0, submitted at the cut
PLANE_TICKS, PLANE_CUT = 28, 19


class PlaneClock:
    """Seconds of every prefill (a wrapper on ``lm.prefill``, synced) and of
    every tick's decode (the wall of ``mgr.run(1)``, the tick's prefills
    taken out), for each plane driven through ``drive``."""

    def __init__(self, torch, lm):
        self.prefills, self.ticks = [], []
        self.plane, self.lm = None, lm
        prefill = lm.prefill

        def timed(params, *, tokens, **kw):
            t0 = time.perf_counter()
            res = prefill(params, tokens=tokens, **kw)
            torch.cuda.synchronize()
            self.prefills.append((self.plane, int(tokens.shape[1]),
                                  time.perf_counter() - t0))
            return res
        lm.prefill = timed

    def close(self):
        del self.lm.prefill               # the class's method again

    def drive(self, plane, mgr, gen, ticks):
        self.plane = plane
        for _ in range(ticks):
            n0, b0 = len(self.prefills), mgr.stats["decode_batches"]
            tok0 = mgr.tokens_done
            t0 = time.perf_counter()
            mgr.run(1, traffic=gen)
            wall = time.perf_counter() - t0
            pre = self.prefills[n0:]
            # (plane, decode s, cohorts, sessions decoded: a prefill's
            # first token is not a decode)
            self.ticks.append((plane, wall - sum(x[2] for x in pre),
                               mgr.stats["decode_batches"] - b0,
                               mgr.tokens_done - tok0 - len(pre)))


def _plane_outputs(mgr, skip=()):
    return {sid: s.output().tolist() for sid, s in mgr.sessions.items()
            if s.status != "rejected" and sid not in skip}


def plane_path(torch, dev, args, planned=None):
    """The live serving plane (Table-1 row 16) on gemma2-2b at full width,
    PLANE_LAYERS of its 26 layers: reference R uninterrupted; the source
    plane to the cut, then drain and checkpoint into mem://; replica B
    restored eagerly and replica C lazily (nov0's first token before
    complete_restore), both
    continued to PLANE_TICKS. Every session's tokens in B and C must equal
    R's; every prefill attention through K6 (the wgmma route at head dim
    256). Then long0's 1 x 4608 prefill against the dry run's record
    (``planned``: plane_record()'s result, or traced here when None)."""
    import numpy as np

    from repro_torch.api import CheckpointSession
    from repro_torch.configs.gemma2_2b import CONFIG
    from repro_torch.core.storage import as_tier
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models import kvcache
    from repro_torch.models.model import LM
    from repro_torch.serving import Request, SessionManager, TrafficGenerator

    cfg = CONFIG.replace(num_layers=PLANE_LAYERS)
    lm = LM(cfg)
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    slot_bytes = kvcache.cache_bytes(cfg, 1, PLANE_PAGE)
    out = {"params": lm.n_params(), "layers": cfg.num_layers,
           "params_gb": pbytes / 1e9,
           "pool_gb": PLANE_SLOTS * slot_bytes / 1e9}
    log(f"plane: {cfg.name} at full width ({cfg.num_layers} of "
        f"{CONFIG.num_layers} layers, the only cut; d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, windows {cfg.windows}, softcaps "
        f"{cfg.attn_softcap}/{cfg.final_softcap}); params="
        f"{lm.n_params():,} ({pbytes / 1e9:.2f} GB fp32 on the card), init "
        f"{time.time() - t0:.1f} s; pool {PLANE_SLOTS} slots x "
        f"{PLANE_PAGE} = {out['pool_gb']:.2f} GB bf16")
    rng = np.random.default_rng(args.seed + 9)
    long0 = Request("long0", 0.0, rng.integers(
        0, cfg.vocab_size, PLANE_LONG[0]).astype(np.int32), PLANE_LONG[1],
        args.seed * 100_000 + 99_990)
    nov0 = Request("nov0", float(PLANE_CUT), rng.integers(
        0, cfg.vocab_size, PLANE_NOV[0]).astype(np.int32), PLANE_NOV[1],
        args.seed * 100_000 + 99_991)

    def traffic():
        return TrafficGenerator(seed=args.seed, vocab_size=cfg.vocab_size,
                                **PLANE_TRAFFIC)

    def plane(p):
        return SessionManager(lm, p, slots=PLANE_SLOTS, page_len=PLANE_PAGE,
                              device=dev)
    uri = f"mem://chip-smoke-plane-{args.seed}"
    torch.use_deterministic_algorithms(True)   # R, B and C must agree
    k6.reset_launches()                        # the path's counts
    prefills = 0

    # reference R: uninterrupted, nov0 at the cut
    clock = PlaneClock(torch, lm)
    r = plane(params)
    gen = traffic()
    t0 = time.time()
    r.submit(long0)
    clock.drive("R", r, gen, PLANE_CUT)
    r.submit(nov0)
    clock.drive("R", r, gen, PLANE_TICKS - PLANE_CUT)
    out["reference_s"] = time.time() - t0
    want = _plane_outputs(r)
    prefills += r.stats["prefills"]
    out["stats"] = dict(r.stats)
    by_len: dict = {}
    for _, n, sec in clock.prefills:          # R's so far
        by_len.setdefault(n, []).append(sec)
    out["prefill_s_by_len"] = {str(n): v for n, v in sorted(by_len.items())}
    ticks = [t for t in clock.ticks if t[2]]
    full = [t for t in ticks if t[3] == PLANE_SLOTS]
    out["decode_s_per_tick"] = statistics.median(t[1] for t in ticks)
    out["cohorts_per_tick"] = statistics.mean(t[2] for t in clock.ticks)
    out["decode_s_per_cohort"] = (sum(t[1] for t in ticks)
                                  / sum(t[2] for t in ticks))
    out["full_pool_ticks"] = len(full)
    check(full, "the pool was never full in R")
    out["full_pool_decode_s_per_tick"] = statistics.median(t[1] for t in full)
    out["full_pool_cohorts_per_tick"] = statistics.mean(t[2] for t in full)
    long_pos = r.sessions["long0"].pos
    check(all(0 <= t < cfg.vocab_size for v in want.values() for t in v),
          "plane tokens out of range")
    check(r.sessions["nov0"].n == PLANE_NOV[1], "nov0 did not finish in R")
    check(long_pos > cfg.windows[0], f"long0 stopped at {long_pos}, inside "
                                     f"the {cfg.windows[0]} window")
    log(f"plane: reference R {PLANE_TICKS} ticks in {out['reference_s']:.1f} "
        f"s: {r.stats['admitted']} admitted, {r.stats['completed']} "
        f"completed, {r.stats['rejected']} rejected, "
        f"{r.stats['decode_batches']} cohort decodes; long0 at position "
        f"{long_pos} (window {cfg.windows[0]})")
    log("plane: prefill s by prompt length: " + "; ".join(
        f"{n}: " + ", ".join(f"{x:.3f}" for x in v)
        for n, v in by_len.items()))
    log(f"plane: decode {out['decode_s_per_tick']:.3f} s per tick (median "
        f"of ticks with a cohort), {out['cohorts_per_tick']:.2f} cohorts per "
        f"tick, {out['decode_s_per_cohort']:.3f} s per cohort decode; at a "
        f"full pool ({PLANE_SLOTS} sessions decoded, {len(full)} ticks of R) "
        f"{out['full_pool_decode_s_per_tick']:.3f} s per tick, "
        f"{out['full_pool_cohorts_per_tick']:.2f} cohorts per tick")
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # the source plane: to the cut, drain, dump; freed after the dump
    src = plane(params)
    gen = traffic()
    src.submit(long0)
    clock.drive("source", src, gen, PLANE_CUT)
    src.drain()
    prefills += src.stats["prefills"]
    in_flight = set(src.live_sids())
    out["in_flight_at_cut"] = len(in_flight)
    # every slot busy but the one nov0 takes at the cut, nobody queued
    check(src.used_slots == len(in_flight) == PLANE_SLOTS - 1,
          f"at the cut {src.used_slots} slots are busy and {len(in_flight)} "
          f"sessions in flight, not {PLANE_SLOTS - 1} each")
    out["admitted_at_cut"] = src.stats["admitted"]
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    receipt = src.checkpoint(sess, traffic=gen.state())
    out["dump_s"] = time.time() - t0
    out["image_gb"] = receipt.stats["bytes_stored"] / 1e9
    out["image_logical_gb"] = (pbytes + PLANE_SLOTS * slot_bytes) / 1e9
    log(f"plane: source drained at clock {src.clock} with "
        f"{len(in_flight)} sessions in flight ({sorted(in_flight)}), "
        f"{src.used_slots} of {PLANE_SLOTS} slots busy; "
        f"checkpoint {receipt.image_id} in {out['dump_s']:.2f} s: "
        f"{out['image_gb']:.3f} GB stored of {out['image_logical_gb']:.2f} "
        f"GB (params + pool; unused pages dedup)")
    check("long0" in in_flight, "long0 finished before the cut")
    del src, params
    gc.collect()
    torch.cuda.empty_cache()

    def continue_replica(mgr, res, label):
        table = res.manifest["meta"]["serve_plane"]
        gen = TrafficGenerator.from_state(table["traffic"])
        clock.drive(label, mgr, gen, PLANE_TICKS - PLANE_CUT)
        got = _plane_outputs(mgr, skip=set(table["completed"]))
        bad = [sid for sid in sorted(got) if got[sid] != want.get(sid)]
        mine = [t for t in clock.ticks if t[0] == label]
        out[f"replica_{label[0]}_decode_s_per_tick"] = statistics.median(
            t[1] for t in mine)
        log(f"plane: replica {label}: {len(mine)} ticks, "
            f"{sum(t[3] == PLANE_SLOTS for t in mine)} with every slot "
            f"decoding, {statistics.mean(t[2] for t in mine):.2f} cohorts and "
            f"{out[f'replica_{label[0]}_decode_s_per_tick']:.3f} s of decode "
            f"per tick (median)")
        log(f"plane: replica {label}: {len(got)} sessions ("
            f"{len(in_flight & set(got))} in flight at the cut, nov0, "
            f"{len(set(got) - in_flight - {'nov0'})} admitted after it) "
            f"{'equal' if not bad else 'DIFFER FROM'} R's tokens")
        check(in_flight <= set(got) and "nov0" in got,
              f"replica {label} dropped sessions")
        check(not bad, f"replica {label}'s tokens differ from R's: {bad}")
        return mgr.stats["prefills"]

    # replica B: eager
    t0 = time.time()
    b, res = SessionManager.restore_from(CheckpointSession(uri, device=dev),
                                         lm)
    torch.cuda.synchronize()
    out["eager_restore_s"] = time.time() - t0
    check(res.digest_verified is True, "replica B's digest not verified")
    t0 = time.perf_counter()
    nov = b.submit(nov0)
    out["eager_nov0_ttft_s"] = nov.first_token_wall - t0
    check(b.used_slots == PLANE_SLOTS, f"replica B's pool is not full with "
                                       f"nov0: {b.used_slots} slots busy")
    log(f"plane: replica B restored eagerly in {out['eager_restore_s']:.2f} "
        f"s (digest verified); nov0 fills the pool ({b.used_slots} of "
        f"{PLANE_SLOTS} slots), first token in "
        f"{out['eager_nov0_ttft_s']:.3f} s")
    prefills += continue_replica(b, res, "B (eager)")
    del b, res, nov
    gc.collect()
    torch.cuda.empty_cache()

    # replica C: lazy, nov0 served while the old pages are in flight
    t0 = time.time()
    c, res = SessionManager.restore_from(CheckpointSession(uri, device=dev),
                                         lm, lazy=True)
    torch.cuda.synchronize()
    out["lazy_skeleton_s"] = time.time() - t0
    held = [s for s in c.sessions.values() if s.status == "restoring"]
    t0 = time.perf_counter()
    nov = c.submit(nov0)
    out["lazy_nov0_ttft_s"] = nov.first_token_wall - t0
    served_early = nov.n >= 1 and bool(held) and all(
        s.status == "restoring" for s in held)
    check(len(held) == len(in_flight) and c.used_slots == PLANE_SLOTS,
          f"replica C holds {len(held)} restoring sessions and "
          f"{c.used_slots} busy slots with nov0")
    t0 = time.time()
    c.complete_restore()
    torch.cuda.synchronize()
    out["complete_restore_s"] = time.time() - t0
    verified = res.state.server.verify_tree_digest()
    log(f"plane: replica C lazy: skeleton with params materialized "
        f"{out['lazy_skeleton_s']:.2f} s, {len(held)} sessions restoring; "
        f"nov0 first token in {out['lazy_nov0_ttft_s']:.3f} s before the "
        f"old pages landed: {served_early}; complete_restore "
        f"{out['complete_restore_s']:.2f} s, deferred digest verified: "
        f"{verified}")
    check(served_early, "nov0 was not served before complete_restore")
    check(verified is True, "replica C's digest not verified")
    prefills += continue_replica(c, res, "C (lazy)")
    torch.use_deterministic_algorithms(False)
    routes = dict(k6.ROUTE_LAUNCHES)           # read just after the path
    out["launches"] = dict(k6.LAUNCHES)
    out["k6_routes"] = routes
    out["prefills"] = prefills
    # where a decode tick's time goes, after the counts were read: one
    # tick of C under torch.profiler, the cohorts' page copies apart
    active = sum(s.status == "active" for s in c.sessions.values())
    wall_ms, busy_ms, rows = device_breakdown(torch, c.step)
    copy_ms = sum(ms for ms, k, _ in rows if "index" in k.lower())
    out["profile_tick"] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                           "page_copy_ms": copy_ms, "active": active,
                           "top": rows[:6]}
    log(f"plane: profile of one decode tick ({active} active sessions): "
        f"{wall_ms:.1f} ms wall under the profiler, {busy_ms:.1f} ms of "
        f"kernels ({busy_ms / wall_ms:.0%} busy), of it the cohorts' page "
        f"gathers and scatters {copy_ms:.2f} ms; top: " + "; ".join(
            f"{k[:48]} {ms:.2f} ms x{n}" for ms, k, n in rows[:6]))
    clock.close()
    params = c.params          # the image's weights: the source's, bitwise
    del c, res, nov, held
    log(f"kernels: plane-path launches flash_attention="
        f"{out['launches']['flash_attention']} (wgmma route "
        f"{routes['wgmma']}, SIMT route {routes['simt']}) for {prefills} "
        f"prefills x {cfg.num_layers} layers")
    check(routes == {"wgmma": prefills * cfg.num_layers, "simt": 0},
          f"the plane's K6 launches are not one wgmma launch per layer per "
          f"prefill: {routes}, {prefills} prefills")
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's record of long0's prefill (window 4096, softcap 50,
    # head dim 256) against the card
    out["record"] = prefill_against_record(
        torch, dev, lm, params, "gemma2-2b", 1, PLANE_LONG[0], args.seed,
        "path 9 (plane)", planned)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def plane_record() -> tuple:
    """Path 9's prefill record: gemma2-2b at PLANE_LAYERS, 1 x long0."""
    return dryrun_record("gemma2-2b", "prefill", 1, PLANE_LONG[0],
                         num_layers=PLANE_LAYERS)


# ------------------------------------------------------------- archs phase
# the three other dense configs at full width: (arch, layers or None for
# full depth, K6 launches per prefill); each prefills 1 x ARCH_PROMPT and
# decodes ARCH_GEN tokens
ARCHS = (("deepseek-67b", 2, 2), ("mistral-large-123b", 2, 2),
         ("musicgen-large", None, 48))
ARCH_PROMPT, ARCH_GEN = 2048, 8


def archs_phase(torch, dev, args, archs=ARCHS, label="archs", probes=None):
    """Each of ``archs`` at full width (cut in depth where it says):
    ServeEngine prefill + greedy decode, K6 launched on the wgmma route
    exactly the number of times written beside the arch (counters zeroed
    just before, read just after); tokens in range. ``probes`` maps an
    arch to fn(torch, engine, prompts) -> dict, run after the counts are
    read (timings of one more prefill)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    out = {}
    for arch, layers, want_k6 in archs:
        full = get_config(arch)
        cfg = full.replace(num_layers=layers) if layers else full
        lm = LM(cfg)
        t0 = time.time()
        params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (1, ARCH_PROMPT)).astype(np.int32)
        k6.reset_launches()
        eng = ServeEngine(lm, params, max_len=ARCH_PROMPT + ARCH_GEN + 1)
        torch.cuda.synchronize()
        t1 = time.time()
        eng.submit(prompts)
        torch.cuda.synchronize()
        t2 = time.time()
        toks = eng.generate(ARCH_GEN).copy()
        t3 = time.time()
        routes = dict(k6.ROUTE_LAUNCHES)
        rec = {"layers": cfg.num_layers, "full_layers": full.num_layers,
               "params": lm.n_params(), "init_s": t1 - t0,
               "prefill_s": t2 - t1,
               "decode_s_per_token": (t3 - t2) / (ARCH_GEN - 1),
               "k6_routes": routes, "k6_expected": want_k6,
               "head_dim": cfg.resolved_head_dim}
        out[arch] = rec
        log(f"{label}: {arch} ({cfg.num_layers} of {full.num_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads x {cfg.resolved_head_dim}, {lm.n_params():,} params): "
            f"init {rec['init_s']:.1f} s, prefill 1x{ARCH_PROMPT} "
            f"{rec['prefill_s']:.3f} s, decode "
            f"{rec['decode_s_per_token']:.4f} s/token; K6 launches {routes} "
            f"(expected {want_k6} on wgmma); tokens {toks[0].tolist()}")
        check(toks.shape == (1, ARCH_GEN) and toks.min() >= 0
              and toks.max() < cfg.vocab_size, f"{arch}: tokens out of range")
        check(routes == {"wgmma": want_k6, "simt": 0},
              f"{arch}: K6 did not launch {want_k6} times on the wgmma "
              f"route: {routes}")
        if probes and arch in probes:
            rec.update(probes[arch](torch, eng, prompts))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- fleet path
# path 11: one FleetCoordinator over FLEET_HOSTS hosts x 8 devices and one
# simulated store (virtual clock: network time simulated, not slept); 20
# jobs: 2 gemma2-2b trainers at full width (num_layers 26 -> 2, the only
# cut; params + m + v 8.95 GB fp32 each on the card, batch 1 x 512) with
# delta8 moments, and 18 SimJobs (3 leaves x 4 MiB on the card, lossless).
# 5 hosts, not 4: after 2 failures the 3 live hosts' 24 devices must hold
# all 20 jobs (4 hosts would leave 16).
FLEET_HOSTS, FLEET_DEVICES, FLEET_CONCURRENCY = 5, 8, 4
FLEET_LAYERS, FLEET_BATCH, FLEET_SEQ = 2, 1, 512
FLEET_SIMJOBS, FLEET_SIMJOB_KB, FLEET_SIMJOB_LEAVES = 18, 4096, 3
FLEET_STORE = dict(store="chip-fleet", latency_ms=2, bw_mbps=1000,
                   agg_mbps=4000, knee=4)


class FleetTrainer:
    """One incarnation of a full-width trainer as a fleet job: its train
    state on the card, one seeded batch per step (the same batches for
    every incarnation at a step), its losses logged by step. The shape of
    a SimJob (run / state / adopt / paused), so SimCluster.tick steps it
    and beats its heartbeat."""

    kind = "train"

    def __init__(self, job_id, *, seed, lm, step_fn, dev, incarnation=0,
                 state=None):
        self.job_id, self.seed, self.lm = job_id, seed, lm
        self.step_fn, self.dev = step_fn, dev
        self.incarnation = incarnation
        self.state = state
        self.step = 0 if state is None else int(state["step"])
        self.losses = {}              # step reached -> loss of that step
        self.running, self.paused = True, False
        self.restored_at = None       # time.time() when adopt ran

    def batch(self, step):
        import numpy as np
        import torch
        rng = np.random.default_rng([self.seed, step])
        t = rng.integers(0, self.lm.cfg.vocab_size, (FLEET_BATCH, FLEET_SEQ))
        return {"tokens": torch.from_numpy(t.astype(np.int64)).to(self.dev)}

    def run(self, steps=1):
        if not self.running or self.paused:
            return
        for _ in range(int(steps)):
            self.state, m = self.step_fn(self.state, self.batch(self.step))
            self.step += 1
            self.losses[self.step] = float(m["loss"])

    def adopt(self, state, step):
        self.state, self.step = state, int(step)
        self.paused = False
        self.restored_at = time.time()


def _fleet_failures(rng, order, host_of, batch, keep, t1_host):
    """The wave's two node failures as (MigrateRequest ordinal, host):
    T1's host at the first request of T1's batch, and a host drawn from
    the seed (never T0's or T1's) at the first request of a batch drawn
    from the seed that holds one of its jobs. A failure armed at a batch's
    first request fires before any request of that batch is delivered,
    whichever thread sends first, so a host's job in that batch is lost
    with it and re-placed."""
    b1 = next(i for i in range(0, len(order), batch)
              if "t1" in order[i:i + batch])
    return [(b1 + 1, t1_host),
            _drawn_failure(rng, order, host_of, batch, keep)]


def _drawn_failure(rng, order, host_of, batch, keep):
    """One node failure as (MigrateRequest ordinal, host): a host drawn
    from the seed (never one in ``keep``) at the first request of a batch
    drawn from the seed that holds one of its jobs."""
    batches = [order[i:i + batch] for i in range(0, len(order), batch)]
    first = int(rng.integers(len(batches)))
    for k in range(len(batches)):
        b = (first + k) % len(batches)
        hosts = sorted({host_of[j] for j in batches[b]} - set(keep))
        if hosts:
            return b * batch + 1, hosts[int(rng.integers(len(hosts)))]
    raise CheckFailed("no batch holds a job on a host the draw may fail")


def wave_clock(torch, coord):
    """Clocks on ``coord``'s drain and on each of its dump batches ->
    a function that runs one preemption wave and returns (report, its
    record: wall, drain, batch and re-place s, dumped / lost / replaced,
    the jobs of each batch in order)."""
    timing = {}
    drain, dump_batch = coord.drain, coord._dump_batch

    def timed_drain(job_ids):
        t = time.time()
        acks = drain(job_ids)
        timing["drain_s"] = time.time() - t
        return acks

    def timed_batch(group, *a):
        t = time.time()
        dump_batch(group, *a)
        timing.setdefault("batches", []).append((list(group),
                                                 time.time() - t))
        timing["dumps_end"] = time.time()

    coord.drain, coord._dump_batch = timed_drain, timed_batch

    def wave():
        timing.clear()
        t = time.time()
        report = coord.preemption_wave()
        torch.cuda.synchronize()
        end = time.time()
        rec = {"wall_s": end - t, "drain_s": timing["drain_s"],
               "batch_s": [b[1] for b in timing["batches"]],
               "replace_s": end - timing["dumps_end"],
               "dumped": len(report.dumped), "lost": list(report.lost),
               "replaced": dict(report.replaced)}
        return report, rec, [b[0] for b in timing["batches"]]
    return wave


def fleet_path(torch, dev, args):
    """Path 11: a preemption wave over a fleet through repro_torch.fleet:
    2 full-width gemma2-2b trainers (delta8 moments, device codec "auto")
    and 18 SimJobs answer one FleetCoordinator. Wave 0 gives every job a
    base image (the trainers' first dumps have no baseline: raw); every job
    is restored on its planned host and steps 2 more; wave 1 runs with 2
    armed node failures: T1's host dies before T1's dump, so T1 is re-placed
    from wave 0 and must replay its logged losses; T0 dumps its moments
    with K1 against wave 0's image, and its restore decodes them with K3.
    SimJobs restore bit-identically by digest, T0 by the train path's
    rules, and every coordinator<->job interaction is a counted wire
    frame. K1 and K3 must launch, K5 and K6 must not (counters zeroed just
    before the path, read just after)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.api import CodecPolicy, MigrationPolicy, SessionConfig
    from repro_torch.configs.gemma2_2b import CONFIG
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.remote import reset_tier_registry
    from repro_torch.core.restore import read_manifest
    from repro_torch.device import to_host
    from repro_torch.fleet import FleetClient, LoopbackTransport, SimCluster
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import abstract_train_state, init_train_state
    from repro_torch.training import make_train_step

    cfg = CONFIG.replace(num_layers=FLEET_LAYERS)
    lm = LM(cfg)
    codec = CodecPolicy(optimizer="delta8", device="auto")
    policy = codec.to_leaf_policy()
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      flatten_with_paths(abstract_train_state(lm)))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-", dir=args.lifecycle_dir)
    out = {"params": lm.n_params(), "state_bytes": state_bytes}
    try:
        # the trainers' hot fronts: 2 base images, T0's wave-1 image and
        # T1's re-placed restore fill
        need = 3.6 * state_bytes + 2e9
        free = shutil.disk_usage(tmp).free
        log(f"fleet: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
            f"{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; cut: num_layers "
            f"{CONFIG.num_layers} -> {cfg.num_layers} (the only cut); "
            f"params={lm.n_params():,}, train state {state_bytes / 1e9:.2f} "
            f"GB; hot fronts under {tmp}: {free / 1e9:.1f} GB free, the "
            f"trainers' need {need / 1e9:.1f} GB")
        check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free, the "
                            f"trainers' hot fronts need {need / 1e9:.1f} GB")
        ckpt_codec.reset_launches()          # the path's counts start here
        k6.reset_launches()
        cl = SimCluster(hosts=FLEET_HOSTS, devices_per_host=FLEET_DEVICES,
                        seed=args.seed, dump_concurrency=FLEET_CONCURRENCY,
                        leaf_kb=FLEET_SIMJOB_KB, leaves=FLEET_SIMJOB_LEAVES,
                        extra_uri_params=f"seed={args.seed}", device=dev,
                        **FLEET_STORE)
        coord = cl.coordinator
        step_fn = make_train_step(lm, OptConfig())
        trainers, frames_retired = {}, [0]
        retire_lock = threading.Lock()    # trainers restore side by side

        class TimedTransport(LoopbackTransport):
            """A trainer's wire: the loopback transport, keeping the
            wall-clock span of the last frame it carried."""

            def send(self, frame):
                t = time.time()
                reply = super().send(frame)
                self.span = (t, time.time())
                return reply

        def root(jid, host):
            # the launcher on ``host`` points the job's hot front at that
            # host's disk: a directory per (host, job), so no two jobs'
            # image ids collide and a dead host's disk is never read
            return (cl.root_uri(jid, host)
                    + f"&cache={os.path.join(tmp, host, jid)}")

        def bring_up(job, host, config_wire):
            def drain():
                job.paused = True
                return job.step
            client = FleetClient(
                job.job_id, config_wire, host=host, on_drain=drain,
                state_provider=lambda: (job.state, job.step),
                on_restore=lambda res: job.adopt(res.state, res.step),
                device=dev)
            transport = TimedTransport(client, host=host,
                                       on_send=cl._on_frame)
            trainers[job.job_id] = (job, transport)
            cl.jobs[job.job_id], cl.clients[job.job_id] = job, client
            return transport

        def spawner(rec, host, config_wire):
            if rec.job_id not in trainers:
                return cl.spawn(rec, host, config_wire)
            old, transport = trainers[rec.job_id]
            old.paused = True                # the old incarnation is gone:
            transport.client.close()         # its baseline's host copy too
            with retire_lock:
                frames_retired[0] += transport.frames_received
            job = FleetTrainer(rec.job_id, seed=old.seed, lm=lm,
                               step_fn=step_fn, dev=dev,
                               incarnation=old.incarnation + 1)
            return bring_up(job, host, dict(config_wire,
                                            root=root(rec.job_id, host)))

        coord.spawner = spawner

        # ---- admission: the trainers first (hosts h0 and h1), then the
        # SimJobs on the least-loaded hosts, then one tick for everyone
        t0 = time.time()
        for i, jid in enumerate(("t0", "t1")):
            host = f"h{i}"
            job = FleetTrainer(jid, seed=args.seed * 1000 + 900 + i, lm=lm,
                               step_fn=step_fn, dev=dev,
                               state=init_train_state(
                                   lm, torch.Generator().manual_seed(
                                       args.seed + 11 + i), device=dev))
            job.run(2)
            wire_cfg = SessionConfig(
                root=root(jid, host), codec=codec,
                migration=MigrationPolicy(arch=cfg.name)).to_wire()
            coord.attach(jid, bring_up(job, host, wire_cfg), host=host,
                         config_wire=wire_cfg)
        cl.submit_jobs(FLEET_SIMJOBS, steps=4, arrival_rate=2.0)
        cl.tick(1.0)
        torch.cuda.synchronize()
        out["admit_s"] = time.time() - t0
        sims = sorted(j for j in cl.jobs if j not in trainers)
        check(len(cl.jobs) == 20 and len(sims) == FLEET_SIMJOBS,
              f"{len(cl.jobs)} jobs admitted")
        log(f"fleet: {len(cl.jobs)} jobs on {FLEET_HOSTS} hosts x "
            f"{FLEET_DEVICES} devices (trainers t0 on h0, t1 on h1; "
            f"{FLEET_SIMJOBS} SimJobs of {FLEET_SIMJOB_LEAVES} x "
            f"{FLEET_SIMJOB_KB} KiB on {dev.type}); store {cl.root_uri('*', '*')}"
            f"; admitted and ticked in {out['admit_s']:.1f} s; trainer losses "
            f"{[trainers[t][0].losses for t in ('t0', 't1')]}")

        # ---- waves, timed: drain, each dump batch, the re-places after
        timed_wave = wave_clock(torch, coord)

        def wave(label):
            report, rec, batches = timed_wave()
            rec.update(peak_active=cl.store.network.peak_active,
                       trainer_batches=[i for i, b in enumerate(batches)
                                        if set(b) & set(trainers)])
            log(f"fleet: {label}: {rec['dumped']} dumped in "
                f"{report.batches} batches of {FLEET_CONCURRENCY}; wall "
                f"{rec['wall_s']:.2f} s: drain {rec['drain_s']:.3f} s, "
                f"batches {[round(b, 2) for b in rec['batch_s']]} s "
                f"(trainers in {rec['trainer_batches']}), "
                f"re-place {rec['replace_s']:.2f} s; lost {rec['lost']} -> "
                f"{rec['replaced']}; store peak_active {rec['peak_active']}")
            return report, rec

        def trainer_restore(jid, image_id, how):
            """The trainer's last RestoreRequest, split at adopt: the
            restore (and the delta8 baseline's host copy) before it, the
            ack's digest of the restored tree after it."""
            job, transport = trainers[jid]
            t, end = transport.span
            times = {"restore_s": job.restored_at - t,
                     "digest_s": end - job.restored_at, "how": how}
            log(f"fleet: {jid} incarnation {job.incarnation} restored "
                f"{how} from {image_id}: restore {times['restore_s']:.2f} s "
                f"(the baseline's host copy included), the ack's digest "
                f"{times['digest_s']:.2f} s")
            return times

        def restore_planned(jid):
            rec = coord.registry.get(jid)
            decision = coord.planner.plan(rec)
            ack = coord.restore_job(jid)
            check(ack is not None and ack.host == decision.host,
                  f"{jid} not restored on its planned host {decision.host}")
            if jid in trainers:
                return ack, trainer_restore(
                    jid, rec.image_id, f"on {ack.host} (planned, hot overlap "
                                       f"{decision.overlap:.2f})")
            check(ack.state_digest == rec.state_digest == cl.job_digest(jid),
                  f"{jid}: restore not bit-identical by digest")
            return ack, None

        report0, out["wave0"] = wave("wave 0")
        check(report0.complete and len(report0.dumped) == 20,
              f"wave 0 incomplete: {report0}")
        out["wave0"]["t0_image"] = report0.dumped["t0"]
        # the trainers restore side by side, each on its own host, as the
        # hosts of a fleet restore their jobs; then the SimJobs
        jobs0 = [r.job_id for r in coord.registry.jobs()]
        t_restores = time.time()
        sides = {j: Beside(lambda j=j: restore_planned(j)) for j in jobs0
                 if j in trainers}
        out["wave0"]["trainer_restores"] = {
            j: side.join()[1] for j, side in sides.items()}
        out["wave0"]["trainer_restores_wall_s"] = time.time() - t_restores
        log(f"fleet: wave 0's trainer restores side by side in "
            f"{out['wave0']['trainer_restores_wall_s']:.2f} s")
        for jid in jobs0:
            if jid not in trainers:
                restore_planned(jid)
        gc.collect()                     # the incarnations before wave 0
        torch.cuda.empty_cache()
        # wave 0's moments: the delta8 baseline of T0's wave-1 dump (the
        # restored tree is its content), kept on the host for the check
        prev = {p: torch.from_numpy(to_host(t)) for p, t in
                flatten_with_paths(trainers["t0"][0].state)
                if policy(p) == "delta8"}
        s0 = {t: trainers[t][0].step for t in trainers}
        cl.tick(1.0, steps=2)
        torch.cuda.synchronize()
        t1_log = dict(trainers["t1"][0].losses)
        log(f"fleet: every job restored on its planned host, SimJobs "
            f"bit-identical by digest; 2 more steps each: trainer steps "
            f"{ {t: trainers[t][0].step for t in trainers} }, T1's losses "
            f"{t1_log}")

        order = [r.job_id for r in coord.registry.jobs()]
        host_of = {r.job_id: r.host for r in coord.registry.jobs()}
        fails = _fleet_failures(np.random.default_rng(args.seed), order,
                                host_of, FLEET_CONCURRENCY,
                                (host_of["t0"], host_of["t1"]),
                                host_of["t1"])
        for nth, host in fails:
            cl.arm_failure(kind="MigrateRequest", nth=nth, host=host)
        out["failures"] = fails
        log(f"fleet: armed node failures (MigrateRequest ordinal, host): "
            f"{fails}; T0 on {host_of['t0']}, T1 on {host_of['t1']}")

        report1, out["wave1"] = wave("wave 1")
        alive = {h.host_id for h in cl.topology.hosts()}
        check(report1.complete and coord.stats["hosts_failed"] == 2,
              f"wave 1: complete {report1.complete}, hosts failed "
              f"{coord.stats['hosts_failed']}")
        check("t1" in report1.lost and "t0" in report1.dumped,
              f"T1 lost {report1.lost}, T0 dumped {report1.dumped}")
        for jid in report1.lost:
            check(report1.replaced.get(jid) in alive,
                  f"{jid} lost but not re-placed on a live host")
        t1 = trainers["t1"][0]
        check(t1.incarnation == 2 and t1.step == s0["t1"],
              f"T1 re-placed at step {t1.step}, wave 0 was {s0['t1']}")
        out["t1_replace"] = trainer_restore(
            "t1", coord.registry.get("t1").image_id,
            f"re-placed on {report1.replaced['t1']} (planner)")

        # T1 replays its steps from wave 0's step on the same batches
        t1.run(2)
        torch.cuda.synchronize()
        replay = {k: t1.losses[k] for k in sorted(t1.losses)}
        log(f"fleet: T1 re-placed on {report1.replaced['t1']} from "
            f"{coord.registry.get('t1').image_id}; replayed losses {replay} "
            f"against its first incarnation's {t1_log} (held to 1e-5 "
            f"relative)")
        for k, v in replay.items():
            check(abs(v - t1_log[k]) <= 1e-5 * abs(t1_log[k]),
                  f"T1 step {k}: replayed loss {v} vs logged {t1_log[k]}")
        out["t1_replay"] = {"logged": t1_log, "replayed": replay}

        # T0's wave-1 image: every moment delta8 against wave 0's image
        rec0 = coord.registry.get("t0")
        man = read_manifest(trainers["t0"][1].client.session.tier,
                            rec0.image_id)
        opt = [r for r in man["leaves"] if policy(r["path"]) == "delta8"]
        on_card = sum(1 for r in opt
                      if r["codec_meta"].get("encoder") == "device")
        out["t0_image"] = {
            "image_id": rec0.image_id, "parent": man["parent"],
            "gb": sum(r["nbytes"] for r in man["leaves"]) / 1e9,
            "moments": len(opt), "device_encoded": on_card}
        log(f"fleet: T0's wave-1 image {rec0.image_id} (parent "
            f"{man['parent']}): {out['t0_image']['gb']:.3f} GB; "
            f"{len(opt)} moment leaves delta8-coded, {on_card} of them by "
            f"the device stage (K1), the rest by the host codec (K4)")
        check(man["parent"] == out["wave0"]["t0_image"]
              and all(r["codec_meta"].get("applied") for r in opt),
              "T0's wave-1 moments are not delta8 against wave 0's image")
        check(on_card > 0, "no moment of T0 went through the device stage")

        # restore the rest on their planned hosts; T0's decodes with K3
        live_t0 = trainers["t0"][0]      # drained, on the card
        out["wave1"]["trainer_restores"] = {}
        for jid in sorted(j for j in cl.jobs
                          if coord.registry.get(j).phase == "dumped"):
            _, times = restore_planned(jid)
            if times:
                out["wave1"]["trainer_restores"][jid] = times
        check(all(r.phase == "running" for r in coord.registry.jobs()),
              "a job is not running after the restores")
        for jid in sims:
            check(cl.job_digest(jid)
                  == coord.registry.get(jid).state_digest,
                  f"{jid}: its state is not the image's by digest")
        t0_new = trainers["t0"][0]
        out["t0_err_over_half_scale"] = check_restored_b(
            torch, live_t0.state, t0_new.state, prev, policy)
        log("fleet: T0 params and step bit-identical after the restore; "
            "opt/m and opt/v within each block's scale/2 of the drained "
            f"live moments (worst error / (scale/2) = "
            f"{out['t0_err_over_half_scale']:.4f})")
        del prev
        s1 = t0_new.step
        out["t0_continue"], t0_new.state, live_t0.state = continue_both(
            torch, step_fn, t0_new.state, live_t0.state,
            [t0_new.batch(s1), t0_new.batch(s1 + 1)], "fleet T0",
            final_step=s1 + 2)
        t0_new.step += 2
        del live_t0                      # compared: release T0's old one

        frames = (sum(t.frames_received for t in cl.all_transports)
                  + frames_retired[0]
                  + sum(t.frames_received for _, t in trainers.values()))
        out["frames"] = dict(coord.stats)
        log(f"fleet: coordinator {coord.stats}; transports' frames {frames} "
            f"+ heartbeats {coord.stats['heartbeats']}")
        check(coord.stats["wire_frames"] == frames
              + coord.stats["heartbeats"],
              "the coordinator's frames differ from the transports'")
        out["launches"] = dict(ckpt_codec.LAUNCHES)
        out["launches"]["flash_attention"] = k6.LAUNCHES["flash_attention"]
        log("kernels: fleet-path launches " + " ".join(
            f"{k}={v}" for k, v in out["launches"].items()))
        for k in ("delta_encode_digest", "delta_decode"):
            check(out["launches"][k] > 0,
                  f"kernel {k} was not launched on the fleet path")
        for k in ("digest_blocks", "flash_attention"):
            check(out["launches"][k] == 0,
                  f"kernel {k} was launched on the fleet path")
        trainers.clear()
        del cl, coord, t1, t0_new
    finally:
        reset_tier_registry()             # the store's objects go with it
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# path 12: the fleet over the socket wire (fleet/transport.py). (a) In
# this process: SimCluster(transport="socket") with a UDS CoordinatorServer;
# one musicgen-large trainer at full width (d_model 2048, 32/32 heads, d_ff
# 8192, vocab 2048; num_layers cut from 48 to 4, the only cut: 209,733,632
# params, 2.52 GB of fp32 params + m + v) with delta8 moments and 6 SimJobs
# (3 leaves x 4 MiB on the card, lossless). musicgen-large: full width at
# ~50M params a layer, so 4 layers move in seconds (gemma2-2b's embedding
# alone is 7 GB of fp32 state, and path 11 carries it). (b) Across
# processes: examples/fleet_multiprocess_torch.py's --serve coordinator
# SIGKILLs itself mid-wave under 3 --worker subprocesses on the card and is
# restarted from its journal; a run without the kill runs beside it.
SOCKET_LAYERS = 4               # FleetTrainer's batch: 1 x 512
SOCKET_HOSTS, SOCKET_DEVICES, SOCKET_CONCURRENCY = 4, 4, 4
SOCKET_SIMJOBS = 6
SOCKET_STORE = dict(FLEET_STORE, store="chip-socket")
# a command's reply may wait for a trainer's whole dump, restore and digest
SOCKET_RESUME_S = 300.0
SOCKET_EXAMPLE = "examples/fleet_multiprocess_torch.py"
SOCKET_WORKERS, SOCKET_DIE_AFTER = 3, 2


class ReplyCut:
    """Severs a worker's connection ``off`` bytes into the first frame it
    sends that holds ``needle``, once armed: the cut_send_frame case of
    tests/faultinject.py's ChaosSocket (which imports the JAX package),
    chosen by the frame's content. Pass ``wrap`` as
    ``WorkerAgent(wrap_socket=...)``."""

    def __init__(self, needle: bytes, off: int):
        self.needle, self.off = needle, off
        self.armed, self.fired = False, []

    def wrap(self, sock):
        return _CutSocket(sock, self)


class _CutSocket:
    def __init__(self, sock, plan):
        self.sock, self.plan = sock, plan

    def sendall(self, data):
        plan = self.plan
        if plan.armed and not plan.fired and plan.needle in data:
            self.sock.sendall(bytes(data[:plan.off]))
            plan.fired.append((len(data), plan.off))
            self.sock.close()
            raise ConnectionError(f"cut {plan.off} bytes into a "
                                  f"{len(data)}-byte frame")
        self.sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self.sock, name)


def socket_path(torch, dev, args, restart=True):
    """Path 12: the fleet over real Unix-domain sockets. (a) In process:
    a musicgen-large trainer (4 of 48 layers, full width, delta8 moments)
    and 6 SimJobs answer one UDS CoordinatorServer through WorkerAgents.
    Wave 0 gives every job a raw base image; every job is restored and
    steps 2 more (the trainer's losses against its drained incarnation's
    on the same batches); wave 1 runs under a seeded host failure and a
    cut of the connection mid-reply of the trainer's MigrateRequest, which
    must execute once and be answered again from the worker's dedup
    window. SimJobs restore bit-identically by digest, the trainer by the
    train path's rules, and every coordinator<->job interaction is a frame
    the server took off a socket. K1, K4 and K3 must launch, K2, K5 and K6
    not (counters zeroed just before, read just after). (b) Across
    processes: the example's coordinator SIGKILLs itself mid-wave and
    restarts from its journal under 3 worker subprocesses on the card; its
    digests must equal those of a run without the kill (``restart``; else
    socket_restart runs it on its own)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.api import CodecPolicy, MigrationPolicy, SessionConfig
    from repro_torch.configs.musicgen_large import CONFIG
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.remote import reset_tier_registry
    from repro_torch.core.restore import read_manifest
    from repro_torch.device import to_host
    from repro_torch.fleet import FleetClient, ReconnectPolicy, SimCluster
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import abstract_train_state, init_train_state
    from repro_torch.training import make_train_step

    reset_tier_registry()                 # path 11's store is freed first
    cfg = CONFIG.replace(num_layers=SOCKET_LAYERS)
    lm = LM(cfg)
    codec = CodecPolicy(optimizer="delta8", device="auto")
    policy = codec.to_leaf_policy()
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      flatten_with_paths(abstract_train_state(lm)))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-socket-",
                           dir=args.lifecycle_dir)
    troot = f"file://{os.path.join(tmp, 't0')}"
    out = {"params": lm.n_params(), "state_bytes": state_bytes}
    cl = None
    try:
        need = 2.2 * state_bytes + 1e9     # a raw image and a delta8 one
        free = shutil.disk_usage(tmp).free
        log(f"socket: {cfg.name} d_model={cfg.d_model} heads="
            f"{cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab="
            f"{cfg.vocab_size}; cut: num_layers {CONFIG.num_layers} -> "
            f"{cfg.num_layers} (the only cut); params={lm.n_params():,}, "
            f"train state {state_bytes / 1e9:.2f} GB; images under {troot}: "
            f"{free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed")
        check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free, the "
                            f"trainer's images need {need / 1e9:.1f} GB")
        ckpt_codec.reset_launches()          # the path's counts start here
        k6.reset_launches()
        t_path = time.time()
        cl = SimCluster(hosts=SOCKET_HOSTS, devices_per_host=SOCKET_DEVICES,
                        seed=args.seed, dump_concurrency=SOCKET_CONCURRENCY,
                        leaf_kb=FLEET_SIMJOB_KB, leaves=FLEET_SIMJOB_LEAVES,
                        extra_uri_params=f"seed={args.seed}",
                        transport="socket", resume_timeout_s=SOCKET_RESUME_S,
                        device=dev, **SOCKET_STORE)
        coord, server = cl.coordinator, cl.server
        step_fn = make_train_step(lm, OptConfig())
        cut = ReplyCut(b'"MigrationTicket"', 10)
        trainer = {}                  # the live incarnation and its wire
        retired = []                  # earlier incarnations' transports
        sent_at = {}                  # frame kind -> time.time() at send

        def on_send(host, frame):
            sent_at[frame["kind"]] = time.time()
            cl._on_frame(host, frame)

        def bring_up(job, host, config_wire, transport):
            """Dial the trainer's incarnation in: its FleetClient behind a
            WorkerAgent whose sockets pass through the cut."""
            def drain():
                job.paused = True
                return job.step
            client = FleetClient(
                job.job_id, config_wire, host=host, on_drain=drain,
                state_provider=lambda: (job.state, job.step),
                on_restore=lambda res: job.adopt(res.state, res.step),
                device=dev)
            old = cl.agents.get(job.job_id)
            if old is not None:
                old.stop(bye=False)
            transport.on_send = on_send
            agent = client.connect(
                cl.socket_url, incarnation=transport.incarnation,
                reconnect=ReconnectPolicy(attempts=40, backoff_s=0.02,
                                          backoff_max_s=0.2),
                wrap_socket=cut.wrap)
            cl.jobs[job.job_id], cl.clients[job.job_id] = job, client
            cl.agents[job.job_id] = agent
            trainer.update(job=job, client=client, agent=agent,
                           transport=transport)
            check(server.wait_connected([job.job_id], timeout=60.0),
                  f"trainer incarnation {job.incarnation} never dialed in")
            return transport

        def spawner(rec, host, config_wire):
            if rec.job_id != "t0":
                return cl.spawn(rec, host, config_wire)
            old = trainer["job"]
            old.paused = True                # the old incarnation is gone:
            trainer["client"].close()        # its baseline's host copy too
            retired.append(trainer["transport"])
            job = FleetTrainer("t0", seed=old.seed, lm=lm, step_fn=step_fn,
                               dev=dev, incarnation=old.incarnation + 1)
            # a file:// root is one directory every host reaches: the
            # placement's front= pin does not apply to it
            return bring_up(job, host, dict(config_wire, root=troot),
                            server.new_incarnation("t0", host=host))

        coord.spawner = spawner

        def tick(steps):
            """cl.tick, then wait until the server has taken every
            heartbeat the tick sent off the socket (delivery is
            asynchronous)."""
            sent0 = sum(a.stats["events_sent"] for a in cl.agents.values())
            seen0 = server.stats["events"] + server.stats["bad_events"]
            cl.tick(1.0, steps=steps)
            torch.cuda.synchronize()
            want = seen0 + sum(a.stats["events_sent"]
                               for a in cl.agents.values()) - sent0
            deadline = time.time() + 30
            while server.stats["events"] + server.stats["bad_events"] \
                    < want:
                check(time.time() < deadline, "heartbeats lost on the wire")
                time.sleep(0.01)

        # ---- admission: the trainer on h0, then the SimJobs, one tick
        t0 = time.time()
        job = FleetTrainer("t0", seed=args.seed * 1000 + 950, lm=lm,
                           step_fn=step_fn, dev=dev,
                           state=init_train_state(
                               lm, torch.Generator().manual_seed(
                                   args.seed + 31), device=dev))
        job.run(2)
        wire_cfg = SessionConfig(
            root=troot, codec=codec,
            migration=MigrationPolicy(arch=cfg.name)).to_wire()
        bring_up(job, "h0", wire_cfg, server.attach("t0", wire_cfg,
                                                    host="h0"))
        cl.submit_jobs(SOCKET_SIMJOBS, steps=4, arrival_rate=2.0)
        tick(1)
        out["admit_s"] = time.time() - t0
        sims = sorted(j for j in cl.jobs if j != "t0")
        check(len(sims) == SOCKET_SIMJOBS and server.wait_connected(
            timeout=30.0), f"{len(sims)} SimJobs admitted, not all dialed in")
        log(f"socket: {len(cl.jobs)} jobs dialed in to {cl.socket_url} "
            f"(trainer t0 on h0, {SOCKET_SIMJOBS} SimJobs of "
            f"{FLEET_SIMJOB_LEAVES} x {FLEET_SIMJOB_KB} KiB on {dev.type}); "
            f"admitted and ticked in {out['admit_s']:.2f} s; trainer losses "
            f"{job.losses}")

        timed_wave = wave_clock(torch, coord)

        def wave(label):
            report, rec, batches = timed_wave()
            rec["trainer_dump_s"] = next(
                s for b, s in zip(batches, rec["batch_s"]) if "t0" in b)
            log(f"socket: {label}: {rec['dumped']} dumped in "
                f"{report.batches} batches of {SOCKET_CONCURRENCY}; wall "
                f"{rec['wall_s']:.2f} s: drain {rec['drain_s']:.3f} s, "
                f"batches {[round(b, 3) for b in rec['batch_s']]} s (the "
                f"trainer's {rec['trainer_dump_s']:.2f}), re-place "
                f"{rec['replace_s']:.2f} s; lost {rec['lost']} -> "
                f"{rec['replaced']}")
            return report, rec

        def restore_all(label):
            """Every dumped job restored; SimJobs bit-identical by digest.
            -> the trainer's restore / digest-ack times."""
            times = None
            for jid in sorted(j for j in cl.jobs
                              if coord.registry.get(j).phase == "dumped"):
                rec = coord.registry.get(jid)
                # the trainer's file:// root is one directory every host
                # reaches: it is restored on its own host, not planned (the
                # planner reads the image through the registry's root,
                # which retarget_root gave a front= query)
                ack = coord.restore_job(
                    jid, host=rec.host if jid == "t0" else None)
                check(ack is not None, f"{jid}: restore claim lost")
                if jid == "t0":
                    done, job = time.time(), trainer["job"]
                    times = {"restore_s": job.restored_at
                             - sent_at["RestoreRequest"],
                             "digest_s": done - job.restored_at}
                    log(f"socket: {label}: t0 incarnation {job.incarnation}"
                        f" restored from {rec.image_id} on {ack.host}: "
                        f"restore {times['restore_s']:.2f} s (the "
                        f"baseline's host copy included), the ack's digest "
                        f"{times['digest_s']:.2f} s")
                else:
                    check(ack.state_digest == rec.state_digest
                          == cl.job_digest(jid),
                          f"{jid}: restore not bit-identical by digest")
            check(all(r.phase == "running" for r in coord.registry.jobs()),
                  "a job is not running after the restores")
            return times

        report0, out["wave0"] = wave("wave 0")
        check(report0.complete and len(report0.dumped) == 1 + SOCKET_SIMJOBS,
              f"wave 0 incomplete: {report0}")
        wave0_image = report0.dumped["t0"]
        live0 = trainer["job"]               # drained, on the card
        out["wave0"]["trainer"] = restore_all("wave 0")
        # wave 0's moments (the restored tree, before the steps below
        # update it in place): the delta8 baseline of the wave-1 dump
        prev = {p: torch.from_numpy(to_host(t)) for p, t in
                flatten_with_paths(trainer["job"].state)
                if policy(p) == "delta8"}
        # the restored incarnation steps on in the tick; its drained
        # predecessor takes the same 2 batches: the losses must agree
        s0 = live0.step
        tick(2)
        logged = {k: v for k, v in trainer["job"].losses.items() if k > s0}
        live0.paused = False
        live0.run(2)
        torch.cuda.synchronize()
        again = {k: v for k, v in live0.losses.items() if k > s0}
        log(f"socket: 2 steps after the wave-0 restore: the restored "
            f"trainer's losses {logged}, its drained incarnation's on the "
            f"same batches {again} (held to 1e-5 relative)")
        check(sorted(logged) == sorted(again) == [s0 + 1, s0 + 2],
              f"steps after the restore: {sorted(logged)}, {sorted(again)}")
        for k, v in logged.items():
            check(abs(v - again[k]) <= 1e-5 * abs(again[k]),
                  f"step {k}: restored loss {v} vs {again[k]}")
        out["wave0"]["losses"] = {"restored": logged, "drained": again}
        del live0
        gc.collect()
        torch.cuda.empty_cache()

        order = [r.job_id for r in coord.registry.jobs()]
        host_of = {r.job_id: r.host for r in coord.registry.jobs()}
        fail = _drawn_failure(np.random.default_rng(args.seed), order,
                              host_of, SOCKET_CONCURRENCY, (host_of["t0"],))
        cl.arm_failure(kind="MigrateRequest", nth=fail[0], host=fail[1])
        cut.armed = True
        agent = trainer["agent"]
        execs0, dedup0 = (trainer["client"].commands_executed,
                          agent.stats["dedup_hits"])
        out["failure"] = list(fail)
        log(f"socket: armed a node failure (MigrateRequest ordinal, host) "
            f"{fail} and a cut {cut.off} bytes into t0's MigrationTicket "
            f"reply; t0 on {host_of['t0']}")
        report1, out["wave1"] = wave("wave 1")
        alive = {h.host_id for h in cl.topology.hosts()}
        check(report1.complete and coord.stats["hosts_failed"] == 1
              and report1.lost and "t0" in report1.dumped,
              f"wave 1: {report1}")
        for jid in report1.lost:
            check(report1.replaced.get(jid) in alive,
                  f"{jid} lost but not re-placed on a live host")
        execs = trainer["client"].commands_executed - execs0
        dedup = agent.stats["dedup_hits"] - dedup0
        out["cut"] = {"fired": cut.fired, "commands": execs,
                      "dedup_hits": dedup,
                      "reconnects": agent.stats["reconnects"]}
        log(f"socket: the cut fired {cut.fired} (frame bytes, cut at); "
            f"t0 executed {execs} commands in wave 1 (drain, migrate), "
            f"reconnected {agent.stats['reconnects']} time(s), answered "
            f"{dedup} replay(s) from its dedup window")
        check(len(cut.fired) == 1 and execs == 2 and dedup == 1
              and agent.stats["reconnects"] == 1,
              f"the cut MigrateRequest did not execute exactly once with "
              f"one deduped replay: {out['cut']}")

        rec0 = coord.registry.get("t0")
        man = read_manifest(trainer["client"].session.tier, rec0.image_id)
        opt = [r for r in man["leaves"] if policy(r["path"]) == "delta8"]
        on_card = sum(1 for r in opt
                      if r["codec_meta"].get("encoder") == "device")
        out["t0_image"] = {
            "image_id": rec0.image_id, "parent": man["parent"],
            "gb": sum(r["nbytes"] for r in man["leaves"]) / 1e9,
            "moments": len(opt), "device_encoded": on_card}
        log(f"socket: t0's wave-1 image {rec0.image_id} (parent "
            f"{man['parent']}): {out['t0_image']['gb']:.3f} GB; {len(opt)} "
            f"moment leaves delta8-coded, {on_card} of them by the device "
            f"stage (K1), the rest by the host codec (K4)")
        check(man["parent"] == wave0_image
              and all(r["codec_meta"].get("applied") for r in opt)
              and on_card > 0,
              "t0's wave-1 moments are not delta8 against wave 0's image, "
              "or none went through the device stage")

        live1 = trainer["job"]               # drained, on the card
        out["wave1"]["trainer"] = restore_all("wave 1")
        for jid in sims:
            check(cl.job_digest(jid) == coord.registry.get(jid).state_digest,
                  f"{jid}: its state is not the image's by digest")
        new = trainer["job"]
        out["t0_err_over_half_scale"] = check_restored_b(
            torch, live1.state, new.state, prev, policy)
        log("socket: t0 params and step bit-identical after the restore; "
            "opt/m and opt/v within each block's scale/2 of the drained "
            f"live moments (worst error / (scale/2) = "
            f"{out['t0_err_over_half_scale']:.4f})")
        del prev
        s1 = new.step
        out["t0_continue"], new.state, live1.state = continue_both(
            torch, step_fn, new.state, live1.state,
            [new.batch(s1), new.batch(s1 + 1)], "socket t0",
            final_step=s1 + 2)
        new.step += 2
        del live1

        transports = cl.all_transports + retired + [trainer["transport"]]
        replies = sum(t.frames_received for t in transports)
        out["frames"] = {"coordinator": dict(coord.stats),
                         "server": dict(server.stats), "replies": replies,
                         "reconnects": agent.stats["reconnects"],
                         "dedup_hits": dedup}
        log(f"socket: frames: coordinator {coord.stats}; the server took "
            f"{replies} replies and {server.stats['events']} heartbeat "
            f"events off the socket ({server.stats}: a hello per "
            f"incarnation and per reconnect); reconnects "
            f"{agent.stats['reconnects']} (t0, after the cut), deduped "
            f"replays {dedup}")
        check(coord.stats["wire_frames"] == replies + server.stats["events"]
              and coord.stats["heartbeats"] == server.stats["events"]
              and server.stats["bad_events"] == 0,
              "a coordinator<->job interaction did not cross the socket")
        out["launches"] = dict(ckpt_codec.LAUNCHES)
        out["launches"]["flash_attention"] = k6.LAUNCHES["flash_attention"]
        log("kernels: socket-path launches " + " ".join(
            f"{k}={v}" for k, v in out["launches"].items()))
        for k in ("delta_encode_digest", "delta_encode", "delta_decode"):
            check(out["launches"][k] > 0,
                  f"kernel {k} was not launched on the socket path")
        for k in ("bf16_encode_digest", "digest_blocks", "flash_attention"):
            check(out["launches"][k] == 0,
                  f"kernel {k} was launched on the socket path")
        out["in_process_s"] = time.time() - t_path
        cl.shutdown()
        trainer.clear()
        del new, job
        gc.collect()
        torch.cuda.empty_cache()
        if restart:
            out["restart"] = _socket_restart(dev, args, tmp)
    finally:
        if cl is not None:
            cl.shutdown()
        reset_tier_registry()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def socket_restart(dev, args) -> dict:
    """Path 12 (b) on its own, in a temporary directory of its own."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-socket-restart-",
                           dir=args.lifecycle_dir)
    try:
        return _socket_restart(dev, args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _socket_restart(dev, args, tmp):
    """Path 12 (b): examples/fleet_multiprocess_torch.py's --serve
    coordinator under 3 --worker subprocesses (each a SimJob of 3 x 4 MiB
    on the card in its own CUDA context), twice side by side: a control
    run, and a run whose coordinator SIGKILLs itself after the 2nd
    committed dump and is restarted from its on-disk journal while the
    workers redial. Both waves must complete with the same digests."""
    import signal
    import subprocess
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    example = os.path.join(ROOT, SOCKET_EXAMPLE)
    jobs = [f"j{i}" for i in range(SOCKET_WORKERS)]
    procs, runs = [], {}

    def start(cmd, log_path):
        f = open(log_path, "w")
        p = subprocess.Popen(cmd, env=env, stdout=f,
                             stderr=subprocess.STDOUT)
        f.close()
        procs.append(p)
        return p

    def serve(run, die=0):
        r = runs[run]
        cmd = [sys.executable, example, "--serve", "--socket", r["url"],
               "--journal", r["journal"], "--root", r["root"],
               "--jobs", ",".join(jobs), "--out", r["out"],
               "--resume-timeout", "60", "--connect-timeout", "120",
               "--timeout", "200"]
        if die:
            cmd += ["--die-after-dumps", str(die)]
        r.setdefault("serves", []).append(time.time())
        return start(cmd, f"{r['root']}/serve{len(r['serves'])}.log")

    def text(path):
        with open(path) as f:
            return f.read()

    try:
        t0 = time.time()
        for run in ("control", "killed"):
            root = tempfile.mkdtemp(prefix=f"{run}-", dir=tmp)
            runs[run] = {"root": root, "url": f"unix://{root}/c.sock",
                         "journal": f"file://{root}/journal",
                         "out": f"{root}/wave.json"}
            runs[run]["proc"] = serve(
                run, SOCKET_DIE_AFTER if run == "killed" else 0)
            runs[run]["workers"] = [start(
                [sys.executable, example, "--worker", "--job", jid,
                 "--seed", str(args.seed * 1000 + 41 + i), "--steps", "3",
                 "--leaves", str(FLEET_SIMJOB_LEAVES),
                 "--leaf-kb", str(FLEET_SIMJOB_KB), "--device", dev.type,
                 "--socket", runs[run]["url"], "--root", root,
                 "--timeout", "240"], f"{root}/{jid}.log")
                for i, jid in enumerate(jobs)]
        killed = runs["killed"]
        rc = killed["proc"].wait(timeout=200)
        died_at = time.time()
        journal = json.loads(text(f"{killed['root']}/journal/fleet/"
                                  "registry.json"))
        phases = {j["job_id"]: j["phase"] for j in journal["jobs"]}
        log(f"socket: restart: the coordinator subprocess exited {rc} "
            f"{died_at - killed['serves'][0]:.1f} s after it started; its "
            f"journal (epoch {journal['epoch']}) holds {phases}")
        check(rc == -signal.SIGKILL and not os.path.exists(killed["out"])
              and sum(p == "dumped" for p in phases.values())
              == SOCKET_DIE_AFTER,
              f"the coordinator was not SIGKILLed mid-wave (rc {rc}, "
              f"phases {phases})")
        killed["proc"] = serve("killed")     # the same journal, epoch + 1
        result = {}
        for run, r in runs.items():
            rc = r["proc"].wait(timeout=200)
            serve_log = f"{r['root']}/serve{len(r['serves'])}.log"
            check(rc == 0, f"{run} coordinator exited {rc}: "
                           f"{text(serve_log)[-2000:]}")
            result[run] = json.loads(text(r["out"]))
            codes = [w.wait(timeout=60) for w in r["workers"]]
            logs = [text(f"{r['root']}/{j}.log") for j in jobs]
            check(codes == [0] * len(jobs),
                  f"{run} workers exited {codes}: {logs}")
            result[run]["worker_lines"] = [
                ln for t in logs for ln in t.splitlines() if "done (" in ln]
        wall = time.time() - t0
        ctl, kil = result["control"], result["killed"]
        reattach = kil["connected_at"] - kil["listen_at"]
        restart = kil["connected_at"] - killed["serves"][1]
        out = {"wall_s": wall, "control_wave_s": ctl["wave_s"],
               "killed_wave_s": kil["wave_s"], "reattach_s": reattach,
               "restart_to_reattached_s": restart,
               "epochs": [ctl["epoch"], kil["epoch"]],
               "digests": kil["digests"], "server": kil["server"],
               "workers": kil["worker_lines"]}
        log(f"socket: restart: the restarted coordinator (epoch "
            f"{kil['epoch']}) listened, and all {len(jobs)} workers "
            f"re-attached {reattach:.3f} s later ({restart:.2f} s after its "
            f"process started); it finished the wave in "
            f"{kil['wave_s']:.2f} s (control run: {ctl['wave_s']:.2f} s); "
            f"phases {kil['phases']}; workers: {kil['worker_lines']}")
        check(kil["epoch"] == 2 and ctl["epoch"] == 1
              and all(p in ("dumped", "running")
                      for p in kil["phases"].values()),
              f"the restart did not complete the wave: {kil}")
        check(len(kil["worker_lines"]) == len(jobs)
              and all("reconnects=0" not in ln and f"'{dev.type}" in ln
                      for ln in kil["worker_lines"]),
              f"a worker did not redial, or its leaves left the "
              f"{dev.type} device: {kil['worker_lines']}")
        check(kil["digests"] == ctl["digests"]
              and all(ctl["digests"].values()),
              f"digests after the kill {kil['digests']} differ from the "
              f"run without it {ctl['digests']}")
        log(f"socket: restart: digests equal to the run without the kill "
            f"({ {j: d[:12] for j, d in ctl['digests'].items()} }); both "
            f"runs side by side in {wall:.1f} s")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


# ------------------------------------------------------------ families path
# path 13: the MoE, SSM and hybrid architectures at full width. (a) each
# prefills 1 x ARCH_PROMPT and decodes ARCH_GEN tokens, with the K6
# launches written here before the run: one per attention layer
# (granite-moe's 32 at hd 64, dbrx's 2 at hd 128), none for xlstm, and
# zamba2's shared block's 7 applications (6 groups + 1 before the tail, hd
# 64). dbrx is cut from 40 layers to 2 (a layer's experts are 3.2 B
# params; 40 do not fit one card), the only cut.
FAMILIES = (("granite-moe-3b-a800m", None, 32), ("dbrx-132b", 2, 2),
            ("xlstm-350m", None, 0), ("zamba2-1.2b", None, 7))
# (b) zamba2-1.2b serving at full depth: the serve path's pattern (4 x
# 2048, 32 tokens, checkpointed after 16); two prefills of 7 K6 launches
RECURRENT_ARCH, RECURRENT_K6 = "zamba2-1.2b", 14
# (c) a granite-moe-3b-a800m trainer at full width, 32 -> 2 layers (the
# only cut), the train path's steps and images. Its 12 moment leaves:
# delta8 through K1 for the 9 of 64 KiB or more (embed/tok, wq, wk, wv,
# wo, router, w_up, w_gate, w_down), through K4 for the 3 below the device
# stage's floor (ln1, ln2: 24 KiB, final_norm: 6 KiB); the 9 large v
# leaves bf16 through K2; all 12 m leaves decoded by K3 on restore.
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_LAUNCHES = {"delta_encode_digest": 9, "bf16_encode_digest": 9,
                      "delta_decode": 12, "delta_encode": 3}


class CallTimer:
    """Replace ``module.name`` with a wrapper that brackets each call with
    CUDA events, for one more run after a path's counts were read; ``ms``
    is the summed device-timeline time once the stream is synchronized."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.fn = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*a, **kw):
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            r = self.fn(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            return r
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    @property
    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def _timed_prefill(torch, eng, prompts, timers):
    """One more prefill of ``prompts`` under ``timers`` -> its ms (CUDA
    events around the engine's submit)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with contextlib.ExitStack() as stack:
        for t in timers:
            stack.enter_context(t)
        torch.cuda.synchronize()
        e0.record()
        eng.submit(prompts)
        e1.record()
        torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def moe_share_probe(torch, eng, prompts):
    """granite-moe's prefill again, the MoE layers' time (moe_apply) and
    within it the dispatch's (routing, sort, scatter: _dispatch_group;
    gather-combine: _combine_group) beside the whole prefill's."""
    from repro_torch.models import blocks, moe
    t_moe = CallTimer(torch, blocks, "moe_apply")
    t_disp = CallTimer(torch, moe, "_dispatch_group")
    t_comb = CallTimer(torch, moe, "_combine_group")
    total = _timed_prefill(torch, eng, prompts, (t_moe, t_disp, t_comb))
    rec = {"probe_prefill_ms": total, "moe_ms": t_moe.ms,
           "dispatch_ms": t_disp.ms, "combine_ms": t_comb.ms,
           "moe_calls": len(t_moe.events)}
    log(f"families: granite-moe prefill 1x{ARCH_PROMPT} again under CUDA "
        f"events: {total:.1f} ms; the {rec['moe_calls']} MoE layers "
        f"{t_moe.ms:.1f} ms ({t_moe.ms / total:.1%}); of which dispatch "
        f"(route, sort, scatter) {t_disp.ms:.1f} ms ({t_disp.ms / total:.1%}"
        f" of the prefill) and combine {t_comb.ms:.1f} ms "
        f"({t_comb.ms / total:.1%})")
    check(rec["moe_calls"] == eng.lm.cfg.num_layers,
          f"{rec['moe_calls']} MoE layers timed, not one per layer")
    return rec


def slstm_probe(torch, eng, prompts):
    """xlstm's prefill again, the sLSTM layers' sequential scans
    (slstm_apply: a Python loop of S cell steps each) beside the whole."""
    from repro_torch.models import ssm
    t = CallTimer(torch, ssm, "slstm_apply")
    total = _timed_prefill(torch, eng, prompts, (t,))
    steps = len(t.events) * prompts.shape[1]
    rec = {"probe_prefill_ms": total, "slstm_ms": t.ms,
           "slstm_layers": len(t.events), "slstm_cell_steps": steps}
    log(f"families: xlstm prefill 1x{ARCH_PROMPT} again under CUDA events: "
        f"{total:.1f} ms; the {len(t.events)} sLSTM scans {t.ms:.1f} ms "
        f"({t.ms / total:.1%}), {steps} cell steps, "
        f"{1e3 * t.ms / max(1, steps):.1f} us a step")
    check(len(t.events) == eng.lm.cfg.num_layers // 4,
          f"{len(t.events)} sLSTM layers timed, not one in four")
    return rec


def _zamba2_cache_layout(cfg, B: int, S_max: int) -> dict:
    """zamba2's serving cache as the JAX package's init_cache lays it out,
    written down here from its kvcache.py (tests/test_torch_serving.py
    holds the port's tree to JAX's on the CPU): {path: (shape, dtype)}."""
    H, N, K, di = cfg.mamba_heads, cfg.ssm_state, cfg.ssm_conv, cfg.d_inner
    ssd = {"h": ((B, H, di // H, N), "float32"),
           "conv_x": ((B, K - 1, di), "bfloat16"),
           "conv_B": ((B, K - 1, N), "bfloat16"),
           "conv_C": ((B, K - 1, N), "bfloat16")}
    G, tail = cfg.num_layers // len(cfg.pattern), cfg.num_layers % len(
        cfg.pattern)
    kv = ((G + (1 if tail else 0), B, S_max, cfg.num_kv_heads,
           cfg.resolved_head_dim), "bfloat16")
    out = {"pos": ((), "int32"), "shared/k": kv, "shared/v": kv}
    for j in range(len(cfg.pattern)):
        for n, (shape, dt) in ssd.items():
            out[f"stack/b{j}/{n}"] = ((G,) + shape, dt)
    for j in range(tail):
        for n, (shape, dt) in ssd.items():
            out[f"tail/t{j}/{n}"] = (shape, dt)
    return out


def recurrent_session(torch, dev, args):
    """(b): zamba2-1.2b at full depth serving 4 prompts of 2048: engine A
    generates 32 tokens; engine B 16, then checkpoints its session (the
    38 mamba2 states, the 7 shared K/V caches) and is deleted; engine C
    resumes it (digest verified) and generates 16 more, which must equal
    A's; K6 twice per prefill application on wgmma (counters zeroed just
    before, read just after)."""
    import numpy as np

    from repro_torch.api import CheckpointSession
    from repro_torch.configs import get_config
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.storage import as_tier
    from repro_torch.device import dtype_name
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    cfg = get_config(RECURRENT_ARCH)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    uri = f"mem://chip-smoke-recurrent-{args.seed}"
    out = {"params": lm.n_params()}
    # A, B and C must agree bitwise. warn_only: torch flags a floating
    # cumsum on the card as nondeterministic; the SSD and mLSTM scans
    # cumsum along a non-innermost axis, a sequential scan per column
    torch.use_deterministic_algorithms(True, warn_only=True)
    k6.reset_launches()
    ckpt_codec.reset_launches()
    a = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    a.submit(prompts)
    torch.cuda.synchronize()
    out["prefill_s"] = time.time() - t0
    check(all(bool(torch.isfinite(t).all())
              for _, t in flatten_with_paths(a.cache)),
          "the prefill wrote a non-finite state")
    t0 = time.time()
    want = a.generate(SERVE_GEN).copy()
    out["decode_s_per_token"] = (time.time() - t0) / (SERVE_GEN - 1)
    # A's final state is kept for C's: a random model with tied
    # embeddings tends to repeat a token, so equal tokens alone say little
    want_cache = dict(flatten_with_paths(a.cache))
    del a
    check(want.shape == (SERVE_B, SERVE_GEN) and want.min() >= 0
          and want.max() < cfg.vocab_size, "generated tokens out of range")

    b = ServeEngine(lm, params, max_len=max_len)
    b.submit(prompts)
    b.generate(SERVE_CUT)
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    receipt = b.checkpoint(sess, arch=cfg.name)
    out["dump_s"] = time.time() - t0
    out["image_bytes"] = receipt.stats["bytes_stored"]
    del b
    c = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    res = c.resume_from(CheckpointSession(uri, device=dev))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    got_layout = {p: (tuple(t.shape), dtype_name(t))
                  for p, t in flatten_with_paths(c.cache)}
    image_paths = sorted(r["path"][len("cache/"):]
                         for r in res.manifest["leaves"]
                         if r["path"].startswith("cache/"))
    want_layout = _zamba2_cache_layout(cfg, SERVE_B, max_len)
    state_bytes = sum(int(np.prod(s)) * (4 if d == "float32" else 2)
                      for p, (s, d) in want_layout.items()
                      if not p.startswith("shared/") and p != "pos")
    log(f"families: {cfg.name} session ({cfg.num_layers} mamba2 layers, "
        f"{lm.n_params():,} params): engine A prefill {SERVE_B}x"
        f"{SERVE_PROMPT} {out['prefill_s']:.3f} s, decode "
        f"{out['decode_s_per_token']:.4f} s/token to {SERVE_GEN}; engine B "
        f"checkpointed at {SERVE_CUT} as {receipt.image_id} in "
        f"{out['dump_s']:.2f} s: {out['image_bytes'] / 1e9:.3f} GB stored "
        f"({state_bytes / 1e9:.3f} GB of recurrent state, "
        f"{len(image_paths)} cache leaves); engine C resumed in "
        f"{out['restore_s']:.2f} s, digest_verified={res.digest_verified}")
    check(res.digest_verified is True, "the resumed session's digest was "
                                       "not verified")
    check(image_paths == sorted(want_layout),
          f"the image's cache leaves are not JAX's init_cache paths: "
          f"{image_paths}")
    check(got_layout == want_layout,
          "the resumed cache's shapes or dtypes are not JAX's init_cache's")
    check(np.array_equal(c.generated(), want[:, :SERVE_CUT]),
          "the resumed session's tokens differ from engine A's")
    got = c.generate(SERVE_GEN)
    same = bool(np.array_equal(got, want))
    torch.use_deterministic_algorithms(False)
    routes = dict(k6.ROUTE_LAUNCHES)
    codec = dict(ckpt_codec.LAUNCHES)
    differ = [p for p, t in flatten_with_paths(c.cache)
              if not torch.equal(t, want_cache[p])]
    out.update(k6_routes=routes, tokens_equal=same,
               recurrent_state_bytes=state_bytes, leaves_differ=differ)
    log(f"families: engine C tokens {'equal' if same else 'DIFFER FROM'} "
        f"engine A's at all {SERVE_B}x{SERVE_GEN}; first row "
        f"{got[0, :8].tolist()}...; C's final cache against A's: "
        f"{len(want_cache) - len(differ)} of {len(want_cache)} leaves "
        f"bit-identical; K6 {routes} (expected {RECURRENT_K6} on wgmma), "
        f"codec kernels {sum(codec.values())}")
    check(same, "engine C's continuation differs from engine A's tokens")
    check(not differ, f"engine C's final state differs from engine A's: "
                      f"{differ}")
    check(routes == {"wgmma": RECURRENT_K6, "simt": 0},
          f"the session's K6 launches are not {RECURRENT_K6} on wgmma: "
          f"{routes}")
    del c, params, want_cache
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


def families_path(torch, dev, args):
    """Path 13: (a) the four families' prefill + decode, (b) zamba2's
    session checkpointed with its SSM state and continued, (c) the MoE
    trainer through K1-K4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6

    out = {}
    t0 = time.time()
    out["archs"] = archs_phase(
        torch, dev, args, FAMILIES, "families",
        probes={"granite-moe-3b-a800m": moe_share_probe,
                "xlstm-350m": slstm_probe})
    out["archs_s"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    out["session"] = recurrent_session(torch, dev, args)
    out["session_s"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    k6.reset_launches()
    cfg = get_config("granite-moe-3b-a800m").replace(
        num_layers=MOE_TRAIN_LAYERS)
    tr = train_path(torch, dev, args, cfg=cfg, label="moe-train")
    out["train_s"] = time.time() - t0
    launches = tr["launches"]
    k6_train = sum(k6.LAUNCHES.values())
    log(f"families: moe-train aux (load-balance, mean over layers) "
        f"{tr['aux']}; codec launches {launches} (expected "
        f"{MOE_TRAIN_LAUNCHES}); K6 {k6_train} (training runs xla_flash)")
    check(launches == MOE_TRAIN_LAUNCHES,
          f"the MoE trainer's codec launches {launches} are not the "
          f"predicted {MOE_TRAIN_LAUNCHES}")
    check(all(0.5 < a < cfg.num_experts for a in tr["aux"]),
          f"the load-balance aux {tr['aux']} is out of its range")
    check(k6_train == 0, "K6 launched in training")
    out["train"] = tr
    out["k6_launches"] = sum(
        sum(a["k6_routes"].values()) for a in out["archs"].values()) \
        + sum(out["session"]["k6_routes"].values())
    out["launches"] = dict(launches, flash_attention=out["k6_launches"])
    return out


# ------------------------------------------------------------- vision path
# path 14: qwen2-vl-72b at full width (d_model 8192, 64/8 heads x 128, d_ff
# 29568, vocab 152064; M-RoPE sections 16/24/24), its vision frontend a
# stub (seeded patch embeddings and grid position streams). (a) and (b)
# cut depth from 80 layers to 4, the only cut: 6,002,122,752 params, 24.0
# GB of fp32 weights on the card (80 layers are 72.7 B params, 291 GB).
# (c) trains at 1 of 80 layers, the only cut: params, grads, m and v are
# 13.48 GB each. Its 40.4 GB train state is not dumped here: a lossless
# dump and restore of it take about 90 s on an H100
# (scripts/torch_vision_train_restore.py), more than the script's 1200 s
# limit leaves; the restore onto a mesh runs on (b)'s image, and
# tests/test_torch_distributed.py restores a train state onto a mesh.
VISION_ARCH = "qwen2-vl-72b"
VISION_LAYERS, VISION_TRAIN_LAYERS = 4, 1
VISION_PROMPT, VISION_GEN = 2048, 8          # (a): 1 x 2048, 8 tokens
VISION_B, VISION_SESSION_GEN, VISION_CUT = 4, 16, 8     # (b): 4 x 2048
VISION_TRAIN_SEQ = 512                       # (c): 1 x 512
# K6 launches, written down before the run: one per attention layer per
# prefill, all on wgmma (head dim 128, bf16): (a) three prefills (the grid
# streams, 2-D positions, three equal streams), (b) one
VISION_K6 = {"prefill": 3 * VISION_LAYERS, "session": VISION_LAYERS}


def _events_ms(torch, fn):
    """fn() between two CUDA events -> (its result, device ms)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    r = fn()
    e1.record()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1)


def _greedy(torch, lm, params, logits, cache, n):
    """n greedy decode steps from ``logits`` -> (tokens [B, n], logits,
    cache)."""
    toks = []
    for _ in range(n):
        nxt = logits.argmax(dim=-1, keepdim=True)
        toks.append(nxt)
        logits, cache = lm.decode_step(params, cache, nxt)
    return torch.cat(toks, dim=1), logits, cache


def vision_prefill(torch, dev, args, lm, params):
    """(a): prefill 1 x VISION_PROMPT vision embeddings with the grid's
    M-RoPE streams and 8 greedy tokens; two more prefills of the same
    embeddings, with 2-D positions and with three equal streams, whose
    logits must be bitwise equal (M-RoPE reduces to RoPE) and differ from
    the grid's; K6 VISION_K6["prefill"] times on wgmma (counters zeroed
    just before, read just after); then K6 alone at this shape against
    scaled_dot_product_attention, the same function here (causal, no
    window, no softcap)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.frontends import synthetic_vision_embeds

    cfg, S = lm.cfg, VISION_PROMPT
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = synthetic_vision_embeds(cfg, 1, S, gen, device=dev)
    emb, grid = batch["embeds"], batch["positions"]
    flat = torch.arange(S, dtype=torch.int32, device=dev)[None]
    out = {}
    k6.reset_launches()

    def prefill(pos):
        return _events_ms(torch, lambda: lm.prefill(
            params, embeds=emb, positions=pos, S_max=S + VISION_GEN))
    (l_grid, cache), out["prefill_ms"] = prefill(grid)
    t0 = time.time()
    toks, _, cache = _greedy(torch, lm, params, l_grid, cache, VISION_GEN)
    torch.cuda.synchronize()
    out["decode_s_per_token"] = (time.time() - t0) / VISION_GEN
    del cache
    (l_flat, _), out["prefill_2d_ms"] = prefill(flat)
    (l_eq, _), out["prefill_equal_streams_ms"] = prefill(
        flat[None].expand(3, 1, S))
    routes = dict(k6.ROUTE_LAUNCHES)
    out["k6_routes"] = routes
    equal = torch.equal(l_eq, l_flat)
    differ = not torch.equal(l_grid, l_flat)
    log(f"vision: (a) {cfg.name} ({cfg.num_layers} of 80 layers, "
        f"{lm.n_params():,} params) prefill 1x{S} vision embeddings with "
        f"the grid's M-RoPE streams {out['prefill_ms']:.1f} ms (CUDA "
        f"events), 2-D positions {out['prefill_2d_ms']:.1f} ms, three equal "
        f"streams {out['prefill_equal_streams_ms']:.1f} ms; decode "
        f"{out['decode_s_per_token']:.4f} s/token; tokens "
        f"{toks[0].tolist()}; equal streams' logits bitwise equal to the 2-D "
        f"prefill's: {equal}; the grid's differ: {differ}; K6 {routes} "
        f"(expected {VISION_K6['prefill']} on wgmma)")
    check(tuple(l_grid.shape) == (1, cfg.padded_vocab)
          and bool(torch.isfinite(l_grid[:, :cfg.vocab_size]).all()),
          "the vision prefill's logits are not finite [1, V]")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "the vision decode's tokens are out of range")
    check(equal, "M-RoPE with three equal streams differs from 2-D RoPE")
    check(differ, "the grid's M-RoPE streams did not change the logits")
    check(routes == {"wgmma": VISION_K6["prefill"], "simt": 0},
          f"the vision prefills' K6 launches are not "
          f"{VISION_K6['prefill']} on wgmma: {routes}")
    del l_grid, l_flat, l_eq, emb, batch

    # K6 alone at the prefill's attention shape, beside SDPA
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn((1, S, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, S, KV, hd), generator=gen, device=dev).bfloat16()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention
    calls = {"k6": lambda: k6.flash_attention_fwd(q, k, v, causal=True),
             "sdpa": lambda: lib(qt, kt, vt, is_causal=True,
                                 enable_gqa=True)}
    err = float((calls["k6"]().float()
                 - calls["sdpa"]().transpose(1, 2).float()).abs().max())
    ms = cuda_ms(torch, calls["k6"], iters=20)
    lib_ms = cuda_ms(torch, calls["sdpa"], iters=20)
    b2b = {"k6": [], "sdpa": []}
    for who in ("k6", "sdpa", "sdpa", "k6"):
        b2b[who].append(cuda_ms(torch, calls[who], iters=5, batch=20))
    bound_ms, bound_by, pairs, ops, nbytes = _bound(1, S, S, H, KV, hd, 0)
    out["k6_alone"] = {"shape": [1, S, S, H, KV, hd], "ms": ms,
                       "library_ms": lib_ms, "ms_back_to_back": b2b["k6"],
                       "library_ms_back_to_back": b2b["sdpa"],
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "live_pairs": pairs, "ops": ops, "bytes": nbytes,
                       "max_abs_err_vs_sdpa": err}
    log(f"vision: K6 at the prefill's shape 1x{S} {H}/{KV} heads x{hd} "
        f"bf16 causal: {ms:.4f} ms one call, {min(b2b['k6']):.4f}-"
        f"{max(b2b['k6']):.4f} back to back (20 calls a timing, in turns "
        f"K6 SDPA SDPA K6); scaled_dot_product_attention {lib_ms:.4f} / "
        f"{min(b2b['sdpa']):.4f}-{max(b2b['sdpa']):.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.1f} GFLOP over "
        f"{pairs:,} live pairs, {nbytes / 1e6:.1f} MB): "
        f"{bound_ms / ms:.1%} one call, {bound_ms / min(b2b['k6']):.1%} "
        f"back to back; max |K6 - SDPA| {err:.3g}")
    check(err < 2e-2, f"K6 differs from SDPA at the vision prefill's shape: "
                      f"{err:.3g}")
    return out


def vision_session(torch, dev, args, lm, params):
    """(b): prefill VISION_B x VISION_PROMPT vision embeddings, 16 greedy
    tokens; after 8 the session state {cache, tokens so far, last logits}
    is dumped through CheckpointSession (lossless, mem://); the
    uninterrupted run goes on to 16; the image is restored onto a (1, 1)
    mesh of the card (RestoreRequest(shardings=named(mesh, specs),
    mesh=mesh) from a session opened on the CPU: the cache's specs are
    kvcache.cache_pspecs under cache_rules), and the fresh tensors decode
    the last 8: their tokens and every final cache leaf must equal the
    uninterrupted run's bitwise. K6 VISION_K6["session"] times on wgmma,
    the codec kernels not at all."""
    from repro_torch.api import CheckpointSession, DumpRequest, RestoreRequest
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.storage import as_tier
    from repro_torch.distributed.sharding import (PartitionSpec, batch_axes,
                                                  cache_rules, named)
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import kvcache
    from repro_torch.models.frontends import synthetic_vision_embeds

    cfg, S = lm.cfg, VISION_PROMPT
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batch = synthetic_vision_embeds(cfg, VISION_B, S, gen, device=dev)
    uri = f"mem://chip-smoke-vision-{args.seed}"
    out = {}
    k6.reset_launches()
    ckpt_codec.reset_launches()
    (logits, cache), out["prefill_ms"] = _events_ms(torch, lambda: lm.prefill(
        params, embeds=batch["embeds"], positions=batch["positions"],
        S_max=S + VISION_SESSION_GEN))
    t0 = time.time()
    first, logits, cache = _greedy(torch, lm, params, logits, cache,
                                   VISION_CUT)
    torch.cuda.synchronize()
    out["decode_s_per_token"] = (time.time() - t0) / VISION_CUT
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    receipt = sess.dump(DumpRequest(
        state={"cache": cache, "tokens": first, "logits": logits},
        step=VISION_CUT))
    out["dump_s"] = time.time() - t0
    out["image_bytes"] = receipt.stats["bytes_stored"]
    rest, _, cache = _greedy(torch, lm, params, logits, cache,
                             VISION_SESSION_GEN - VISION_CUT)
    want = torch.cat([first, rest], dim=1)
    want_cache = dict(flatten_with_paths(cache))
    del cache, logits
    mesh = make_test_mesh((1, 1), device=dev)
    shape = ShapeConfig("vision-session", "decode", S + VISION_SESSION_GEN,
                        VISION_B)
    rows = PartitionSpec(batch_axes(mesh, VISION_B), None)
    specs = {"cache": kvcache.cache_pspecs(cfg, cache_rules(cfg, mesh, shape)),
             "tokens": rows, "logits": rows}
    t0 = time.time()
    res = CheckpointSession(uri, device="cpu").restore(RestoreRequest(
        shardings=named(mesh, specs), mesh=mesh))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    st = res.state
    on_card = all(t.device == dev for _, t in flatten_with_paths(st))
    rest, _, cache = _greedy(torch, lm, params, st["logits"], st["cache"],
                             VISION_SESSION_GEN - VISION_CUT)
    got = torch.cat([st["tokens"], rest], dim=1)
    same = torch.equal(got, want)
    differ = [p for p, t in flatten_with_paths(cache)
              if not torch.equal(t, want_cache[p])]
    routes, codec = dict(k6.ROUTE_LAUNCHES), dict(ckpt_codec.LAUNCHES)
    out.update(k6_routes=routes, tokens_equal=same, leaves_differ=differ,
               codec_launches=codec)
    log(f"vision: (b) session {VISION_B}x{S} vision embeddings: prefill "
        f"{out['prefill_ms']:.1f} ms (CUDA events), decode "
        f"{out['decode_s_per_token']:.4f} s/token; checkpointed after "
        f"{VISION_CUT} tokens as {receipt.image_id} in {out['dump_s']:.2f} "
        f"s: {out['image_bytes'] / 1e9:.4f} GB stored ({out['image_bytes']:,}"
        f" bytes: the K/V cache of {cfg.num_layers} layers x {VISION_B} x "
        f"{S + VISION_SESSION_GEN} positions, pos, tokens, logits); "
        f"restored onto a (1, 1) mesh of the card (cache_pspecs; a session "
        f"opened on the CPU) in {out['restore_s']:.2f} s; tokens "
        f"{'equal' if same else 'DIFFER FROM'} the uninterrupted run's at "
        f"all {VISION_B}x{VISION_SESSION_GEN}; final cache "
        f"{len(want_cache) - len(differ)} of {len(want_cache)} leaves "
        f"bit-identical; K6 {routes} (expected {VISION_K6['session']} on "
        f"wgmma), codec kernels {sum(codec.values())}")
    check(on_card, "the session restored onto the mesh is not on the card")
    check(same, "the restored session's tokens differ from the "
                "uninterrupted run's")
    check(not differ, f"the restored session's final cache differs: "
                      f"{differ}")
    check(routes == {"wgmma": VISION_K6["session"], "simt": 0},
          f"the session's K6 launches are not {VISION_K6['session']} on "
          f"wgmma: {routes}")
    check(sum(codec.values()) == 0, f"codec kernels ran in a lossless "
                                    f"session dump: {codec}")
    del st, cache, want_cache, res
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


def _compress_checks(torch, g, q, scale, err, deq):
    """-> (worst |g - deq| / (scale/2) over the leaf's live blocks, whether
    the error state equals g - q*scale rounded once) of one gradient leaf,
    a slice of blocks at a time (float64: the product and the difference
    are exact there)."""
    from repro_torch.optim.compress import BLOCK
    n = g.numel()
    gf, ef, df = g.reshape(-1), err.reshape(-1), deq.reshape(-1)
    worst, exact = 0.0, True
    step = 2048 * BLOCK
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        blk = torch.arange(lo, hi, device=g.device) // BLOCK
        s = scale[blk]
        e = (gf[lo:hi] - df[lo:hi]).abs()
        live = s > 0
        if bool(live.any()):
            worst = max(worst, float((e[live] / (s[live] / 2)).max()))
        check(bool((e[~live] == 0).all()), "a zero block decompressed "
                                           "to a nonzero value")
        want = (gf[lo:hi].double() - q.reshape(-1)[lo:hi].double()
                * s.double()).float()
        exact = exact and torch.equal(ef[lo:hi], want)
    return worst, exact


def vision_train(torch, dev, args):
    """(c): a qwen2-vl-72b trainer at 1 of 80 layers: one step of the loss
    on 1 x VISION_TRAIN_SEQ vision embeddings with labels and M-RoPE
    streams through the port's AdamW; the step's gradients through
    compress_tree -> decompress_tree (every element within scale/2 of its
    block, the error state g - deq rounded once, wire bytes <= 0.26 of the
    fp32 bytes), a leaf at a time: the whole tree at once would hold its
    error state, int8 payload and decompressed copy beside the state and
    the gradients, 91 GiB."""
    from repro_torch.configs import get_config
    from repro_torch.core import flatten_with_paths
    from repro_torch.models.frontends import synthetic_vision_embeds
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.optim.compress import (compress_tree, decompress_tree,
                                            init_error_state, wire_bytes)
    from repro_torch.training import init_train_state
    from repro_torch.training import train_loop
    cfg = get_config(VISION_ARCH).replace(num_layers=VISION_TRAIN_LAYERS)
    lm = LM(cfg)
    out = {"params": lm.n_params()}
    t0 = time.time()
    state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    batch = synthetic_vision_embeds(cfg, 1, VISION_TRAIN_SEQ, gen,
                                    device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.time() - t0
    t0 = time.time()
    loss, metrics, grads = train_loop._grads(lm, state["params"], batch)
    torch.cuda.synchronize()
    out["grad_s"] = time.time() - t0
    out["loss"] = float(loss)
    check(bool(torch.isfinite(loss)), f"the vision trainer's loss is "
                                      f"{float(loss)}")

    t0 = time.time()
    wire = raw = 0
    worst, exact = 0.0, True
    for path, g in flatten_with_paths(grads):
        one = {"g": g}
        comp, err = compress_tree(one, init_error_state(one))
        deq = decompress_tree(comp, one)["g"]
        w, e = _compress_checks(torch, g, comp["g"][0], comp["g"][1],
                                err["g"], deq)
        worst, exact = max(worst, w), exact and e
        wire += wire_bytes(comp)
        raw += g.numel() * 4
        del comp, err, deq, one
    torch.cuda.synchronize()
    out.update(compress_s=time.time() - t0, wire_bytes=wire, raw_bytes=raw,
               worst_err_over_half_scale=worst, error_state_exact=exact)
    t0 = time.time()
    state, metrics = train_loop._apply(state, grads, OptConfig(), metrics)
    torch.cuda.synchronize()
    out["adamw_s"] = time.time() - t0
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    out["step_peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"vision: (c) {cfg.name} trainer ({cfg.num_layers} of 80 layers, "
        f"{lm.n_params():,} params, {raw / 1e9:.2f} GB a tree): loss on 1x"
        f"{VISION_TRAIN_SEQ} vision embeddings {out['loss']:.4f}, forward + "
        f"backward {out['grad_s']:.2f} s, AdamW {out['adamw_s']:.3f} s; "
        f"gradients compressed and decompressed in {out['compress_s']:.2f} "
        f"s: wire {wire / 1e9:.3f} GB = {wire / raw:.4f} of fp32, worst "
        f"|g - deq| {worst:.4f} of scale/2, error state = g - q*scale "
        f"rounded once: {exact}; device peak "
        f"{out['step_peak_device_gb']:.1f} GB")
    check(wire <= 0.26 * raw, f"wire bytes {wire / raw:.4f} of fp32")
    check(worst <= 1.001, f"a gradient element lies {worst:.4f} of scale/2 "
                          f"from its block's value")
    check(exact, "the error state is not g - deq")
    check(bool(torch.isfinite(metrics["grad_norm"])),
          "the gradient norm is not finite")

    del state, metrics
    return out


def vision_path(torch, dev, args):
    """Path 14: (a) qwen2-vl-72b's vision prefill and decode, (b) a vision
    session checkpointed, restored onto a mesh and continued, (c) a train
    step with gradient compression."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = get_config(VISION_ARCH).replace(num_layers=VISION_LAYERS)
    lm = LM(cfg)
    out = {}
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.time() - t0
    log(f"vision: {cfg.name} d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE sections "
        f"{cfg.mrope_sections}; cut: num_layers 80 -> {cfg.num_layers} (the "
        f"only cut), {lm.n_params():,} params, initialized on the card in "
        f"{out['init_s']:.1f} s")
    # (a) and (b) must agree bitwise with themselves: deterministic
    # kernels (warn_only, as path 13's session)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.time()
        out["prefill"] = vision_prefill(torch, dev, args, lm, params)
        out["prefill_s"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        out["session"] = vision_session(torch, dev, args, lm, params)
        out["session_s"] = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    out["train"] = vision_train(torch, dev, args)
    out["train_s"] = time.time() - t0
    out["launches"] = {"flash_attention": sum(
        sum(out[k]["k6_routes"].values()) for k in ("prefill", "session"))}
    return out


# -------------------------------------------------------------- dry-run path
DRYRUN_ARCH = "qwen3-8b"
DRYRUN_MEASURED = ("train_4k", "prefill_32k", "decode_32k")
# (d): each example and the lines it must print. The preemption drill
# repeats path 7's lifecycle and runs on the CPU in
# tests/test_torch_examples.py; its time went to path 16
DRYRUN_EXAMPLES = {
    "quickstart_torch.py": (
        "continuation bitwise identical: True",
        "migrated serving session identical: True", "quickstart OK"),
    "elastic_resize_torch.py": (
        "restore onto (2 data, 4 model): bit-identical, digest verified",
        "restore onto (8 data, 1 model): bit-identical",
        "continued on mesh (2 data, 4 model): replay-deterministic",
        "cross-mesh continuation equals uninterrupted run bitwise",
        "4-host -> 2-host migration, deterministic DP: bit-identical",
        "elastic resize drill OK"),
}
DRYRUN_EXAMPLE_TIMEOUT_S = 300


def dryrun_whole(tmp) -> dict:
    """(a): --all --both-meshes without measurement -> per-arch summary."""
    import io

    from repro_torch import configs
    from repro_torch.configs.base import param_count
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.models.params import tree_leaves

    out_dir = os.path.join(tmp, "records")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--all", "--both-meshes", "--no-measure", "--out",
                     out_dir])
    wall = time.time() - t0
    recs = []
    for fn in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, fn)) as f:
            recs.append(json.load(f))
    want = 2 * len(configs.cells())
    log(f"dryrun: (a) --all --both-meshes --no-measure on meta: "
        f"{len(recs)} records in {wall:.2f} s")
    check(len(recs) == want == 64, f"{len(recs)} records, want {want}")
    per_arch = {}
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_config(arch)
        n = sum(t.numel() for t in tree_leaves(LM(cfg).abstract()))
        mine = [r for r in recs if r["arch"] == arch]
        for r in mine:
            check(r["analytic"]["n_params"] == n,
                  f"{arch} x {r['shape']}: n_params "
                  f"{r['analytic']['n_params']} != {n}, its params tree's")
        top = max(mine, key=lambda r: r["bytes_per_device"]["total"])
        where = "x".join(str(v) for v in top["mesh"]["axes"].values())
        per_arch[arch] = {"n_params": n, "param_count": param_count(cfg),
                          "max_bytes": top["bytes_per_device"]["total"],
                          "at": f"{top['shape']} on {where}"}
        parts = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                          top["bytes_per_device"].items() if k != "total")
        log(f"dryrun: {arch}: n_params {n:,} (analytic param_count "
            f"{per_arch[arch]['param_count']:,}); largest per-device bytes "
            f"{per_arch[arch]['max_bytes'] / 1e9:.3f} GB at "
            f"{per_arch[arch]['at']} ({parts} GB)")
    return {"records": len(recs), "wall_s": wall, "per_arch": per_arch}


def dryrun_measured() -> dict:
    """(b): measure_totals of qwen3-8b's three shapes on the (16, 16) mesh
    record."""
    from repro_torch.launch import dryrun
    mesh = dryrun.production_mesh_record(multi_pod=False)
    out = {}
    for shape in DRYRUN_MEASURED:
        t0 = time.time()
        tot = dryrun.measure_totals(DRYRUN_ARCH, shape, mesh)
        out[shape] = dict(tot, wall_s=time.time() - t0)
        check("flops" in tot and tot["flops"] > 0,
              f"measure_totals {DRYRUN_ARCH} x {shape}: {tot}")
        log(f"dryrun: (b) {DRYRUN_ARCH} x {shape} on 16x16: "
            f"{tot['flops']:.4e} FLOPs per device, {tot['step_flops']:.4e} a "
            f"step, traced in {tot['trace_s']:.2f} s ({tot['method']})")
    return out


def dryrun_card(torch, dev, args) -> dict:
    """(c): the dry run's record of the serve path's cache against the
    real one on the card (path 17(b) checks a train state's bytes and a
    step's FLOPs, at full depth)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import kvcache

    one = make_test_mesh((1, 1), device="meta")
    out = {}
    full = get_config(DRYRUN_ARCH)
    S_max = SERVE_PROMPT + SERVE_GEN + 1
    drec = dryrun.run_cell(DRYRUN_ARCH, ShapeConfig("chip_serve", "decode",
                                                    S_max, SERVE_B),
                           mesh=one, measure=False, verbose=False)
    cache = kvcache.init_cache(full, SERVE_B, S_max, device=dev)
    real = sum(t.numel() * t.element_size() for t in _leaves(cache))
    out.update(plan_cache_bytes=drec["bytes_per_device"]["cache"],
               cache_bytes=real)
    log(f"dryrun: (c) the serve path's cache ({full.num_layers} layers, "
        f"{SERVE_B} x {S_max}): the record {out['plan_cache_bytes']:,} B, "
        f"kvcache.init_cache on the card {real:,} B")
    check(real == out["plan_cache_bytes"], "cache bytes differ")
    del cache
    return out


def start_examples(tmp, dev) -> dict:
    """(d): every example on ``dev``, each a subprocess, all at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    procs = {}
    for name in DRYRUN_EXAMPLES:
        logf = open(os.path.join(tmp, name + ".log"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", name),
             "--device", dev.type], env=env, stdout=logf,
            stderr=subprocess.STDOUT, text=True), logf, time.time())
    return procs


def finish_examples(procs, kill=False) -> dict:
    """Wait for (or kill) every example, then check each one's exit code
    and printed invariants."""
    out, texts = {}, {}
    while len(out) < len(procs):       # each one's own end, polled
        for name, (proc, logf, t0) in procs.items():
            if name in out:
                continue
            over = time.time() - t0 > DRYRUN_EXAMPLE_TIMEOUT_S
            if kill or over:
                proc.kill()
            rc = proc.wait() if kill or over else proc.poll()
            if rc is None:
                continue
            logf.seek(0)
            out[name] = {"rc": "timeout" if over else rc,
                         "wall_s": time.time() - t0}
            texts[name] = logf.read()
            logf.close()
        time.sleep(0.05)
    if kill:
        return out
    for name, r in out.items():
        log(f"dryrun: (d) {name} --device cuda: exit {r['rc']} after "
            f"{r['wall_s']:.1f} s (started with path 17)")
        missing = [ln for ln in DRYRUN_EXAMPLES[name]
                   if ln not in texts[name]]
        check(r["rc"] == 0 and not missing,
              f"{name} on the card: exit {r['rc']}, missing {missing}; its "
              f"output ends:\n{texts[name][-3000:]}")
    return out


class Beside:
    """``fn()`` on a thread; ``join()`` waits, then returns its result or
    raises its error."""

    def __init__(self, fn):
        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn,),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn):
        try:
            self.result = fn()
        except BaseException as e:      # re-raised by join()
            self.error = e

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def dryrun_path(torch, dev, args, beside=None):
    """Path 15: (c) the card cross-check, then (a) and (b) on the meta
    device, then the examples (d) on the card. ``beside`` (path 17)
    starts on a thread with (d), whose examples leave the card and the
    host mostly idle (after (a) and (b), whose tracing would hold the
    interpreter); the path waits for it and returns its result as
    ``out["beside"]``."""
    import tempfile
    out = {}
    t0 = time.time()
    out["card"] = dryrun_card(torch, dev, args)
    out["card_s"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-dryrun-") as tmp:
        t0 = time.time()
        out["whole"] = dryrun_whole(tmp)
        out["measured"] = dryrun_measured()
        out["meta_s"] = time.time() - t0
        side = Beside(beside) if beside else None
        try:
            t0 = time.time()
            out["examples"] = finish_examples(start_examples(tmp, dev))
            out["examples_s"] = time.time() - t0
        finally:
            if side:                    # its processes end with it
                side.thread.join()
    if side:
        out["beside"] = side.join()
    return out


# --------------------------------------------------------------- crash path
# path 16: a node failure during a dump. gemma2-2b at full width, cut to
# path 11's 2 of 26 layers (an 8.95 GB lossless train state), path 7's
# batch, through the training CLI as path 7 runs it. The victim dumps
# every CRASH_EVERY steps to a file:// tier and is SIGKILLed inside its
# step-CRASH_KILL_AT dump: once that dump has put a chunk or temporary
# file into the pool beyond the previous image's set, while its manifest
# does not exist yet (the pool polled every CRASH_POLL_S)
CRASH_STEPS, CRASH_EVERY, CRASH_KILL_AT = 10, 4, 8
CRASH_MODEL = ["--arch", "gemma2-2b", "--full", "--layers", "2"]
CRASH_POLL_S = 0.02
CRASH_WAIT_S = 600               # for the step-4 image, then the kill


def _crash_cfg(flags):
    """The model config the launcher builds from ``flags``."""
    from repro_torch.launch.train import build_cfg
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--full", dest="tiny", action="store_false")
    for f in ("--layers", "--d-model", "--d-ff", "--vocab"):
        ap.add_argument(f, type=int, default=0)
    return build_cfg(ap.parse_args(flags))


def _pool(root) -> set:
    try:
        return set(os.listdir(os.path.join(root, "chunks")))
    except FileNotFoundError:
        return set()


def _pool_bytes(root, names) -> int:
    n = 0
    for name in names:
        with contextlib.suppress(FileNotFoundError):
            n += os.path.getsize(os.path.join(root, "chunks", name))
    return n


def _manifest_of(root, step: int) -> str:
    return os.path.join(root, "images", f"step_{step:010d}", "manifest.json")


def _rss_of(pid: int, page=os.sysconf("SC_PAGE_SIZE")) -> int:
    with contextlib.suppress(OSError):
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * page
    return 0


def _read_lines(child):
    """Read a child's stdout on a thread (each line stamped on arrival)."""
    t = threading.Thread(target=lambda: [None for _ in child], daemon=True)
    t.start()
    return t


def crash_path(torch, dev, args):
    """Path 16: a node failure during a dump, through the port's CLI
    (python -m repro_torch.launch.train) in fresh processes under path 7's
    wrapper. (a) a reference run without a checkpoint directory, beside
    (b) the victim, SIGKILLed inside its step-CRASH_KILL_AT dump. Then: no
    manifest of that step; the registry's latest image is the previous
    one, whose manifest digest verifies; after gc every chunk left in the
    pool is referenced by a retained manifest (temporary files inside
    gc's quiet period are kept, by design). (c) --resume in a new process
    restores that image onto the card (every chunk through its SHA-256
    check), re-dumps step CRASH_KILL_AT and logs losses within 1e-5
    relative of the reference's."""
    import shutil
    import signal as _signal
    import tempfile

    from repro_torch.core import Registry, flatten_with_paths
    from repro_torch.core.integrity import manifest_digest
    from repro_torch.core.registry import GC_TMP_DEAD_PID_GRACE_S
    from repro_torch.core.restore import read_manifest
    from repro_torch.models.model import LM
    from repro_torch.training import abstract_train_state

    t_path = time.time()
    cfg = _crash_cfg(CRASH_MODEL)
    struct = flatten_with_paths(abstract_train_state(LM(cfg)))
    state_bytes = sum(t.numel() * t.element_size() for _, t in struct)
    before, victim = CRASH_KILL_AT - CRASH_EVERY, CRASH_KILL_AT
    tmp = tempfile.mkdtemp(prefix="chip-smoke-crash-",
                           dir=args.lifecycle_dir)
    root = os.path.join(tmp, "ck")
    out = {"leaves": len(struct), "state_bytes": state_bytes}
    started = []
    try:
        # the step-4 image, the victim's partial dump, the restart's 8 and 10
        need = 4 * state_bytes * 1.1 + 2e9
        free = shutil.disk_usage(tmp).free
        log(f"crash: {cfg.name} at full width (d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {cfg.num_layers} "
            f"layers; train state {state_bytes / 1e9:.2f} GB in "
            f"{len(struct)} leaves, dumped losslessly every {CRASH_EVERY} "
            f"steps; {tmp}: {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
            f"needed")
        check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free, the "
                            f"crash path needs {need / 1e9:.1f} GB; pass "
                            f"--lifecycle-dir on a larger disk")
        base = CRASH_MODEL + LIFECYCLE_BATCH + [
            "--steps", str(CRASH_STEPS), "--log-every", "1"]
        ck = ["--data-dir", os.path.join(tmp, "data"), "--ckpt-dir",
              "file://" + root, "--ckpt-every", str(CRASH_EVERY)]

        log(f"crash: (a) reference run (no checkpoint dir) beside (b) the "
            f"victim, SIGKILLed inside its step-{victim} dump")
        ref = Child(base + ["--data-dir", os.path.join(tmp, "ref-data")],
                    tmp, "reference", dev, started)
        vic = Child(base + ck, tmp, "victim", dev, started)
        readers = [_read_lines(ref), _read_lines(vic)]
        vic_peak = 0
        t0 = time.time()
        while not os.path.exists(_manifest_of(root, before)):
            check(vic.p.poll() is None, f"the victim exited "
                  f"{vic.p.returncode} before its step-{before} image")
            check(time.time() - t0 < CRASH_WAIT_S,
                  f"no step-{before} image in {CRASH_WAIT_S} s")
            vic_peak = max(vic_peak, _rss_of(vic.p.pid))
            time.sleep(CRASH_POLL_S)
        t_image = time.time() - vic.t0
        kept_set = _pool(root)
        while True:
            late = os.path.exists(_manifest_of(root, victim))
            if (_pool(root) - kept_set) and not late:
                vic.p.send_signal(_signal.SIGKILL)
                t_kill = time.time() - vic.t0
                break
            check(not late, f"the step-{victim} manifest exists before the "
                            f"poll saw a file of its dump: the kill cannot "
                            f"land inside the dump (poll faster)")
            check(vic.p.poll() is None,
                  f"the victim exited {vic.p.returncode} before the kill")
            check(time.time() - t0 < CRASH_WAIT_S,
                  f"no step-{victim} dump in {CRASH_WAIT_S} s")
            vic_peak = max(vic_peak, _rss_of(vic.p.pid))
            time.sleep(CRASH_POLL_S)
        readers[1].join(timeout=60)
        rc = vic.finish(record=False)
        check(rc == -_signal.SIGKILL, f"the victim exited {rc}, not "
                                      f"-SIGKILL ({-_signal.SIGKILL})")
        check(not os.path.exists(_manifest_of(root, victim)),
              f"the kill landed after the step-{victim} manifest was "
              f"committed: the dump had ended (poll faster)")
        partial = _pool(root) - kept_set
        t_dump = vic.at(f'"step": {victim},')    # the dump follows the line
        out.update(victim_first_step_s=vic.at('"step": 1,'),
                   victim_dump_s=t_image - vic.at(f'"step": {before},'),
                   kill_s_into_dump=t_kill - t_dump,
                   kill_bytes=_pool_bytes(root, partial),
                   kill_files=len(partial),
                   kill_tmp_files=sum(not n.endswith(".bin")
                                      for n in partial),
                   victim_host_peak_gb=vic_peak / 1e9)
        log(f"crash: the victim's first step line "
            f"{out['victim_first_step_s']:.2f} s from its start; its "
            f"step-{before} dump "
            f"{out['victim_dump_s']:.2f} s (the step line to the manifest); "
            f"SIGKILL {out['kill_s_into_dump']:.3f} s after the "
            f"step-{victim} line (the dump starts there), "
            f"{out['kill_bytes'] / 1e9:.4f} GB of the dump in the pool "
            f"({len(partial)} files, {out['kill_tmp_files']} of them "
            f"temporary); rc {rc}; no step-{victim} manifest")

        readers[0].join(timeout=CRASH_WAIT_S)
        check(ref.finish() == 0, f"the reference run exited {ref.rc}")
        want = ref.losses()
        check(sorted(want) == list(range(1, CRASH_STEPS + 1)),
              f"the reference logged steps {sorted(want)}")

        reg = Registry(root)
        latest = reg.latest()
        check(latest is not None and latest["step"] == before,
              f"the registry's latest image is {latest}, not step {before}")
        stats = reg.gc()
        referenced = set()
        for m in reg.images():
            for rec in read_manifest(reg.tier, m["image_id"])["leaves"]:
                referenced.update(rec["chunks"])
        left = _pool(root)
        stray = sorted(n for n in left if n.endswith(".bin")
                       and n.removesuffix(".bin") not in referenced)
        tmp_kept = sorted(n for n in left if not n.endswith(".bin"))
        out.update(gc_removed=stats["removed"], gc_tmp_kept=len(tmp_kept),
                   pool_chunks=len(left) - len(tmp_kept))
        log(f"crash: latest image {latest['image_id']}; gc reaped "
            f"{stats['removed']} files (the dump's orphaned chunks), kept "
            f"{len(tmp_kept)} temporary files inside its "
            f"{GC_TMP_DEAD_PID_GRACE_S} s quiet period; "
            f"{out['pool_chunks']} chunks left, unreferenced {len(stray)}")
        check(not stray, f"{len(stray)} chunks left unreferenced after gc: "
                         f"{stray[:3]}")
        for n in tmp_kept:
            age = reg.tier.age_s(f"chunks/{n}")
            check(f".tmp.{vic.p.pid}." in n and age is not None
                  and age <= GC_TMP_DEAD_PID_GRACE_S,
                  f"gc kept {n} (age {age} s) outside its quiet period")

        # the step-4 image's manifest (read_manifest checks its digest);
        # (c)'s restore of it reads every chunk through its SHA-256 check
        man = read_manifest(reg.tier, latest["image_id"])
        stored = sum(rec["nbytes"] for rec in man["leaves"])
        check(manifest_digest(man) == man["digest"]
              and [r["path"] for r in man["leaves"]] == [p for p, _ in struct]
              and stored == state_bytes,
              f"the step-{before} manifest holds {len(man['leaves'])} "
              f"leaves, {stored} B, not the train state's")

        log("crash: (c) restart (--resume, a fresh process)")
        res = Child(base + ck + ["--resume"], tmp, "restarted", dev, started)
        check(res.finish() == 0, f"the restarted run exited {res.rc}")
        (rst,) = res.rec["calls"]["restore"]
        check(rst["image_id"] == latest["image_id"],
              f"the restart restored {rst['image_id']}, not "
              f"{latest['image_id']}")
        log(f"crash: {latest['image_id']} restored onto the card by the "
            f"restart in {rst['s']:.2f} s ({stored / 1e9:.2f} GB; the "
            f"manifest digest and every chunk's SHA-256 verified)")
        line = next((ln for _, ln in res.lines if "resumed from" in ln), "")
        check(f"resumed from step_{before:010d} at step {before}" in line,
              f"the restart did not resume from step {before}: {line!r}")
        got = res.losses()
        check(sorted(got) == list(range(before + 1, CRASH_STEPS + 1)),
              f"the restart logged steps {sorted(got)}")
        worst, bitwise = 0.0, True
        for s_, loss in got.items():
            rel = abs(loss - want[s_]) / abs(want[s_])
            worst, bitwise = max(worst, rel), bitwise and loss == want[s_]
            check(rel <= 1e-5, f"step {s_}: loss {loss} vs the reference's "
                               f"{want[s_]} ({rel:.2e} relative)")
        images = [m["step"] for m in Registry(root).images()]
        check(victim in images and images[-1] == CRASH_STEPS,
              f"after the restart the images are steps {images}")
        for name, c in (("reference", ref), ("restarted", res)):
            check(not any(c.rec["launches"].values()),
                  f"a kernel ran in the {name} run (lossless path): "
                  f"{c.rec['launches']}")
        t_first = res.at(f'"step": {before + 1},')
        saves = res.rec["calls"]["save"]
        out.update(
            restart_saves=[(r["image_id"], r["s"], r["bytes_stored"])
                           for r in saves],
            reference_done_s=ref.at("done at step"), restart_wall_s=res.wall_s)
        log(f"crash: the restart's dumps " + ", ".join(
            f"{i} {t:.2f} s ({b / 1e9:.2f} GB stored)"
            for i, t, b in out["restart_saves"]) + f"; the restart took "
            f"{res.wall_s:.1f} s; the reference ended "
            f"{out['reference_done_s']:.1f} s after its start")
        out.update(
            resume_restore_s=rst["s"], resume_to_first_step_s=t_first,
            resumed_line_to_first_step_s=t_first - res.at("resumed from"),
            worst_rel_loss=worst, bitwise=bitwise, images=images,
            reference_losses=want, restarted_losses=got,
            reference_peak_device_gb=ref.rec["peak_device_bytes"] / 1e9,
            reference_host_peak_gb=ref.rec["host_peak_rss_bytes"] / 1e9,
            restarted_peak_device_gb=res.rec["peak_device_bytes"] / 1e9,
            restarted_host_peak_gb=res.rec["host_peak_rss_bytes"] / 1e9)
        log(f"crash: restarted at step {before}, re-dumped step {victim} "
            f"(images now steps {images}); its {len(got)} losses within "
            f"{worst:.2e} relative of the reference's (limit 1e-5), "
            f"bitwise equal: {bitwise}")
        log(f"crash: resume -> first step {t_first:.2f} s from process "
            f"start (its restore {rst['s']:.2f} s, the first step line "
            f"{out['resumed_line_to_first_step_s']:.2f} s after the resumed "
            f"line)")
        log(f"crash: peak device memory (max_memory_allocated) reference "
            f"{out['reference_peak_device_gb']:.1f} GB, restarted "
            f"{out['restarted_peak_device_gb']:.1f} GB (the victim's: not "
            f"measured, SIGKILL leaves no record); host peak RSS reference "
            f"{out['reference_host_peak_gb']:.1f} GB, victim "
            f"{out['victim_host_peak_gb']:.1f} GB (sampled from outside "
            f"every {CRASH_POLL_S * 1e3:.0f} ms), restarted "
            f"{out['restarted_host_peak_gb']:.1f} GB")
    finally:
        for p in started:               # a failed check leaves none running
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.time() - t_path
    return out


# --------------------------------------------------------------- remat path
# path 17: rematerialisation in the trainer, gemma2-2b at full width. (a)
# the three policies side by side at REMAT_A_LAYERS layers, 1 x REMAT_SEQ;
# (b) the whole depth at REMAT_BATCH x REMAT_SEQ under the default policy,
# which fits the card only with remat; (c) its state dumped with bf16
# moments (K2) and continued from the restored image
REMAT_ARCH = "gemma2-2b"
REMAT_SEQ = 4096                 # train_4k's length
REMAT_A_LAYERS = 2
REMAT_POLICIES = ("none", "dots", "full")
REMAT_BATCH = 2
REMAT_MICROBATCHES = 1           # 2 x 4096 fits in one under dots
REMAT_STEPS = 3                  # (b): timed after the counted first step
REMAT_GRAD_TOL = 1e-5            # (a): of each leaf's largest magnitude
REMAT_HOST_GB = 90               # (c): the host peak's limit
REMAT_PEAK_TOL = 0.05            # (a), (b): the dry run's peak vs the card's


def _seq_tokens(torch, dev, cfg, rng, B):
    t = rng.integers(0, cfg.vocab_size, (B, REMAT_SEQ)).astype("int64")
    return {"tokens": torch.from_numpy(t).to(dev)}


def remat_policies(torch, dev, args) -> dict:
    """(a): one loss and backward pass under each policy from the same
    params, and a forward at twice the depth for the bytes per layer;
    the same pass traced on meta, whose peak above the params (the dry
    run's StepCost) must lie within REMAT_PEAK_TOL of the card's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.stepcost import StepCost
    from repro_torch.models.model import LM, saved_for_backward
    from repro_torch.models.params import tree_leaves, tree_map

    full = get_config(REMAT_ARCH)
    cfg = full.replace(num_layers=REMAT_A_LAYERS)
    params = LM(cfg).init(torch.Generator().manual_seed(args.seed),
                          device=dev)
    # twice the depth: every stacked leaf's groups repeated
    deep = dict(params, stack=tree_map(lambda _, t: torch.cat([t, t]),
                                       params["stack"]))
    batch = _seq_tokens(torch, dev, cfg, np.random.default_rng(args.seed), 1)

    def kept(policy, layers, p):
        """Bytes a forward keeps for its backward pass; its graph freed."""
        lm = LM(cfg.replace(num_layers=layers, remat_policy=policy))
        leaves = tree_map(lambda _, t: t.detach().requires_grad_(True), p)
        with saved_for_backward(exclude=tree_leaves(leaves)) as rec:
            lm.loss(leaves, batch)
        return rec

    def run(policy):
        lm = LM(cfg.replace(remat_policy=policy))
        leaves = tree_map(lambda _, t: t.detach().requires_grad_(True),
                          params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        with saved_for_backward(exclude=tree_leaves(leaves)) as rec:
            loss, _ = lm.loss(leaves, batch)
        loss.backward()
        e1.record()
        e1.synchronize()
        return {"loss": loss.detach(),
                "grads": [t.grad for t in tree_leaves(leaves)],
                "saved_bytes": rec.nbytes, "cached": len(rec.cached),
                "peak_above_state": torch.cuda.max_memory_allocated() - base,
                "ms": e0.elapsed_time(e1)}

    def traced(policy):
        """The peak of what the same pass allocates, traced on meta."""
        lm = LM(cfg.replace(remat_policy=policy))
        leaves = tree_map(lambda _, t: t.requires_grad_(True), lm.abstract())
        tokens = torch.empty_like(batch["tokens"], device="meta")
        with StepCost() as sc:
            loss, _ = lm.loss(leaves, {"tokens": tokens})
            loss.backward()
        return sc.peak

    run("dots")                                       # warm, not kept
    runs, out = {}, {}
    for policy in REMAT_POLICIES:
        r = runs[policy] = run(policy)
        check(bool(torch.isfinite(r["loss"])), f"{policy}: non-finite loss")
        deeper = kept(policy, 2 * REMAT_A_LAYERS, deep).nbytes
        per_layer = (deeper - r["saved_bytes"]) / REMAT_A_LAYERS
        planned = traced(policy)
        out[policy] = {
            "loss": float(r["loss"]), "ms": r["ms"],
            "peak_above_state": r["peak_above_state"],
            "planned_peak_above_state": planned,
            "saved_bytes": r["saved_bytes"], "cached_outputs": r["cached"],
            "saved_bytes_deeper": deeper, "per_layer_bytes": per_layer,
            "saved_bytes_at_full_depth": r["saved_bytes"] + per_layer
            * (full.num_layers - REMAT_A_LAYERS)}
        if policy != "none":
            ref = runs["none"]
            bitwise = torch.equal(r["loss"], ref["loss"]) and all(
                torch.equal(g, w) for g, w in zip(r["grads"], ref["grads"]))
            worst = max(float((g - w).abs().max()) / float(w.abs().max())
                        for g, w in zip(r["grads"], ref["grads"]))
            out[policy].update(bitwise=bitwise, worst_grad_rel=worst,
                               loss_diff=float(r["loss"] - ref["loss"]))
            check(worst <= REMAT_GRAD_TOL and abs(out[policy]["loss_diff"])
                  <= REMAT_GRAD_TOL * abs(float(ref["loss"])),
                  f"{policy}: gradients {worst:.2e} of a leaf's largest "
                  f"magnitude from none's, the loss "
                  f"{out[policy]['loss_diff']:.2e} (limit "
                  f"{REMAT_GRAD_TOL:g})")
            del r["grads"]
        o = out[policy]
        same = ("" if policy == "none" else
                f"; loss and gradients {'bitwise' if o['bitwise'] else 'not bitwise'}"
                f" equal to none's (worst {o['worst_grad_rel']:.2e} of a "
                f"leaf's largest magnitude)")
        miss = planned / o["peak_above_state"] - 1
        o["planned_miss"] = miss
        log(f"remat: (a) {REMAT_ARCH} {REMAT_A_LAYERS} of {full.num_layers} "
            f"layers, 1 x {REMAT_SEQ}, {policy}: forward + backward "
            f"{o['ms']:.1f} ms; peak {o['peak_above_state'] / 1e9:.3f} GB "
            f"above the params (the dry run on meta {planned / 1e9:.3f} GB, "
            f"{100 * miss:+.2f}%); kept for the backward pass "
            f"{o['saved_bytes'] / 1e9:.4f} GB ({o['cached_outputs']} matmul "
            f"outputs cached), {o['per_layer_bytes'] / 1e6:.2f} MB a layer "
            f"(4-layer forward {deeper / 1e9:.4f} GB), "
            f"{o['saved_bytes_at_full_depth'] / 1e9:.3f} GB at "
            f"{full.num_layers} layers{same}")
    for policy in REMAT_POLICIES:
        o = out[policy]
        check(abs(o["planned_miss"]) <= REMAT_PEAK_TOL,
              f"{policy}: the dry run's peak {o['planned_peak_above_state']} B"
              f" is {100 * o['planned_miss']:+.2f}% of the card's "
              f"{o['peak_above_state']} B (limit {100 * REMAT_PEAK_TOL:g}%)")
    ratio = out["none"]["per_layer_bytes"] / out["dots"]["per_layer_bytes"]
    out["none_over_dots_per_layer"] = ratio
    log(f"remat: (a) per layer, none keeps {ratio:.2f}x the bytes dots "
        f"keeps; full {out['full']['per_layer_bytes'] / 1e6:.2f} MB")
    check(out["full"]["saved_bytes"] < out["dots"]["saved_bytes"]
          < out["none"]["saved_bytes"], "saved bytes do not order full < "
          "dots < none")
    return out


def remat_record() -> tuple:
    """(b)'s dry-run record of the full-depth step on a (1, 1) mesh."""
    return dryrun_record(REMAT_ARCH, "train", REMAT_BATCH, REMAT_SEQ,
                         microbatches=REMAT_MICROBATCHES)


def remat_trainer(torch, dev, args, planned=None) -> dict:
    """(b) and (c): the full-depth trainer under the default policy, the
    dry run's record against the card, then the dump through K2, one
    live step, the restore and the same step from the restored state.
    ``planned``: remat_record()'s result, traced earlier where this
    process was idle; traced here when None."""
    import shutil
    import tempfile

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import (CheckpointSession, CodecPolicy, DumpRequest,
                                 SessionConfig)
    from repro_torch.configs import get_config
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.device_codec import DEVICE_MIN_BYTES
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step)

    cfg = get_config(REMAT_ARCH)
    lm = LM(cfg)
    B, S = REMAT_BATCH, REMAT_SEQ
    rec, record_s = planned or remat_record()
    plan_bytes = rec["bytes_per_device"]["params"] + \
        rec["bytes_per_device"]["opt_state"]
    plan_flops = rec["totals_per_device"]["step_flops"]
    mem, cost = rec["memory_analysis_per_device"], \
        rec["cost_analysis_per_device"]
    out = {"record_s": record_s, "plan_state_bytes": plan_bytes,
           "plan_step_flops": plan_flops, "remat": rec["options"]["remat"],
           "microbatches": REMAT_MICROBATCHES, "memory_analysis": mem,
           "cost_analysis": cost}
    log(f"remat: (b) the dry run's record (1, 1): memory_analysis "
        f"{dryrun.memory_line(mem)}; {cost['flops']:,} FLOPs and "
        f"{cost['bytes accessed']:,} bytes accessed a step (one trace, "
        f"{cost['trace_s']:.1f} s on meta)")
    check(out["remat"] == "dots", f"the record's policy {out['remat']}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                             device=dev)
    real = sum(t.numel() * t.element_size() for t in _leaves(state))
    out["state_bytes"] = real
    log(f"remat: (b) {REMAT_ARCH} at full depth ({cfg.num_layers} layers, "
        f"{lm.n_params():,} params), {B} x {S}, remat_policy "
        f"{cfg.remat_policy}, microbatches {REMAT_MICROBATCHES}: the dry "
        f"run's record (1, 1) params + optimizer state {plan_bytes:,} B, "
        f"the train state on the card {real:,} B")
    check(real == plan_bytes, f"train state {real} B on the card, the dry "
          f"run planned {plan_bytes} B")
    rng = np.random.default_rng(args.seed)
    step = make_train_step(lm, OptConfig(), microbatches=REMAT_MICROBATCHES)
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, _seq_tokens(torch, dev, cfg, rng, B))
    counted = int(fc.get_total_flops())
    check(np.isfinite(float(m["loss"])), "non-finite loss")
    out["step_flops"] = counted
    log(f"remat: (b) the first step on the card counts {counted:,} FLOPs "
        f"(FlopCounterMode, the recompute included), the dry run "
        f"{plan_flops:,}")
    check(counted == plan_flops, f"the card's step counts {counted} FLOPs, "
          f"the dry run {plan_flops}")
    times, losses = [], [float(m["loss"])]
    for _ in range(REMAT_STEPS):
        b = _seq_tokens(torch, dev, cfg, rng, B)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, b)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    planned = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    miss = planned / (peak - base) - 1
    bounds = {"bytes": cost["bytes accessed"] / HBM_BYTES_PER_S,
              "flops": cost["flops"] / BF16_OPS_PER_S}
    out.update(losses=losses, step_s=times, step_s_median=med,
               tflops=counted / med / 1e12,
               peak_share=counted / med / BF16_OPS_PER_S,
               peak_device_gb=peak / 1e9, base_device_bytes=base,
               peak_above_state_gb=(peak - base - real) / 1e9,
               planned_peak_bytes=planned, planned_miss=miss,
               bound_s=bounds, bound_share=max(bounds.values()) / med)
    card = smi_line()
    log(f"remat: (b) {card}: peak device memory {peak / 1e9:.2f} GB "
        f"({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB "
        f"allocated before the state; the state {real / 1e9:.2f} GB, "
        f"{out['peak_above_state_gb']:.2f} GB above it); the dry run's "
        f"argument + temp {planned / 1e9:.3f} GB ({100 * miss:+.2f}%); "
        f"losses {losses}")
    log(f"dryrun: {card}: {REMAT_ARCH} {cfg.num_layers}-layer train step "
        f"{B} x {S} under remat dots median {med:.4f} s over {REMAT_STEPS} "
        f"steps (CUDA events; {', '.join(f'{t:.4f}' for t in times)}): "
        f"{out['tflops']:.1f} TFLOP/s counted, "
        f"{100 * out['peak_share']:.1f}% of the dense bf16 peak "
        f"({BF16_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    log(f"dryrun: {card}: the record's bounds for that step: bytes "
        f"{cost['bytes accessed']:,} / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bounds['bytes']:.4f} s, FLOPs {cost['flops']:,} / "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s = {bounds['flops']:.4f} s; the "
        f"larger is {100 * out['bound_share']:.1f}% of the median step")
    check(mem["alias_size_in_bytes"] == real,
          f"the dry run's alias {mem['alias_size_in_bytes']} B, the state "
          f"on the card {real} B")
    check(abs(miss) <= REMAT_PEAK_TOL,
          f"the dry run's argument + temp {planned} B is {100 * miss:+.2f}% "
          f"of the card's peak {peak - base} B above what was allocated "
          f"before the state (limit {100 * REMAT_PEAK_TOL:g}%)")
    check(all(b <= med for b in bounds.values()),
          f"a bound of the step {bounds} exceeds its median {med:.4f} s")

    # (c)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-remat-", dir=args.lifecycle_dir)
    try:
        with RssPeak() as rss:
            codec = CodecPolicy(optimizer="bf16", device="auto")
            sess = CheckpointSession(SessionConfig(
                root="file://" + os.path.join(tmp, "ck"), codec=codec),
                device=dev)
            moments = [t for p, t in flatten_with_paths(state)
                       if p.startswith("opt/")
                       and t.numel() * t.element_size() >= DEVICE_MIN_BYTES]
            at = int(state["step"])
            torch.cuda.synchronize()
            k6_before = dict(k6.LAUNCHES)
            ckpt_codec.reset_launches()    # the path's counts start here
            t0 = time.time()
            receipt = sess.dump(DumpRequest(state=state, step=at))
            out["dump_s"] = time.time() - t0
            launches = dict(ckpt_codec.LAUNCHES)
            st = receipt.stats
            out.update(image_bytes=st["bytes_stored"], launches=launches,
                       leaves_device=st["leaves_device"])
            log(f"remat: (c) image {receipt.image_id} (params lossless, "
                f"moments bf16) in {out['dump_s']:.1f} s: "
                f"{st['bytes_stored'] / 1e9:.2f} GB stored, "
                f"{st['leaves_device']} leaves through the device stage")
            log("kernels: remat-path launches " + " ".join(
                f"{k}={v}" for k, v in launches.items()))
            check(launches["bf16_encode_digest"] == len(moments)
                  == st["leaves_device"],
                  f"K2 launched {launches['bf16_encode_digest']} times, "
                  f"{st['leaves_device']} leaves went through the device "
                  f"stage, {len(moments)} moment leaves are eligible")
            check(all(v == 0 for k, v in launches.items()
                      if k != "bf16_encode_digest"),
                  f"a kernel other than K2 ran in the dump: {launches}")
            b = _seq_tokens(torch, dev, cfg, rng, B)
            state, m = step(state, b)
            live = m["loss"].detach().clone()
            del state, m, moments
            free_host_and_card(torch)
            out["rss_before_restore_gb"] = rss.rss_gb()
            t0 = time.time()
            tree, man = sess.load(receipt.image_id,
                                  target_struct=abstract_train_state(lm))
            torch.cuda.synchronize()
            out["restore_s"] = time.time() - t0
            digests = sum(1 for r in man["leaves"]
                          if "digest" in r["codec_meta"])
            on_card = all(t.device == dev for t in _leaves(tree))
            log(f"remat: (c) restore onto the card in "
                f"{out['restore_s']:.1f} s (host RSS "
                f"{out['rss_before_restore_gb']:.1f} GB before it); "
                f"{digests} payload digests re-derived from the stored "
                f"bytes and verified")
            check(on_card and int(tree["step"]) == at,
                  "the restored state is not the step's on the card")
            check(digests == launches["bf16_encode_digest"],
                  f"{digests} payload digests, {launches['bf16_encode_digest']}"
                  f" K2 launches")
            tree, m = step(tree, b)
            again = m["loss"].detach()
            out.update(live_loss=float(live), restored_loss=float(again),
                       loss_bitwise=bool(torch.equal(live, again)))
            log(f"remat: (c) step {at + 1}: live loss {float(live)!r}, from "
                f"the restored state {float(again)!r}")
            check(out["loss_bitwise"], "the restored state's loss differs "
                  "from the live state's")
            check(dict(ckpt_codec.LAUNCHES) == launches
                  and dict(k6.LAUNCHES) == k6_before,
                  "a kernel launched in the restore or a train step")
            del tree, m
            gc.collect()
            torch.cuda.empty_cache()
        out["host_peak_rss_gb"] = rss.peak_gb
        log(f"remat: (c) host peak RSS {rss.peak_gb:.1f} GB (sampled every "
            f"20 ms; {rss.start_gb:.1f} GB at its start)")
        check(rss.peak_gb < REMAT_HOST_GB, f"host peak {rss.peak_gb:.1f} GB, "
              f"over {REMAT_HOST_GB} GB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def remat_path(torch, dev, args, planned=None) -> dict:
    """Path 17: (a), then (b) and (c) on a freed card; ``planned`` as
    remat_trainer takes it."""
    out = {}
    t0 = time.time()
    out["policies"] = remat_policies(torch, dev, args)
    out["policies_s"] = time.time() - t0
    free_host_and_card(torch)
    t1 = time.time()
    out["trainer"] = remat_trainer(torch, dev, args, planned)
    out["trainer_s"] = time.time() - t1
    out["launches"] = out["trainer"]["launches"]
    out["wall_s"] = time.time() - t0
    log(f"remat: path {out['wall_s']:.1f} s ((a) {out['policies_s']:.1f} s, "
        f"(b) + (c) {out['trainer_s']:.1f} s)")
    return out


# ------------------------------------------------------- the mesh path
SPMD_ARCH = "qwen3-8b"
SPMD_MESH = (16, 16)               # the single-pod production mesh
SPMD_TRAIN_LAYERS = 2              # of 36: the path's 60 s (not memory)
SPMD_PREFILL_LAYERS = 4            # of 36: likewise
SPMD_STEPS = 2                     # timed after the counted step
SPMD_PEAK_TOL = 0.05               # the record's peak vs the card's
SPMD_XLSTM = "xlstm-350m"          # (c): its heads (4) fewer than model's
SPMD_XLSTM_TRAIN_LAYERS = 4        # of 24: one (m, m, m, s) group
# (c)'s train cell: train_4k's 256 rows, its sequence cut to 512 for the
# script's time (the sLSTM scan is 4096 steps of small launches a
# microbatch: at 4096 the step takes 114 s, 350 s under StepCost, on the
# H100; scripts/torch_xlstm_train_card.py runs it whole)
SPMD_XLSTM_TRAIN_SEQ = 512
SPMD_DUMP_SLACK = 1 << 30          # (d): peak <= 2 x largest leaf + this
# (e): the leaves changed on rank 0's shards between the pre-dump round
# and the residual dump (the attention's q projection and its moments)
SPMD_DIRTY = ("opt/m/stack/b0/attn/wq", "opt/v/stack/b0/attn/wq",
              "params/stack/b0/attn/wq")


def spmd_records() -> tuple:
    """Path 18's dry-run records (CPU only, on meta): rank 0's program on
    the (16, 16) mesh under a fake group of 256: qwen3-8b train_4k (dots,
    the default microbatches) with and without --cast-once at
    SPMD_TRAIN_LAYERS and prefill_32k at SPMD_PREFILL_LAYERS; xlstm-350m
    train (train_4k's rows and 4 microbatches, the sequence cut to
    SPMD_XLSTM_TRAIN_SEQ) at SPMD_XLSTM_TRAIN_LAYERS, decode_32k and
    long_500k at full depth -> ({name: record}, seconds)."""
    from repro_torch.launch import dryrun
    t0 = time.time()
    recs = {}
    for name, arch, shape, layers, kw in (
            ("train", SPMD_ARCH, "train_4k", SPMD_TRAIN_LAYERS, {}),
            ("train_cast_once", SPMD_ARCH, "train_4k", SPMD_TRAIN_LAYERS,
             {"cast_once": True}),
            ("prefill", SPMD_ARCH, "prefill_32k", SPMD_PREFILL_LAYERS, {}),
            ("xlstm_train", SPMD_XLSTM,
             _spmd_shape(f"train_{SPMD_XLSTM_TRAIN_SEQ}"),
             SPMD_XLSTM_TRAIN_LAYERS, {}),
            ("xlstm_decode", SPMD_XLSTM, "decode_32k", None, {}),
            ("xlstm_long", SPMD_XLSTM, "long_500k", None, {})):
        recs[name] = dryrun.run_cell(
            arch, shape, num_layers=layers, verbose=False,
            microbatches=dryrun.default_microbatches(
                arch, "train_4k" if name == "xlstm_train" else shape), **kw)
    return recs, time.time() - t0


def _spmd_shape(name):
    """A record's shape: a SHAPES name, or (c)'s cut train cell."""
    from repro_torch.configs.base import SHAPES, ShapeConfig
    if name in SHAPES:
        return SHAPES[name]
    full = SHAPES["train_4k"]
    return ShapeConfig(name, "train", SPMD_XLSTM_TRAIN_SEQ,
                       full.global_batch)


def _card_trees(torch, cell, dev, gen) -> dict:
    """The cell's argument trees on the card as rank 0 of the mesh holds
    them: DTensors whose local shards alone are allocated (weights drawn
    at 0.02, optimizer moments and the step zero, token ids uniform)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import tree_map
    mesh = cell.mesh
    dm = shd.device_mesh(mesh)
    vocab = cell.cfg.vocab_size

    def group(name):
        tree, specs = cell.trees[name]

        def leaf(path, t):
            if path == "pos":
                return t             # decode's cursor: a host scalar
            spec = specs
            for k in path.split("/"):
                spec = spec[k]
            shape = shd.NamedSharding(mesh, spec).shard_shape(tuple(t.shape))
            if not t.is_floating_point():
                local = torch.randint(0, vocab, shape, generator=gen,
                                      device=dev, dtype=t.dtype) \
                    if name == "inputs" else \
                    torch.zeros(shape, dtype=t.dtype, device=dev)
            elif name == "params":
                local = (torch.randn(shape, generator=gen, device=dev)
                         * 0.02).to(t.dtype)
            else:
                local = torch.zeros(shape, dtype=t.dtype, device=dev)
            return DTensor.from_local(local, dm, shd.placements(spec, mesh),
                                      shape=t.shape, stride=t.stride())
        return tree_map(leaf, tree)
    return {name: group(name) for name in cell.trees
            if not (name == "cache" and cell.shape.kind == "prefill")}


def _spmd_cell(torch, dev, args, mesh, rec, name, after=None) -> dict:
    """One record against rank 0's step on the card: the step once under
    StepCost (its FLOPs equal to the record's, and a train record's
    totals equal to both), then SPMD_STEPS timed under CUDA events
    (qwen3-8b's train); the device peak above what was allocated before
    the state (train) or the step (prefill, decode) within SPMD_PEAK_TOL
    of the record's argument + temp (train) or temp. ``after(cell,
    trees)`` runs on the state the steps leave, before it is freed."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.launch import dryrun
    from repro_torch.launch.stepcost import StepCost
    opts, arch = rec["options"], rec["arch"]
    depth = configs.get_config(arch).num_layers
    cell = dryrun.lower_cell(arch, _spmd_shape(rec["shape"]), mesh,
                             num_layers=opts["num_layers"],
                             microbatches=opts["microbatches"],
                             cast_once=opts["cast_once"])
    kind = cell.shape.kind
    mem, cost = rec["memory_analysis_per_device"], \
        rec["cost_analysis_per_device"]
    check(mem["temp_size_in_bytes"] is not None,
          f"path 18 {name}: the record has no per-device program: "
          f"{mem.get('null_reason')}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    trees = _card_trees(torch, cell, dev, gen)
    if kind != "train":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wgmma = k6.ROUTE_LAUNCHES["wgmma"]
    t0 = time.time()
    with StepCost() as sc:
        out = cell.run(trees)
    torch.cuda.synchronize()
    counted_s = time.time() - t0
    k6_launches = k6.ROUTE_LAUNCHES["wgmma"] - wgmma
    times = []
    if kind == "train" and arch == SPMD_ARCH:
        trees["params"], trees["opt_state"] = out[0]["params"], {
            "opt": out[0]["opt"], "step": out[0]["step"]}
        for _ in range(SPMD_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = cell.run(trees)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
            trees["params"], trees["opt_state"] = out[0]["params"], {
                "opt": out[0]["opt"], "step": out[0]["step"]}
    peak = torch.cuda.max_memory_allocated() - base
    planned = mem["temp_size_in_bytes"] + \
        (mem["argument_size_in_bytes"] if kind == "train" else 0)
    miss = planned / peak - 1
    res = {"arch": arch, "options": opts, "flops": sc.flops,
           "plan_flops": cost["flops"], "peak_bytes": peak,
           "planned_bytes": planned, "miss": miss, "step_s": times,
           "counted_step_s": counted_s, "k6_wgmma": k6_launches,
           "collectives": rec["collectives_per_device"]["total"],
           "memory_analysis": mem}
    what = "argument + temp" if kind == "train" else "temp"
    log(f"spmd: {name}: {arch} {cell.shape.name} at {cell.cfg.num_layers}"
        f" of {depth} layers, rank 0 of {SPMD_MESH[0]}x{SPMD_MESH[1]} (a "
        f"fake group of {SPMD_MESH[0] * SPMD_MESH[1]}), microbatches "
        f"{cell.microbatches}, cast_once {opts['cast_once']}: the record's "
        f"{what} {planned:,} B, the card's peak {peak:,} B "
        f"({100 * miss:+.2f}%); {sc.flops:,} FLOPs counted on the card, "
        f"the record {cost['flops']:,}; the record's collectives "
        f"{res['collectives']['count']} ({res['collectives']['operand_bytes']:,}"
        f" B operand); the counted step {counted_s:.2f} s under StepCost "
        f"({smi_line()})")
    check(sc.flops == cost["flops"], f"path 18 {name}: the card counts "
          f"{sc.flops} FLOPs, the record {cost['flops']}")
    check(abs(miss) <= SPMD_PEAK_TOL,
          f"path 18 {name}: the record's {what} {planned} B is "
          f"{100 * miss:+.2f}% of the card's peak {peak} B (limit "
          f"{100 * SPMD_PEAK_TOL:g}%)")
    if kind == "train":
        # the L1/L2 traces run the cell's microbatches, so the record's
        # totals describe the step it traced whole
        tot = rec["totals_per_device"]["flops"]
        res["totals_flops"] = tot
        log(f"spmd: {name}: totals_per_device flops {tot:,.0f} = "
            f"cost_analysis_per_device {cost['flops']:,} = the card's "
            f"{sc.flops:,}")
        check(tot == cost["flops"] == sc.flops,
              f"path 18 {name}: the record's totals {tot} FLOPs, its "
              f"whole-step trace {cost['flops']}, the card {sc.flops}")
    if times:
        med = statistics.median(times)
        res["step_s_median"] = med
        log(f"spmd: {name}: {smi_line()}: the compute-only time of one of "
            f"{SPMD_MESH[0] * SPMD_MESH[1]} cards (no communication: the "
            f"fake group's collectives move nothing) median {med:.4f} s over "
            f"{SPMD_STEPS} steps ({', '.join(f'{t:.4f}' for t in times)}); "
            f"{sc.flops / med / 1e12:.1f} TFLOP/s counted")
    elif kind == "prefill":
        log(f"spmd: {name}: K6 launched {k6_launches} times on wgmma through "
            f"its sharding rule ({cell.cfg.num_layers} layers)")
        check(k6_launches == cell.cfg.num_layers,
              f"path 18 {name}: K6 launched {k6_launches} times on wgmma, "
              f"{cell.cfg.num_layers} layers")
    del out
    if after is not None:
        res.update(after(cell, trees))
    del trees
    return res


def _spmd_dump(torch, dev, args, cell, trees) -> dict:
    """(d): F9 on the card. (a)'s state (rank 0's shards of the train
    state) dumped through CheckpointSession under
    CodecPolicy(optimizer="bf16", device="auto") to file:// in a
    temporary directory, removed afterwards: every leaf gathered to rank 0
    alone, one at a time (the fake group moves no data, so the values are
    not compared: the CPU tests hold the image bitwise), K2 encoding each
    moment leaf on the card. Checks rank 0's device peak above the state
    against 2 x the largest leaf's unsharded bytes + SPMD_DUMP_SLACK and
    K2's launches against the moment leaves; prints the dump's seconds,
    its leaves, the unsharded bytes and the child's host RSS peak during
    the dump (RssPeak: the child's own, which ru_maxrss is not, inherited
    from the parent across fork and exec)."""
    import shutil
    import tempfile
    from repro_torch.api import (CheckpointSession, CodecPolicy, DumpRequest,
                                 SessionConfig)
    from repro_torch.core import flatten_with_paths
    from repro_torch.core.device_codec import DEVICE_MIN_BYTES
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    state = {"params": trees["params"], **trees["opt_state"]}
    leaves = [(p, t.numel() * t.element_size())
              for p, t in flatten_with_paths(state)]
    unsharded = sum(n for _, n in leaves)
    largest = max(n for _, n in leaves)
    limit = 2 * largest + SPMD_DUMP_SLACK
    moments = [p for p, n in leaves
               if p.startswith("opt/") and n >= DEVICE_MIN_BYTES]
    root = tempfile.mkdtemp(prefix="chip-smoke-f9-", dir=args.lifecycle_dir)
    try:
        free = shutil.disk_usage(root).free
        check(free > 1.2 * unsharded, f"path 18 (d): {free / 1e9:.1f} GB "
              f"free under {root}, the image may take {unsharded / 1e9:.1f}")
        sess = CheckpointSession(SessionConfig(
            root=f"file://{root}", codec=CodecPolicy(optimizer="bf16",
                                                     device="auto")),
            device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ckpt_codec.reset_launches()    # (d)'s counts start here
        t0 = time.time()
        with RssPeak() as rss:
            receipt = sess.dump(DumpRequest(state=state, step=1))
            torch.cuda.synchronize()
        dump_s = time.time() - t0
        launches = dict(ckpt_codec.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        shutil.rmtree(root, ignore_errors=True)
    st = receipt.stats
    out = {"dump_s": dump_s, "dump_leaves": len(leaves),
           "dump_unsharded_bytes": unsharded, "dump_largest_leaf": largest,
           "dump_peak_bytes": peak, "dump_limit_bytes": limit,
           "dump_stored_bytes": st["bytes_stored"],
           "dump_launches": launches, "host_peak_rss_gb": rss.peak_gb,
           "host_rss_at_dump_gb": rss.start_gb}
    log(f"spmd: (d) {smi_line()}: the sharded dump of (a)'s state "
        f"({len(leaves)} leaves, {unsharded / 1e9:.2f} GB unsharded, the "
        f"largest {largest / 1e9:.2f} GB), rank 0 of the fake "
        f"{SPMD_MESH[0] * SPMD_MESH[1]}, in {dump_s:.1f} s: "
        f"{st['bytes_stored'] / 1e9:.2f} GB stored, {st['leaves_device']} "
        f"leaves through the device stage (K2 {launches['bf16_encode_digest']}"
        f"); rank 0's device peak above the state {peak / 1e9:.3f} GB "
        f"(limit {limit / 1e9:.3f} GB: 2 x the largest leaf + 1 GiB); the "
        f"child's host RSS {rss.start_gb:.1f} GB at the dump's start, its "
        f"peak {rss.peak_gb:.1f} GB during it (sampled every 20 ms)")
    check(peak <= limit, f"path 18 (d): rank 0's device peak {peak} B "
          f"passed {limit} B: the dump held more than one gathered leaf")
    check(launches["bf16_encode_digest"] == len(moments)
          == st["leaves_device"],
          f"path 18 (d): K2 launched {launches['bf16_encode_digest']} times, "
          f"{st['leaves_device']} leaves went through the device stage, "
          f"{len(moments)} moment leaves are eligible")
    check(all(v == 0 for k, v in launches.items()
              if k != "bf16_encode_digest"),
          f"path 18 (d): a kernel other than K2 ran in the dump: {launches}")
    return out


class _Gathers:
    """Counts ``sharding.gather_leaf``'s calls in a block."""

    def __enter__(self):
        from repro_torch.distributed import sharding as shd
        self.n, self._orig = 0, shd.gather_leaf

        def counted(t):
            self.n += 1
            return self._orig(t)
        shd.gather_leaf = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding as shd
        shd.gather_leaf = self._orig


def _spmd_modes(torch, dev, args, trees, sync_s) -> dict:
    """(e): item 16, F12 and F13 on the card, on (a)'s state after (d):
    every mode of a sharded state through CheckpointSession, rank 0 of
    the fake group. (1) Under (d)'s CodecPolicy(optimizer="bf16",
    device="auto"): a pre-dump round, the leaves SPMD_DIRTY changed in
    place on rank 0's shards, the residual dump: K5 once a pass over rank
    0's local shards, the residual gathering SPMD_DIRTY alone, K2 on the
    moments each dump writes. (2) A lossless migrate: its digest pass's
    seconds (every leaf gathered to rank 0 and hashed there, before the
    dump's own gathers). (3) An async dump: its capture (the freeze,
    every leaf gathered and copied to rank 0's host) beside (d)'s sync
    seconds, then wait(), the child's host RSS peak; it starts only once
    path 11 has ended (``--fleet-done``), as the capture puts the state
    on this host. Each dump's rank-0 device peak at most 2 x the largest
    leaf + SPMD_DUMP_SLACK; each image in a temporary directory, removed
    after it. The fake group moves no data, so the digests every rank
    agrees on are rank 0's own (its all_gather_object hands each rank
    rank 0's part) and no value is compared: the CPU tests
    (tests/test_torch_spmd_modes.py) hold the images bitwise."""
    import shutil
    import tempfile
    from repro_torch.api import (CheckpointSession, CodecPolicy, DumpRequest,
                                 MigrateRequest, SessionConfig)
    from repro_torch.core import flatten_with_paths
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    state = {"params": trees["params"], **trees["opt_state"]}
    pairs = dict(flatten_with_paths(state))
    sizes = [t.numel() * t.element_size() for t in pairs.values()]
    unsharded, largest = sum(sizes), max(sizes)
    limit = 2 * largest + SPMD_DUMP_SLACK
    out, peaks = {}, {}

    def dump(codec, fn):
        """``fn(session)`` on a session over a fresh file:// root, removed
        after it."""
        root = tempfile.mkdtemp(prefix="chip-smoke-modes-",
                                dir=args.lifecycle_dir)
        try:
            free = shutil.disk_usage(root).free
            check(free > 1.2 * unsharded, f"path 18 (e): {free / 1e9:.1f} "
                  f"GB free under {root}, the image may take "
                  f"{unsharded / 1e9:.1f}")
            sess = CheckpointSession(SessionConfig(
                root=f"file://{root}", codec=codec), device=dev)
            return fn(sess)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def measured(label, call):
        """``call()``, its seconds, gathers, K launches, rank 0's device
        peak and the host RSS peak kept under ``label``."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ckpt_codec.reset_launches()
        t0 = time.time()
        with RssPeak() as rss, _Gathers() as g:
            res = call()
            torch.cuda.synchronize()
        s = time.time() - t0
        peaks[label] = torch.cuda.max_memory_allocated() - base
        out[label] = {"s": s, "gathers": g.n,
                      "launches": dict(ckpt_codec.LAUNCHES),
                      "peak_bytes": peaks[label],
                      "host_peak_rss_gb": rss.peak_gb,
                      "host_rss_start_gb": rss.start_gb}
        return res

    def rounds(sess):
        r = measured("round", lambda: sess.dump(DumpRequest(
            state=state, step=2, mode="pre_dump")))
        for p in SPMD_DIRTY:
            pairs[p].to_local().add_(1.0)
        res = measured("residual", lambda: sess.dump(DumpRequest(
            state=state, step=3)))
        return r.stats, res.stats
    bf16 = CodecPolicy(optimizer="bf16", device="auto")
    rst, rest = dump(bf16, rounds)
    dirty_moments = [p for p in SPMD_DIRTY if p.startswith("opt/")]
    k5 = [out[k]["launches"]["digest_blocks"] for k in ("round", "residual")]
    log(f"spmd: (e) {smi_line()}: a pre-dump round of (a)'s state "
        f"{out['round']['s']:.1f} s ({rst['leaves_dirty']} dirty, "
        f"{out['round']['gathers']} gathered, K5 {k5[0]}, K2 "
        f"{out['round']['launches']['bf16_encode_digest']}); "
        f"{len(SPMD_DIRTY)} leaves changed on rank 0's shards, the residual "
        f"dump {out['residual']['s']:.2f} s ({rest['leaves_reused']} "
        f"re-emitted, {out['residual']['gathers']} gathered, K5 {k5[1]}, "
        f"K2 {out['residual']['launches']['bf16_encode_digest']}); the "
        f"digests every rank agrees on are rank 0's own under the fake "
        f"group")
    check(k5 == [1, 1], f"path 18 (e): K5 launched {k5} times in the round "
          f"and the residual, once a pass expected")
    check(out["round"]["gathers"] == len(pairs)
          and rst["leaves_dirty"] == len(pairs),
          f"path 18 (e): the first round gathered "
          f"{out['round']['gathers']} of {len(pairs)} leaves")
    check(out["residual"]["gathers"] == len(SPMD_DIRTY)
          and rest["leaves_reused"] == len(pairs) - len(SPMD_DIRTY),
          f"path 18 (e): the residual gathered {out['residual']['gathers']}"
          f" leaves and re-emitted {rest['leaves_reused']}; "
          f"{len(SPMD_DIRTY)} were changed")
    check(out["residual"]["launches"]["bf16_encode_digest"]
          == len(dirty_moments),
          f"path 18 (e): K2 launched "
          f"{out['residual']['launches']['bf16_encode_digest']} times in "
          f"the residual, {len(dirty_moments)} moments dirty")
    # the classification pass alone, and K5 over rank 0's local shards
    # (these launches come after the counts above and are not counted)
    from repro_torch.core.predump import digest_pairs
    from repro_torch.kernels.ckpt_codec import ops
    torch.cuda.synchronize()
    t0 = time.time()
    digest_pairs(list(pairs.items()))
    pass_s = time.time() - t0
    shards = [t.to_local() for t in pairs.values() if t.is_floating_point()]
    nbytes = sum(t.numel() * t.element_size() for t in shards)
    k5 = {"ms": cuda_ms(torch, lambda: ops.classifier_lanes_many(shards),
                        iters=20),
          "back_to_back_ms": cuda_ms(
              torch, lambda: ops.classifier_lanes_many(shards), iters=10,
              batch=10),
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
          "leaves": len(shards), "pass_s": pass_s}
    out["k5_shards"] = k5
    log(f"spmd: (e) {smi_line()}: the classification pass {pass_s:.3f} s "
        f"(K5, the lanes to the host, their hashes, all_gather_object); K5 "
        f"over rank 0's {len(shards)} local shards ({nbytes / 1e6:.1f} MB) "
        f"{k5['ms']:.4f} ms one call, {k5['back_to_back_ms']:.4f} ms back "
        f"to back, bound {k5['bound_ms']:.4f} ms by bytes")

    def migrate(sess):
        t = measured("migrate", lambda: sess.migrate(MigrateRequest(
            state=state, step=4, reason="chip_smoke")))
        out["migrate"]["digest_s"] = sess._orchestrator().digest_s
        return t
    ticket = dump(CodecPolicy(), migrate)
    check(ticket.exit_code == 85 and ticket.record.state_digest,
          f"path 18 (e): the lossless migrate gave exit "
          f"{ticket.exit_code}, digest {ticket.record.state_digest}")
    log(f"spmd: (e) {smi_line()}: a lossless migrate of (a)'s state "
        f"{out['migrate']['s']:.1f} s, of it the digest pass "
        f"{out['migrate']['digest_s']:.1f} s ({len(pairs)} leaves gathered "
        f"to rank 0 and hashed there before the dump's "
        f"{out['migrate']['gathers'] - len(pairs)} gathers), exit "
        f"{ticket.exit_code}")

    waited = 0.0
    if args.fleet_done:
        t0 = time.time()
        while not os.path.exists(args.fleet_done):
            check(time.time() - t0 < SPMD_CHILD_TIMEOUT_S,
                  "path 18 (e): path 11 did not end")
            time.sleep(0.5)
        waited = time.time() - t0

    def async_dump(sess):
        measured("async", lambda: sess.dump(DumpRequest(
            state=state, step=5, mode="async")))
        return measured("async_wait", sess.wait)
    receipts = dump(bf16, async_dump)
    check(len(receipts) == 1 and receipts[0].committed,
          f"path 18 (e): the async dump's wait() gave {receipts}")
    a = out["async"]
    log(f"spmd: (e) {smi_line()}: an async dump of (a)'s state after "
        f"waiting {waited:.1f} s for path 11's end: its capture (the "
        f"freeze) {a['s']:.2f} s ({a['gathers']} leaves gathered and "
        f"copied to rank 0's host) against (d)'s sync dump {sync_s:.1f} s; "
        f"wait() {out['async_wait']['s']:.1f} s more; the child's host RSS "
        f"{a['host_rss_start_gb']:.1f} GB at the capture's start, its peak "
        f"{max(a['host_peak_rss_gb'], out['async_wait']['host_peak_rss_gb'], a['host_rss_start_gb']):.1f}"
        f" GB (sampled every 20 ms)")
    check(a["gathers"] == len(pairs), f"path 18 (e): the async capture "
          f"gathered {a['gathers']} of {len(pairs)} leaves")
    log(f"spmd: (e): rank 0's device peak above the state by dump: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in peaks.items())
        + f" (limit {limit / 1e9:.3f} GB: 2 x the largest leaf + 1 GiB)")
    for k, v in peaks.items():
        check(v <= limit, f"path 18 (e): rank 0's device peak in {k} {v} B "
              f"passed {limit} B")
    out["launches"] = {k: sum(out[m]["launches"][k] for m in peaks)
                       for k in ckpt_codec.KERNELS}
    out["async_waited_s"] = waited
    return {"modes": out}


def _spmd_after(torch, dev, args, cell, trees) -> dict:
    """(d), then (e) on the same state."""
    out = _spmd_dump(torch, dev, args, cell, trees)
    out.update(_spmd_modes(torch, dev, args, trees, out["dump_s"]))
    return out


def spmd_path(torch, dev, args, planned=None) -> dict:
    """Path 18: rank 0's per-device program of production cells
    (qwen3-8b's and xlstm-350m's) on the card, under a fake group of 256
    on the (16, 16) mesh at full width, against the dry run's records of
    the same program on meta, and the sharded dump of (a)'s state (d).
    The fake group's collectives move no data and leave their outputs as
    allocated, so the path reads shapes, memory, FLOPs and time, never a
    loss. ``planned``: spmd_records()'s result, traced in a process of
    their own; traced here when None."""
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    recs, record_s = planned or spmd_records()
    t0 = time.time()
    out = {"record_s": record_s}
    with fake_group(SPMD_MESH[0] * SPMD_MESH[1]):
        mesh = make_test_mesh(SPMD_MESH, device=dev)
        for name, rec in recs.items():
            after = (lambda cell, trees: _spmd_after(torch, dev, args, cell,
                                                     trees)) \
                if name == "train" else None
            t1 = time.time()
            out[name] = _spmd_cell(torch, dev, args, mesh, rec, name, after)
            out[name]["wall_s"] = time.time() - t1
            free_host_and_card(torch)
    plain, cast = (out[k]["collectives"]["operand_bytes"]
                   for k in ("train", "train_cast_once"))
    xl = ("xlstm_train", "xlstm_decode", "xlstm_long")
    log(f"spmd: cast-once moves {cast:,} B of collective operands a step, "
        f"without {plain:,} B; records traced in {record_s:.1f} s on meta, "
        f"the card's part {time.time() - t0:.1f} s, of it (c) "
        f"{sum(out[k]['wall_s'] for k in xl):.1f} s and (d)'s dump "
        f"{out['train']['dump_s']:.1f} s ({smi_line()})")
    check(cast < plain, "cast-once did not cut the collectives' bytes")
    modes = out["train"]["modes"]["launches"]
    out["launches"] = {"flash_attention": out["prefill"]["k6_wgmma"], **{
        k: n + modes[k] for k, n in out["train"]["dump_launches"].items()}}
    out["wall_s"] = time.time() - t0
    return out


SPMD_CHILD_TIMEOUT_S = 600


def start_spmd_records(args) -> dict:
    """Path 18's records (spmd_records) traced on meta in a process of
    their own (``--spmd-records``), started with the script: a few minutes
    of one host core beside everything before path 11, none of this
    process's interpreter. Killed at exit if still running."""
    import atexit
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-spmd-rec-",
                           dir=args.lifecycle_dir)
    out = os.path.join(tmp, "records.json")
    logf = open(os.path.join(tmp, "records.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--spmd-records", out],
        stdout=logf, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "log": logf, "tmp": tmp, "out": out,
            "t0": time.time()}


def finish_spmd_records(rp) -> tuple:
    """Wait for the records' process (at most SPMD_CHILD_TIMEOUT_S more),
    fail unless it exited 0 -> (records, seconds it traced, seconds this
    process waited for it)."""
    import shutil
    t0 = time.time()
    proc = rp["proc"]
    try:
        proc.wait(timeout=SPMD_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    rp["log"].seek(0)
    lines = rp["log"].read().splitlines()
    rp["log"].close()
    try:
        check(proc.returncode == 0, f"path 18's records exited "
              f"{proc.returncode}:\n" + "\n".join(lines[-40:]))
        with open(rp["out"]) as f:
            given = json.load(f)
    finally:
        shutil.rmtree(rp["tmp"], ignore_errors=True)
    return given["records"], given["record_s"], time.time() - t0


def start_spmd_child(planned, args) -> dict:
    """Path 18 in a child process (``--spmd-child``), started beside path
    11: its own CUDA context, so the device peak it checks is its own,
    and a process of its own, so its host-bound DTensor dispatch takes
    none of this process's interpreter. ``planned``: spmd_records()'s
    result, handed over as JSON."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-spmd-", dir=args.lifecycle_dir)
    recs = os.path.join(tmp, "records.json")
    with open(recs, "w") as f:
        json.dump({"records": planned[0], "record_s": planned[1]}, f)
    logf = open(os.path.join(tmp, "child.log"), "w+")
    done = os.path.join(tmp, "fleet_done")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--spmd-child", recs,
         "--out", os.path.join(tmp, "out.json"), "--seed", str(args.seed),
         "--fleet-done", done] + (["--lifecycle-dir", args.lifecycle_dir]
                                  if args.lifecycle_dir else []),
        stdout=logf, stderr=subprocess.STDOUT)
    import atexit
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "log": logf, "tmp": tmp, "t0": time.time(),
            "fleet_done": done}


def finish_spmd_child(child) -> dict:
    """Wait for path 18's child (at most SPMD_CHILD_TIMEOUT_S), replay its
    ``spmd:`` lines, fail unless it exited 0 -> its result."""
    import shutil
    proc = child["proc"]
    try:
        proc.wait(timeout=SPMD_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    child["log"].seek(0)
    lines = child["log"].read().splitlines()
    child["log"].close()
    for ln in lines:
        if ln.startswith("spmd:"):
            log(ln)
    try:
        check(proc.returncode == 0, f"path 18's child exited "
              f"{proc.returncode}:\n" + "\n".join(lines[-40:]))
        with open(os.path.join(child["tmp"], "out.json")) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(child["tmp"], ignore_errors=True)
    out["child_wall_s"] = time.time() - child["t0"]
    return out


def spmd_child_main(torch, dev, args) -> int:
    """The child's side of path 18: load K6 (built by the parent), run
    spmd_path on the parent's records, write its result to ``--out``."""
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    build_all([ckpt_codec.LIB, k6.LIB])
    ckpt_codec.LIB.load()
    k6.LIB.load()
    with open(args.spmd_child) as f:
        given = json.load(f)
    out = spmd_path(torch, dev, args, (given["records"], given["record_s"]))
    out["ended_at"] = time.time()
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


def capability_phase(torch, dev):
    """`criu check` on the card: every capability, one line each, and
    every one must be supported (every module is ported)."""
    from repro_torch.api.capabilities import capabilities
    t0 = time.time()
    rep = capabilities(device=dev)
    out = {"s": time.time() - t0,
           "supported": [c.name for c in rep if c.supported],
           "unsupported": [c.name for c in rep if not c.supported]}
    for c in rep:
        row = f" [Table-1 row {c.paper_row}]" if c.paper_row else ""
        log(f"capability: {c.name} {'ok' if c.supported else 'NO'}: "
            f"{c.detail}{row}")
    log(f"capability: {len(out['supported'])} supported, "
        f"{len(out['unsupported'])} not, in {out['s']:.1f} s")
    check(not out["unsupported"], "unsupported on the card: " + "; ".join(
        f"{c.name}: {c.detail}" for c in rep if not c.supported))
    return out


def free_host_and_card(torch):
    """Release what a finished path leaves: Python garbage, the caching
    allocator's free blocks, and the C heap's free pages (glibc's
    malloc_trim), which would otherwise stay in the process's RSS and
    crowd the next path's reads out of the page cache."""
    gc.collect()
    torch.cuda.empty_cache()
    ctypes.CDLL(None).malloc_trim(0)


def _rss_gb() -> float:
    """The process's peak RSS so far, GB (ru_maxrss is in KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9



class RssPeak:
    """The peak of the process's current RSS while the block runs, sampled
    every 20 ms from /proc/self/statm: a path's own host peak, which
    ru_maxrss hides behind an earlier path's."""

    def __init__(self):
        self.peak_gb = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._page = os.sysconf("SC_PAGE_SIZE")

    def rss_gb(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 1e9

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak_gb = max(self.peak_gb, self.rss_gb())

    def __enter__(self):
        self.start_gb = self.rss_gb()      # what the paths before left
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def device_breakdown(torch, fn):
    """Run fn once under torch.profiler -> (wall ms, summed kernel ms,
    [(ms, kernel name, launches)] of every kernel, by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall_ms, sum(r[0] for r in rows), rows


def wgmma_spills(build_log: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} of the flash_fwd_wgmma
    instances in an nvcc -Xptxas -v log."""
    import re
    out, name = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1) if "flash_fwd_wgmma" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


# ------------------------------------------------------ K5's integer bound
# fmix32's two multipliers as cuobjdump prints an immediate: every element
# K5 digests passes through each once, so their count in a loop body is
# twice the elements it digests per trip
FMIX_CONSTS = ("0x85ebca6b", "-0x7a143595", "0xc2b2ae35", "-0x3d4d51cb")
# Hopper SASS by the pipe that executes it: IMAD (and IMUL) on the FMA
# pipe, the other integer operations on the ALU pipe, 16 lanes a clock
# each per SM sub-partition (64 an SM); one warp instruction issued a clock
# per sub-partition (128 lanes an SM)
ALU_OPS = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT",
           "ISETP", "SEL", "MOV", "LEA", "IABS", "IMNMX", "FLO", "POPC",
           "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "ICMP", "VIADD", "VIMNMX",
           "BREV", "CS2R"}
CTRL_OPS = {"BRA", "EXIT", "BAR", "BSSY", "BSYNC", "NOP", "WARPSYNC",
            "CALL", "RET", "YIELD", "DEPBAR", "BPT", "JMP", "BREAK"}
LOAD_BYTES = {"128": 16, "64": 8, "U16": 2, "S16": 2, "U8": 1, "S8": 1}


def sass_class(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("IMAD") or base == "IMUL":
        return "imad"
    if base in ALU_OPS:
        return "alu"
    if base.startswith("U"):
        return "uniform"
    if base in CTRL_OPS:
        return "control"
    if base.startswith(("LD", "ST", "ATOM")) or base in ("RED", "SHFL"):
        return "memory"
    return "other"


def sass_functions(text: str) -> dict:
    """{function: [(address, instruction)]} from ``cuobjdump -sass``; a
    label line (``.L_x_3:``) is kept as (address of the next instruction,
    ".L_x_3:")."""
    import re
    funcs, cur, labels = {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m and cur is not None:
            labels.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.+?)\s*;", ln)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            cur.extend((addr, f"{lab}:") for lab in labels)
            labels = []
            cur.append((addr, m.group(2)))
    return funcs


def _op(ins: str) -> tuple:
    toks = ins.split()
    if toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0], " ".join(toks[1:])


def sass_loops(text: str, match: str) -> list:
    """The innermost loops of the functions whose name holds ``match`` that
    digest elements: for each backward branch, its body's fast path (basic blocks
    with a load narrower than 8 bytes, the ragged end's, dropped), the
    elements a thread digests per trip (fmix32 multipliers / 2), the bytes
    of data it loads per element, and its instructions by pipe."""
    import re
    out = []
    for fn, ins in sass_functions(text).items():
        if match not in fn:
            continue
        label_at = {i[:-1]: a for a, i in ins if i.endswith(":")}
        code = [(a, i) for a, i in ins if not i.endswith(":")]

        def target(rest):
            m = re.search(r"(\.L_x_\d+)", rest)
            if m and m.group(1) in label_at:
                return label_at[m.group(1)]
            m = re.search(r"0x([0-9a-f]+)", rest)
            return int(m.group(1), 16) if m else None
        jumps = [(a, target(_op(i)[1])) for a, i in code
                 if _op(i)[0].startswith("BRA")]
        loops = [(t, a) for a, t in jumps if t is not None and t <= a]
        for t, a in loops:
            if any((t2, a2) != (t, a) and t <= t2 and a2 <= a
                   for t2, a2 in loops):
                continue                # not innermost
            body = [(b, j) for b, j in code if t <= b <= a]
            targets = {t} | {tt for b, tt in jumps
                             if t <= b <= a and tt is not None
                             and t <= tt <= a}
            blocks, cur = [], []
            for b, j in body:
                if b in targets and cur:
                    blocks.append(cur)
                    cur = []
                cur.append(j)
                if _op(j)[0].split(".")[0] in ("BRA", "EXIT"):
                    blocks.append(cur)
                    cur = []
            if cur:
                blocks.append(cur)

            def load_bytes(j):
                o = _op(j)[0]
                if not o.startswith("LDG"):
                    return 0
                parts = o.split(".")
                return next((LOAD_BYTES[p] for p in parts if p in LOAD_BYTES),
                            4)
            fast = [j for blk in blocks
                    if all(load_bytes(j) in (0, 8, 16) for j in blk)
                    for j in blk]
            el = sum(1 for j in fast
                     if any(c in j.lower() for c in FMIX_CONSTS)) // 2
            if not el:
                continue
            counts = {}
            for j in fast:
                k = sass_class(_op(j)[0])
                counts[k] = counts.get(k, 0) + 1
            # the data's bytes: the streaming (evict-first) loads, where
            # the loop marks them so; else every load, weights included
            stream = [j for j in fast if ".EF" in _op(j)[0]] or fast
            data = sum(map(load_bytes, stream))
            if not data:                # no whole-vector loads: not a main loop
                continue
            out.append({"function": fn, "start": t, "end": a,
                        "elements": el, "bytes_per_element": data / el,
                        "counts": counts,
                        "instructions": len(fast)})
    return out


def int_issue_ms(elements: int, loop: dict, sms: int, clock_hz: float):
    """The integer-issue bound (ms) of digesting ``elements`` with ``loop``'s
    instructions per element: the busier of the ALU and FMA pipes (64
    lanes a clock an SM each) and the issue limit (128 lanes a clock an SM,
    every instruction of the loop)."""
    c, el = loop["counts"], loop["elements"]
    per_sm_clock = max(c.get("alu", 0) / 64, c.get("imad", 0) / 64,
                       loop["instructions"] / 128) / el
    return elements * per_sm_clock / sms / clock_hz * 1e3


def k5_loops(so_path: str, match: str) -> dict:
    """{"fp32": loop, "bf16": loop}: the K5 main loop of each dtype in the
    built library (the one digesting the most elements a trip)."""
    from repro_torch.kernels._build import nvcc
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(nvcc())),
                             "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    loops = sass_loops(res.stdout, match)
    out = {}
    for lp in loops:
        k = "bf16" if lp["bytes_per_element"] <= 2 else "fp32"
        if k not in out or lp["elements"] > out[k]["elements"]:
            out[k] = lp
    return out


def card_clocks() -> dict:
    """The card's SM count and its maximum SM clock (nvidia-smi)."""
    import torch
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_mhz": float(res.stdout.strip().splitlines()[0])}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="train-path image directory (default: an in-memory "
                         "mem:// tier)")
    ap.add_argument("--out", default=None, help="write the run's record here")
    ap.add_argument("--lifecycle-dir", default=None,
                    help="where the lifecycle path's images and the remote "
                         "path's hot fronts go (default: the system's "
                         "temporary directory)")
    ap.add_argument("--spmd-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fleet-done", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-records", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # cuBLAS picks deterministic algorithms only with a fixed workspace;
    # set before CUDA initializes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.spmd_records:
        recs, record_s = spmd_records()
        with open(args.spmd_records, "w") as f:
            json.dump({"records": recs, "record_s": record_s}, f)
        return 0
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.spmd_child:
        return spmd_child_main(torch, dev, args)
    card = smi_line()
    log(card)
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
        f"{torch.cuda.device_count()} device(s)")

    spmd_recs = start_spmd_records(args)
    t0 = time.time()
    libs = [ckpt_codec.LIB, k6.LIB]
    sos = build_all(libs)
    for lib in libs:
        lib.load()
    log(f"build: {', '.join(os.path.relpath(so, ROOT) for so in sos)} in "
        f"{time.time() - t0:.1f} s (one nvcc each, in parallel)")
    for lib in libs:
        for ln in lib.ptxas_lines():
            log(f"build: {lib.name}: {ln}")
    spills = wgmma_spills(k6.LIB.build_log)
    log(f"build: flash_attention wgmma kernels' spill bytes (stores, loads): "
        f"{spills}")
    check(len(spills) == len(k6.WGMMA_HEAD_DIMS)
          and all(v == (0, 0) for v in spills.values()),
          f"the wgmma kernels spill or are missing from ptxas's report: "
          f"{spills}")

    marks = [("build", time.time() - t_start)]

    def mark(label):
        """The script's clock at the end of a phase."""
        marks.append((label, time.time() - t_start))

    rows = kernel_phase(torch, dev, args.seed)
    rows["flash_attention"] = flash_phase(torch, dev, args.seed)
    mark("kernels")
    torch.cuda.reset_peak_memory_stats()
    record = train_path(torch, dev, args)
    mark("train")
    record["train_peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for k, n in record["launches"].items():
        rows[k]["launches"] = n
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    record["serve"] = serve_path(torch, dev, args)
    record["serve"]["peak_device_gb"] = max(
        torch.cuda.max_memory_allocated(),
        record["serve"]["record"]["path_peak_device_gb"] * 1e9) / 1e9
    rows["flash_attention"]["launches"] = \
        record["serve"]["launches"]["flash_attention"]
    mark("serve")
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()

    def own_clock(path, **kw):
        """A path with its own clock, host and device peaks (a path that
        ends with a check of its prefill against the record reports its
        peak before that check)."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with RssPeak() as rss:
            out = path(torch, dev, args, **kw)
        out.update(host_peak_rss_gb=rss.peak_gb,
                   host_rss_at_start_gb=rss.start_gb,
                   wall_s=time.time() - t0,
                   peak_device_gb=max(
                       torch.cuda.max_memory_allocated() / 1e9,
                       out.get("record", {}).get("path_peak_device_gb", 0)))
        free_host_and_card(torch)
        return out

    def beside_preempted():
        """Paths 13 and 6, one after the other, beside path 7's preempted
        child (a third of the card; this process idle)."""
        return {"families": own_clock(families_path),
                "precopy": own_clock(precopy_path)}

    def beside_resume():
        """Path 12 (b) (subprocesses with little of the card), then path
        17's and path 9's records traced on meta, beside path 7's resume
        and reference (path 18's trace in their own process)."""
        t0 = time.time()
        restart = socket_restart(dev, args)
        restart["wall_s"] = time.time() - t0
        return {"restart": restart, "remat_record": remat_record(),
                "plane_record": plane_record()}

    t0 = time.time()
    record["lifecycle"] = lifecycle_path(torch, dev, args,
                                         beside=beside_preempted,
                                         beside_resume=beside_resume)
    side = record["lifecycle"].pop("beside")
    later = record["lifecycle"].pop("beside_resume")
    remat_planned = later["remat_record"]
    record["families"] = fam = side["families"]
    record["precopy"] = pre = side["precopy"]
    log(f"families: path {fam['wall_s']:.1f} s ((a) {fam['archs_s']:.1f} s, "
        f"(b) {fam['session_s']:.1f} s, (c) {fam['train_s']:.1f} s) beside "
        f"path 7's preempted run; peak device memory "
        f"{fam['peak_device_gb']:.1f} GB; host peak RSS of the path "
        f"{fam['host_peak_rss_gb']:.1f} GB, "
        f"{fam['host_peak_rss_gb'] - fam['host_rss_at_start_gb']:.1f} GB "
        f"above the {fam['host_rss_at_start_gb']:.1f} GB at its start "
        f"(sampled every 20 ms)")
    log(f"precopy: path {pre['wall_s']:.1f} s after path 13, beside path 7's "
        f"preempted run; peak device memory {pre['peak_device_gb']:.1f} GB; "
        f"host peak RSS of the path {pre['host_peak_rss_gb']:.1f} GB "
        f"(sampled every 20 ms)")
    log(f"lifecycle: the preempted run {record['lifecycle']['preempted_wall_s']:.1f}"
        f" s, paths 13 and 6 beside it {fam['wall_s'] + pre['wall_s']:.1f} "
        f"s; the resume beside the reference "
        f"{record['lifecycle']['resume_phase_wall_s']:.1f} s, path 12 (b) "
        f"({later['restart']['wall_s']:.1f} s), path 17's record on meta "
        f"({remat_planned[1]:.1f} s) and path 9's "
        f"({later['plane_record'][1]:.1f} s) beside those; paths 7, 13, 6 "
        f"and 12 (b) "
        f"together {time.time() - t0:.1f} s")
    for k, n in fam["launches"].items():
        rows[k]["launches"] += n
    rows["flash_attention"]["launches"] += pre["launches"]["flash_attention"]
    rows["digest_blocks"]["launches"] = \
        pre["launches"]["digest_blocks"] \
        + record["lifecycle"]["launches"]["digest_blocks"]
    mark("lifecycle+families+precopy")
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with RssPeak() as rss_remote:
        record["remote"] = remote_path(torch, dev, args)
    record["remote"].update(
        host_peak_rss_gb=rss_remote.peak_gb, wall_s=time.time() - t0,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"remote: path {record['remote']['wall_s']:.1f} s; peak device "
        f"memory {record['remote']['peak_device_gb']:.1f} GB; host peak RSS "
        f"of the path {rss_remote.peak_gb:.1f} GB (sampled every 20 ms)")
    for k, n in record["remote"]["launches"].items():
        rows[k]["launches"] += n
    mark("remote")
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    # paths 9 and 12 (a) beside path 16: the crash path's trainers run in
    # child processes (2 x 19 GB of the card), the plane holds 13 GB of it
    # and path 12 (a) 10 GB after it
    side = Beside(lambda: crash_path(torch, dev, args))
    try:
        record["plane"] = own_clock(plane_path,
                                    planned=later["plane_record"])
        record["socket"] = sock = own_clock(socket_path, restart=False)
    finally:
        side.thread.join()              # its processes end with it
    record["crash"] = side.join()
    sock["restart"] = later["restart"]
    log(f"plane: path {record['plane']['wall_s']:.1f} s beside path 16; "
        f"peak device memory {record['plane']['peak_device_gb']:.1f} GB; "
        f"host peak RSS of the path {record['plane']['host_peak_rss_gb']:.1f}"
        f" GB (sampled every 20 ms)")
    log(f"socket: path (a) {sock['wall_s']:.1f} s after path 9, beside path "
        f"16 (in process {sock['in_process_s']:.1f} s); (b) "
        f"{sock['restart']['wall_s']:.1f} s beside path 7's resume; peak "
        f"device memory {sock['peak_device_gb']:.1f} GB in this process; "
        f"host peak RSS of the path {sock['host_peak_rss_gb']:.1f} GB, "
        f"{sock['host_peak_rss_gb'] - sock['host_rss_at_start_gb']:.1f} GB "
        f"above the {sock['host_rss_at_start_gb']:.1f} GB at its start "
        f"(sampled every 20 ms; the subprocesses' own not included)")
    log(f"crash: path {record['crash']['wall_s']:.1f} s, from path 9's "
        f"start (paths 9, 12 (a) and 16 together {time.time() - t0:.1f} s)")
    for k in ckpt_codec.KERNELS:
        rows[k]["launches"] += sock["launches"][k]
    mark("plane+socket+crash")
    t0 = time.time()
    record["archs"] = archs_phase(torch, dev, args)
    record["archs_s"] = time.time() - t0
    log(f"archs: phase {record['archs_s']:.1f} s")
    rows["flash_attention"]["launches"] += \
        record["plane"]["launches"]["flash_attention"] + sum(
            sum(a["k6_routes"].values()) for a in record["archs"].values())
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    # path 18 in a child process beside path 11 (12 GB of the card beside
    # its 56; path 11 is host-bound on its own threads)
    *spmd_planned, spmd_wait = finish_spmd_records(spmd_recs)
    spmd_child = start_spmd_child(spmd_planned, args)
    t0 = time.time()
    try:
        with RssPeak() as rss_fleet:
            record["fleet"] = fleet_path(torch, dev, args)
    finally:
        # path 18 (e)'s async capture waits for this (the host's room)
        free_host_and_card(torch)
        rss_at_done = RssPeak().rss_gb()
        open(spmd_child["fleet_done"], "w").close()
    record["fleet"].update(
        host_peak_rss_gb=rss_fleet.peak_gb, wall_s=time.time() - t0,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"fleet: path {record['fleet']['wall_s']:.1f} s; peak device memory "
        f"{record['fleet']['peak_device_gb']:.1f} GB; host peak RSS of the "
        f"path {rss_fleet.peak_gb:.1f} GB (sampled every 20 ms)")
    check(rss_fleet.peak_gb < 96 * 2 ** 30 / 1e9,
          f"the fleet path's host peak {rss_fleet.peak_gb:.1f} GB passed the "
          f"machine's 96 GiB")
    for k in ckpt_codec.KERNELS:
        rows[k]["launches"] += record["fleet"]["launches"][k]
    record["spmd"] = spmd = finish_spmd_child(spmd_child)
    spmd["child_end_s"] = spmd["ended_at"] - spmd_child["t0"]
    log(f"spmd: path 18 in a child process beside path 11: the child ended "
        f"{spmd['child_end_s']:.1f} s after its start (its card part "
        f"{spmd['wall_s']:.1f} s; its records {spmd['record_s']:.1f} s on "
        f"meta in their own process from the script's start, waited for "
        f"{spmd_wait:.1f} s), path 11 {record['fleet']['wall_s']:.1f} s "
        f"({'before' if spmd['child_end_s'] <= record['fleet']['wall_s'] else 'after'}"
        f" path 11's end)")
    for k, n in spmd["launches"].items():
        rows[k]["launches"] += n
    capture = max(spmd["train"]["modes"][k]["host_peak_rss_gb"]
                  for k in ("async", "async_wait"))
    log(f"spmd: (e)'s async capture started after path 11's end: this "
        f"process's host RSS then {rss_at_done:.1f} GB + the child's peak "
        f"{capture:.1f} GB = {rss_at_done + capture:.1f} GB of the host's "
        f"96 GiB")
    check(rss_at_done + capture < 96 * 2 ** 30 / 1e9,
          f"path 18 (e)'s async capture: the host held "
          f"{rss_at_done + capture:.1f} GB")
    mark("archs+fleet+spmd")
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with RssPeak() as rss_vis:
        record["vision"] = vision_path(torch, dev, args)
    vis = record["vision"]
    vis.update(host_peak_rss_gb=rss_vis.peak_gb,
               host_rss_at_start_gb=rss_vis.start_gb, wall_s=time.time() - t0,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"vision: path {vis['wall_s']:.1f} s ((a) {vis['prefill_s']:.1f} s, "
        f"(b) {vis['session_s']:.1f} s, (c) {vis['train_s']:.1f} s); peak "
        f"device memory {vis['peak_device_gb']:.1f} GB; host peak RSS of "
        f"the path {rss_vis.peak_gb:.1f} GB, "
        f"{rss_vis.peak_gb - rss_vis.start_gb:.1f} GB above the "
        f"{rss_vis.start_gb:.1f} GB at its start (sampled every 20 ms)")
    rows["flash_attention"]["launches"] += vis["launches"]["flash_attention"]
    mark("vision")
    free_host_and_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    record["dryrun"] = dryrun_path(
        torch, dev, args,
        beside=lambda: remat_path(torch, dev, args, remat_planned))
    dr = record["dryrun"]
    record["remat"] = dr.pop("beside")
    dr["wall_s"] = time.time() - t0
    log(f"dryrun: (c) {dr['card_s']:.1f} s, (a) + (b) {dr['meta_s']:.1f} s, "
        f"(d) {dr['examples_s']:.1f} s beside path 17 (paths 15 and 17 "
        f"together {dr['wall_s']:.1f} s)")
    for k, n in record["remat"]["launches"].items():
        rows[k]["launches"] += n
    mark("dryrun+remat")
    free_host_and_card(torch)
    record["capabilities"] = capability_phase(torch, dev)
    mark("capabilities")
    record["timeline"] = marks
    log("timeline (s since start at each phase's end): " + ", ".join(
        f"{label} {t:.1f}" for label, t in marks))
    record["kernels"] = list(rows.values())
    record["card"] = card
    record["wall_s"] = time.time() - t_start
    record["host_peak_rss_gb"] = _rss_gb()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"precopy: host peak RSS of the path "
        f"{record['precopy']['host_peak_rss_gb']:.1f} GB (sampled every 20 ms)")
    log(f"done in {record['wall_s']:.0f} s; host peak RSS "
        f"{record['host_peak_rss_gb']:.1f} GB; peak device memory: train "
        f"{record['train_peak_device_gb']:.1f} GB, serve "
        f"{record['serve']['peak_device_gb']:.1f} GB, pre-copy "
        f"{record['precopy']['peak_device_gb']:.1f} GB, lifecycle children "
        f"{record['lifecycle']['preempted_peak_device_gb']:.1f} GB "
        f"(preempted), remote {record['remote']['peak_device_gb']:.1f} GB, "
        f"plane {record['plane']['peak_device_gb']:.1f} GB, fleet "
        f"{record['fleet']['peak_device_gb']:.1f} GB, socket "
        f"{record['socket']['peak_device_gb']:.1f} GB, families "
        f"{record['families']['peak_device_gb']:.1f} GB, vision "
        f"{record['vision']['peak_device_gb']:.1f} GB")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K6's row also carries its numbers at gemma2's head dim 256, K5's on
    # a bf16 KV-cache leaf and on path 6's grouped list
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + tuple(x for x in ("hd256", "bf16",
                                                   "grouped") if x in r)}
        for r in record["kernels"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
