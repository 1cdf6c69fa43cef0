#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the port's serving paths on an index of the ``osm`` synthetic
profile at 1,000,000 objects (STR R-tree, leaf 128, fanout 8) with the
4096-query MIX workload in 4 batches of 1024:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. builds the dataset, the index and the device snapshot; serves the SKR
   batches and the kNN batches (k = 10, query points at the centres of the
   MIX rectangles) once each to warm up, learn the frontier widths and
   capture each kernel's operands at the shapes the path gives it;
3. SKR main path: serves the batches through ``serve_batch`` (fused verify
   ``variant="auto"``) and ``retrieve(fused_variant="vmem")``, with the
   launch counts zeroed before and read after each run (the descent on
   ``frontier_level_narrow``, once per level, with the gathered-plane
   frontier wrappers refused, as on every descent; the compact fused
   verify's remapping instance once a batch, ``fused_verify_remap_slot`` or
   in the ``vmem`` run ``fused_verify_remap_tile``, with
   ``remap_query_words`` refused, as in every fused SKR run below); checks
   every output
   key against a run with the kernels swapped for their plain versions, and
   ids / ``nodes_checked`` / ``verified`` against the host oracle
   ``execute_serial`` on 256 queries with no overflow;
4. kNN main path: serves the batches through ``serve_knn_batch`` at k = 10
   (counts zeroed before, read after; the narrow descent on
   ``knn_level_dist_narrow``, with the gathered-plane wrappers refused),
   checks every key against its
   plain-version rerun, ids and ``dist2`` bit for bit against the host
   oracle ``knn_query`` on 256 queries, and the pruning ratio (m * n_leaf /
   leaves verified) above 1; then one batch each at k = 1 and k = 100
   against the oracle, and one batch with ``knn_dtype="bf16"`` against f32;
5. the f32 descent: the SKR batches and one kNN batch with
   ``quantized=False`` (counts zeroed before, read after; the SKR batches
   on ``frontier_level`` once per level, the kNN batch on
   ``knn_level_dist`` alone, its peak device memory below one (M, F, W)
   word plane), then one SKR and one kNN batch on the snapshot with its
   narrow planes stripped (what an overflowing coordinate dictionary
   gives), all equal to the default runs;
6. the verify knobs: one SKR batch each with ``fused=False``,
   ``compact=False`` (the (M, T) and the query-tile launch),
   ``fused=False, compact=False`` and on the snapshot with its compact bank
   stripped (what a leaf dictionary above ``LEAF_DICT_MAX`` gives), each
   equal to the default run and each launching its verify kernel;
7. live updates: two ``DeltaLog``s over the snapshot, each taking 10,000
   inserts (1 % of n, in batches of 1,000) and 5,000 deletes (100 of them
   buffered inserts). Log A's inserts carry terms of the leaf they route
   to, so its insert slots stay on the compact words (``compact_ok``);
   log B's are jittered copies of random objects with their own keywords,
   which flips ``compact_ok``. Per log: the host time per insert batch,
   ``slots_per_leaf``, the delta's bytes on the device; a buffer taken
   before the last insert still gives its earlier answer; the SKR batches
   through ``serve_batch(delta=...)`` and one kNN batch at k = 10 through
   ``serve_knn_batch(delta=...)`` (warm, counts zeroed before, read after;
   the SKR descent on ``frontier_level`` once per level, the insert slots
   through the slot entry that reads the delta's buffers, log A's
   ``skr_verify_slots_compact`` -- on the words the fused verify remapped --
   and log B's ``skr_verify_slots``, once a batch, and no gathered verify
   entry) equal their plain-version reruns on
   every key, SKR ids equal ``execute_serial`` and kNN ids and ``dist2``
   equal ``knn_query`` on 256 queries each, over a cold STR index of
   ``merged_dataset()``; then log B's warm delta SKR batch holds its peak
   device memory above its start below one (M, T*B, W) int32 plane of its
   insert slots;
8. the dense A/B scan: the snapshot is built with ``dense=True`` (its
   child matrices); the SKR batches through ``serve_batch(mode="dense")``
   (counts zeroed before, read after; ``skr_filter`` once per level) and
   one batch with log A's delta, each equal on every key to its
   plain-version rerun, with the frontier run's ``overflow`` and result
   sets, ``nodes_scanned`` at or above the frontier's, and ids equal to
   ``execute_serial`` on the 256 oracle queries; each of the first batch's
   five ``skr_filter`` launches timed alone, and their sum;
9. standing subscriptions: 100,000 subscriptions with the rectangles and
   keywords of a MIX workload (seed 2) in a ``SubscriptionIndex`` on the
   card; log A's 10,000 inserts arrive in batches of 1,000 through a
   ``DeltaLog`` and ``match_arrivals`` in the same step; after the fifth
   batch 10,000 subscriptions leave and 10,000 new ones take their slots
   (counts zeroed before, read after: the pairs instance
   ``sub_match_pairs`` for every match, the matrix instance never, with
   the matrix entries and ``pack_query_words`` refused; per batch the
   notifications, the retries, the host time by step -- bitmaps, upload,
   block compile, kernel and count readback, sort and copy, the rest --
   and the peak device memory, below one (N, S) int8 matrix); ``pump``
   afterwards queues nothing, a twin index driven by ``pump`` alone
   drains the identical stream, a rerun with the pairs entry swapped for
   its plain version gives the same stream pair for pair, and on a seeded
   sample of 256 subscriptions the stream equals ``SubscriptionOracle``'s
   replay; then the matrix entry ``match_subscriptions`` once on the
   first arrival batch, its nonzero entries equal to the pairs;
10. the CDF-MLP bank: ``cdf_bank_forward`` of a seeded bank of
   1->16->16->16->1 MLPs, two per ``osm`` keyword held by at least 0.1 % of
   the objects, at every object's x coordinate, against the chunked plain
   version to ``atol=2e-6``; then banks of B off the kernel's 8-model tile
   at H = 32 and H = 4 on objects' x with NaN, infinite and far points
   written in (``CDF_EDGE_X``), NaN exactly where the points are NaN;
11. one phase per kernel (13, and row 11's two instances): holds the
   kernel against its plain PyTorch version on the card -- bit-exact, the
   CDF bank to ``atol=2e-6``, the match pairs in canonical order, a NaN
   equal to a NaN -- at the captured shapes (rows 2 and 3: the remapping
   instances, also with ``words=True``; rows 9 and 10: the slot entries at
   logs A's and B's insert slots; row 12 at all five levels) and at ragged
   edges (rows 7 and 8 also at NaN and infinite query points, row 13 at
   every hidden width, B of 1 to 196 and edge points), and
   times the kernel's launches on the device (``torch.profiler``; it
   fails where the profiler saw too few launches; the wrapper's time a
   call back to back, CUDA events, in the log beside it) and the plain version
   (CUDA events) beside a bound; the match pairs at capacity 0
   and 1 (one retry each); then times the (M, F, W) gather the f32 kNN
   descent no longer makes, and holds ``knn_frontier_dist(_narrow)`` and
   ``filter_frontier(_narrow)`` (gathered operands, through the level
   kernels), the given-words instances of rows 2 and 3 (timed), the
   query-tile verify without packed words and the unfused verify's
   gathered entries (ids and both counts; at the knob shapes, timed)
   against their plain versions; then times, at the captured shapes, the
   per-slot planes the engine no longer gathers for rows 1, 4, 7, 9 and 10,
   the keyword recounts of rows 9 and 10, the host packing the SKR batch no
   longer makes, ``remap_query_words``, the per-slot query words rows 2
   and 3 no longer take, and the subscription stream's host packing and
   ``torch.nonzero`` over the (N, S) match matrix;
12. profiles one warm SKR batch, one warm dense-scan batch and one warm
   SKR batch each with log B's and log A's deltas (no kNN batch: its
   732,838 profiler events took about two minutes to summarize, most of
   this phase, and left the whole run within 50 s of its time limit)
   (``torch.profiler``: device busy and idle share, the largest device and
   host items);
13. construction: ``build_wisk`` on the card over the same 1,000,000
   objects with ``BuildConfig()`` (itemsets, the CDF bank, learned splits,
   DQN packing), trained on a MIX workload of 4096 queries (seed 3; the
   served workload is seed 1): each phase's seconds, the counters, K and
   the level widths, the bank's B, E and final loss, each packed level's
   ``n_upper`` and the peak device memory; the learned index's snapshot
   (bytes, OBJ, compact bank, narrow planes) serves the 4 batches, the
   first batch's queries without overflow equal ``execute_serial``, and
   its mean per-query Eq. 1 cost is printed beside the STR R-tree's (not a
   claim); then twin builds at 120,000 objects, equal bit for bit
   (partition, hierarchy, bank), an ``accelerated=True`` build, and a
   ``warm_start_rebuild`` of the first twin for a GAU workload (regressed
   leaves detected) whose index serves a batch equal to ``execute_serial``;
14. the live front door: a ``LiveIndex`` over the construction phase's
   full-size learned build (no second build; its snapshot's bytes, OBJ and
   compact bank printed) with ``DriftConfig(threshold=1.3,
   min_queries=48)``, batches of 256: a warm-up batch and 4 fresh MIX
   batches, the monitor armed after each; 100,000 geofences (MIX, seed
   2); 10,000 inserts in batches of 1,000 (host time each, the
   subscription match included; the notifications drained after the
   fifth) and 5,000 deletes (100 of them buffered inserts); one SKR batch
   with the delta, (a) its queries without overflow equal
   ``exact_query_result_ids`` over ``merged_dataset()``, and one kNN batch
   at k = 10, (b) ids and ``dist2`` equal ``knn_query`` over a cold STR
   index of it; shifted traffic (UNI, then GAU, then LAP, 4 batches each
   at most) until the monitor trips, each ratio printed; ``maybe_rebuild()``
   with no force, timed apart as ``warm_start_rebuild`` and the new
   snapshot, peak device memory across the swap, each generation's bytes,
   OBJ not grown; (c) the old generation serves one batch equal before and
   after the swap; (d) the new one has ``seq`` + 1, no delta, the merged
   objects, and its first batch's queries without overflow equal
   ``execute_serial``; 2,000 inserts after the swap (ids above the
   pre-swap ones) and traffic until the monitor re-arms; (e) the whole
   notification stream equals its plain rerun and a 256-sample
   ``SubscriptionOracle`` replay, a second drain empty; one SKR batch
   without a delta, one with it and one insert batch profiled, with the
   rows of PERF.md section 6 they launch;
15. multi-rank serving: ``N_RANKS`` = 2 ranks spawned with
   ``torch.multiprocessing``, gloo on one card (ranks share it; NCCL
   refuses two ranks on one GPU), NCCL with a card a rank. The parent puts
   the snapshot (without the dense matrices), its
   ``PartitionedSnapshot.build(S=2)`` and log B's delta in shared host
   memory; each rank places only its slab (and, for the query-parallel
   regime, a replica). Checked on every rank: index-parallel SKR over the
   4 batches (cold, then warm) and one kNN batch at k = 10 (from a cold
   cache) against the single-device outputs (id sets and counters; kNN
   every key); query-parallel SKR and kNN at the single-device run's
   learned widths, every key; log B's delta routed with
   ``partition_delta``, one SKR and one kNN batch against the
   single-device delta runs; the flat step at ``WiskServeConfig()`` (4096
   queries, 65,536 nodes, W = 128, OBJ = 512; each rank draws its own
   leaf rows on the card) against its plain per-shard sum;
   ``LiveIndex(index_shards=2)`` over the 120,000-object twin build
   through serves, 1,000 inserts, 500 deletes, a kNN batch and a forced
   swap against the single-device ``LiveIndex``. Printed: backend, slab
   and snapshot bytes, each batch's seconds, the collectives' share of the
   warm batches (host clock, waits for the peer rank included) and of one
   profiled SKR batch per regime (``torch.profiler``, with the device's
   idle share), that host time split for one more SKR batch per regime
   on every rank into the wait for the rank's own device work, the wait
   for its peer and the collective itself, launches by row per rank, peak
   device memory per rank;
16. LM serving (``lm_serving``): ``tinyllama-1.1b`` at its published
   widths (bf16, weights from a seeded generator) fed by the port's SKR
   retrieval: the first 128 queries of the first batch through
   ``retrieve_workload`` (counts zeroed before, read after the whole
   phase's main path: rows 1 and 3 must launch; the queries without
   overflow equal ``execute_serial``), each query's first 32 retrieved ids
   modulo the vocabulary teacher-forced through ``decode_step`` into a
   4096-slot bf16 cache, then ``greedy_generate(n_new=64)``: the warm
   step's time (CUDA events) against its bound (every weight and the whole
   cache read once at 3.35 TB/s), tokens/s, peak device memory;
   ``prefill_step`` at B = 8, S = 2048 (masked scan, chunk 1024) against
   its bound (its operations at 989 TFLOP/s); checks: 512 decode steps at
   B = 8 against ``prefill_step`` and 4 decode steps at B = 2 against the
   port's own run on the CPU, each within 0.05 of the largest logit,
   greedy tokens equal wherever the CPU's top-2 margin exceeds the error;
   then ``deepseek-7b``, ``minitron-8b``, ``starcoder2-7b`` (36 heads
   padded to 48: the padded slots zero) and ``phi-3-vision-4.2b`` (576
   stub patches) at their published widths, one short pass each (prefill
   at B = 2, S = 256; 8 decode steps against prefill; peak memory);
17. LM training (``lm_training``): (a) ``tinyllama-1.1b`` at its published
   config (bf16, AdamW, ``remat="full"``, seeded weights) on the
   ``TokenPipeline`` of seed 0 at B = 4, S = 2048: 12 ``train_step``s, each
   timed with CUDA events, the warm steps' mean and spread against
   ``lm_train_bound`` (four forwards' operations at 989 TFLOP/s; AdamW's
   22 B a parameter at 3.35 TB/s), tokens/s, one profiled step's device
   idle share, peak device memory, every step's loss, grad_norm and lr
   finite; (b) one step at B = 1, S = 128 from one fresh state on the card
   and on the CPU: loss within 1e-2, grad_norm within 2e-2, AdamW's m
   within 5e-2 and v within 1e-1 of each leaf's largest value; (c) one
   step of ``phi-3-vision-4.2b`` at its published width (B = 1, 256
   patches + 768 tokens: ``batch_spec("train", 1024, 1)``): the text
   region's loss finite, peak memory; (d) the reduced dense config
   through ``train``: 200 steps at B = 8, S = 128 with checkpoints every
   50, the loss falling, a restart to 220 restored from 200; the first 3
   losses, and 3 steps each of Adafactor and SGD, within 1e-2 of the
   port's CPU runs;
18. the MoE and MLA families (``moe_families``), no kernel on their path:
   (a) ``qwen2-moe-a2.7b`` at its published widths, all 24 layers (60
   routed experts padded to 64, top-4, 4 shared; bf16, seeded weights):
   ``prefill_step`` at B = 8, S = 2048 against its bound and the (token,
   expert) choices it dropped at capacity, then at B = 128 into 1,024
   slots (4,096 would be 103 GB of cache) 4 teacher-forced and 8 greedy
   steps (tokens/s), a warm ``decode_step`` (CUDA events) against its bound
   (the weights of the experts the step's tokens chose, the whole cache),
   its dropped choices, one profiled step, peak memory; then 4 decode
   steps at B = 2 against prefill within 0.05 (no capacity binds at 8
   tokens; each decode step replays prefill's expert choices) with the
   weights drawn anew in f32 (the cache bf16, as the reference's: in bf16
   weights the cache's rounding grows to 9.2 % over the 24 layers); (b)
   ``deepseek-v3-671b`` at its published widths cut to 4 layers (3 dense,
   one MoE layer of 256 experts; recorded as a cut), the same steps with
   prefill at B = 1, S = 2048 and the decode into a 4,096-slot latent
   cache; (c) the card against the port's CPU run on the same weights
   (qwen2-moe at published width cut to 2 layers, deepseek-v3 at its
   ``reduced()`` config): the first MoE call of a prefill at B = 8, S = 16
   routed equal wherever the CPU's router margin exceeds the two runs'
   difference; then, the card replaying the CPU's routing decisions, that
   prefill's and 4 decode steps' logits within 0.05 of the largest logit,
   greedy tokens equal above the top-2 margin; (d) one ``train_step`` of
   each at published width, depth cut (qwen2-moe 2 layers with AdamW;
   deepseek-v3 one dense and one MoE layer with the MTP block and
   Adafactor; ``remat="full"``) at B = 1, S = 2048 against
   ``lm_train_bound``, peak memory; one step from a fresh state on the CPU
   and on the card (B = 1; S = 64 for qwen2-moe at published width, bf16,
   within the phase 17(b) bounds; S = 32 for deepseek-v3 at its
   ``reduced()`` config in f32, within 1e-5 (loss, grad_norm) and 1e-4
   (each optimizer-state leaf): its CPU step at published width takes
   about five minutes), the card replaying the CPU's routing decisions at
   its own gates, the first MoE call's own decisions against the CPU's by
   the margin rule; (e) the first MoE layer's forward twice on one input whose
   first half is one token repeated (its experts' capacity binds on ties):
   the same bits, the lowest-indexed tied tokens kept;
19. the enc-dec and xLSTM families (``seq_families``), no kernel on their
   path, both at their published widths and depth (bf16, seeded weights):
   (a) ``whisper-base`` (6 + 6 layers, d_model 512): ``prefill_step`` at
   B = 8, S = 2048 on the ``TokenPipeline``'s batch, its (8, 512, 512) f32
   frames included, against its bound (one profile); at B = 128 into
   2,048 self-cache slots, the 512-slot cross cache filled from the
   encoder over the pipeline's frames (the reference fills nothing), 4
   teacher-forced and 8 greedy steps (tokens/s), a warm ``decode_step``
   (CUDA events) against its bound (the self cache, the cross cache and
   the weights read), one profiled step (idle share, host aten calls),
   peak memory; (b) ``xlstm-125m`` (two units of five mLSTM layers and an
   sLSTM layer, d_model 768) the same but the prefill's profile, its
   decode from ``init_*_state`` (3.03 GB of f32 states read and written a
   step); (c) for each, 256 decode steps at B = 8 against
   ``prefill_step`` within 0.05 of the largest logit, every row (whisper:
   the cross cache filled from 64 frames; xLSTM: from ``init_*_state``,
   its weights drawn anew in f32 -- in bf16 the reference's own decode
   drifts 15 % at 12 layers -- and the reference's own decode from the
   zero cache finite), then the card against the port's CPU run on one
   set of weights at ``reduced()`` (f32, full f32 products: 1e-5;
   whisper's decode through its bf16 cache 2e-2) and at published width
   cut to 2 layers (bf16: 0.05; xLSTM's unit cut to one mLSTM and one
   sLSTM layer): prefill at B = 4, S = 16, 4 decode steps, greedy tokens
   equal above the CPU's top-2 margin; (d) a ``train_step`` of each at
   full depth, B = 4, S = 2048 (xLSTM: S = 512, its time loop), AdamW,
   ``remat="full"``, one warm-up and three timed (CUDA events) against
   ``lm_train_bound``, tokens/s, peak memory; one step at ``reduced()``
   f32 against the CPU's within 1e-5 (loss, grad_norm) and 1e-4 (each
   AdamW moment; xLSTM, whose gates amplify f32 roundings: grad_norm
   5e-5, moments 1e-3);
20. the hybrid family (``hybrid_family``), no kernel on its path:
   ``jamba-v0.1-52b`` at its published widths (d_model 4096, 32 heads of
   128 and 8 kv heads, 16 experts top-2 of width 14336 every other layer,
   d_inner 8192, d_state 16, SSM chunks of 128; bf16, seeded weights): (a)
   cut to 16 of its 32 layers (two superblocks, 26.05 B parameters, 52.17
   GB; recorded as a cut): ``prefill_step`` at B = 8, S = 2048 against its
   bound and the (token, expert) choices it dropped at capacity; at B = 128
   into 4,096 slots (4.30 GB of k/v, 1.12 GB of Mamba state) 4
   teacher-forced and 8 greedy steps (tokens/s), a warm ``decode_step``
   (CUDA events) against its bound with the experts its tokens chose, one
   profiled step (idle share, host aten calls), peak memory; (b) the
   reference's ``long_500k`` shape: a warm ``decode_step`` at B = 1 into
   524,288 slots (4.30 GB of bf16 k/v) over a seeded cache at position
   524,287, against its bound; (c) 256 decode steps at B = 8 from the zero
   cache against ``prefill_step`` within 0.05 of the largest logit, every
   row, each step replaying prefill's expert choices, the capacity factor
   raised so that none binds at prefill, the weights drawn anew in f32 at 8
   layers (in bf16 the drift grows with depth: 5.1 % at 16 layers); (d) the
   card against the port's CPU run: the ``reduced()`` config in f32 under
   full f32 products (prefill at B = 4, S = 32 and 4 decode steps within
   1e-5, the card replaying the CPU's routing, greedy tokens equal above
   the CPU's top-2 margin) and one Mamba layer at published width in bf16
   (``mamba_mixer`` at B = 2, S = 256 and 8 ``mamba_decode`` steps within
   0.05); (e) one superblock (8 layers, 13.3 B parameters) trained with
   Adafactor and ``remat="full"`` at B = 1, S = 2048, one warm-up and three
   timed steps (CUDA events) against ``lm_train_bound``, tokens/s, peak
   memory; one ``reduced()`` f32 step against the CPU's within 1e-5 (loss,
   grad_norm) and 1e-4 (each Adafactor factor);
21. LMs served and trained over a mesh of ranks, and the dry run
   (``lms_over_ranks``),
   no kernel on its path. The models are laid out as the reference's rules
   place them (every leaf, batch and cache the rank's block: ZeRO-3
   ``wembed`` over data, ``heads`` / ``mlp`` / ``vocab`` / ``experts``
   over model, the cache's slots over model). The ranks are spawned first
   as in phase 15 (gloo on one card, NCCL with a card a rank) and take
   their inputs from a queue once the parent has them, so that their
   start overlaps the single-device runs (prefill of the whole batch and
   of each data shard's rows, decode steps, routing kept), the dry run's
   collective census of each rank's cell at the same depth, batch and
   mesh, and the training references: (a) ``qwen2-moe-a2.7b`` at its published
   widths cut to 4 layers (bf16, seeded weights) on four ranks ``(data=2,
   model=2)``: ``prefill_step`` at B = 8, S = 2048 (``moe_ffn_sharded``),
   each rank's logits within 5e-2 of the single-device prefill of its data
   shard's rows alone (the same capacity), routing replayed, then 8 decode
   steps into 2,048 slots against the single-device decode of the whole
   batch; (b) the same model on two ranks ``(1, 2)`` (the first two of the
   same spawn; the others wait), against the single-device prefill of the
   whole batch; (c) ``deepseek-v3-671b`` at
   its published widths cut to 4 layers (one MoE layer of 256 experts, 128
   a rank) on ``(1, 2)``, prefill at B = 1, S = 2048; (d) every rank's
   census of its prefill and of each decode step equal to the dry run's,
   integer for integer; printed: prefill and decode ms per mesh beside the
   single-device runs' (CUDA events), the collectives' share of a prefill
   (host clock), peak memory per rank; (e) the dry run at full width on
   the 256-GPU mesh (``data=32,model=8``) of qwen2-moe's and deepseek-v3's
   ``prefill_32k`` and ``decode_32k``, jamba's ``decode_32k`` and
   ``long_500k``, qwen2-moe's ``train_4k`` and ``wisk serve``, in two
   processes of their own from the phase's start, printing each cell's
   ``fits`` and its three roofline terms. Then, in the same spawn, training
   over the ranks (``ranks_train_refs`` before it, on one device): (f)
   qwen2-moe at published widths cut to 2 layers (bf16, AdamW,
   ``remat="full"``) on ``(2, 2)``, two ``train_step``s at B = 4, S =
   512 on the ``TokenPipeline`` of seed 0, step 1 within phase 17(b)'s
   bounds of one device stepping each data shard's rows alone (routing
   replayed); each step's ms (CUDA events; the host clock of the slowest
   rank), the collectives' share, peak memory a rank, every whole leaf
   bit-identical on every rank after every step; (g) deepseek-v3 at
   ``reduced()`` (f32, Adafactor, the MTP block) on ``(2, 2)``, one step
   within 1e-5 (loss, grad_norm) and 1e-4 (each factor) of the same kind
   of single-device step; (h) (g)'s state checkpointed (whole leaves) and
   restored on ``plan_remesh(2).make_mesh()``'s ``(1, 2)`` of the first
   two ranks, one more step within (g)'s bounds of one device's step from
   the same checkpoint (run by the last rank, one the plan leaves out); (i)
   every rank's census of (f)'s and (g)'s steps equal to the dry run's
   ``train`` cell at the same depth, batch and mesh;
22. prints the kernels' JSON line, then the result line.

Every phase prints its seconds. Any failure raises and exits non-zero.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import queue
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PROFILE = "osm"  # W = 256 words, vocabulary 8192: the largest profile
N_OBJECTS = 1_000_000
LEAF_SIZE = 128
FANOUT = 8
N_QUERIES = 4096
BATCH = 1024
MAX_LEAVES = 32
N_ORACLE = 256
K = 10  # neighbours per kNN query on the main path
N_INSERT = 10_000  # per delta log: 1 % of N_OBJECTS
INSERT_BATCH = 1_000
N_DELETE = 5_000  # per delta log, of which
N_DELETE_BUFFERED = 100  # are buffered inserts
K_EDGES = (1, 100)  # one batch each, checked against the host oracle
N_SUBS = 100_000  # standing subscriptions
N_SUB_CHURN = 10_000  # leave after the fifth arrival batch, then as many join
N_SUB_SAMPLE = 256  # subscriptions held against the host oracle
CDF_HIDDEN = 16
CDF_HIGH_FRAC = 0.001  # keywords at or above this share of objects get an MLP (x and y)
N_TRAIN = 4096  # construction: training queries (MIX, seed 3; the served workload is seed 1)
N_TWIN = 120_000  # construction: the twin builds at the osm profile's own size
# the live front door, on the construction phase's learned index: batches of
# 256 (at OBJ = 32,768 the dense ids of a batch are (M, 32 * 32,768) int32)
LIVE_BATCH = 256
N_LIVE_SAME = 4  # same-distribution (MIX) batches after the monitor's warm-up batch
LIVE_SHIFTS = ("UNI", "GAU", "LAP")  # tried in turn until the monitor trips
N_SHIFT_BATCHES = 4  # per shifted distribution at most
N_POST_INSERT = 2_000  # inserts after the swap
N_POST_BATCHES = 2  # post-swap batches: the first re-arms the monitor (48 < 256 queries)
LIVE_THRESHOLD = 1.3  # DriftConfig of the JAX package's LiveIndex tests
LIVE_MIN_QUERIES = 48
CDF_ATOL = 2e-6
SEED = 0
DEVICE = "cuda:0"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    yield
    log(f"[phase {name}: {time.perf_counter() - t:.3f} s]")


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the port's CUDA kernels, as torch.profiler names their device events
KERNEL_FUNCTIONS = ("cdf_mlp_kernel", "frontier_level_kernel", "fused_verify_slot_kernel",
                    "fused_verify_tile_kernel", "fused_verify_wide_slot_kernel",
                    "fused_verify_wide_tile_kernel", "knn_level_kernel", "skr_filter_kernel",
                    "slot_verify_kernel", "sub_match_kernel")


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 10):
    """``(ms, launches)``: the mean device time of one launch of the port's
    CUDA kernels (``KERNEL_FUNCTIONS``; no copy, fill or PyTorch kernel)
    that ``fn`` makes, and their launches the profiler saw per call, from
    ``torch.profiler``. Unlike ``time_ms`` it does not count the host's time
    between launches, which bounds back-to-back calls of a kernel shorter
    than its wrapper. The profiler drops some kernel events of a short
    window (in one run of the H100 smoke, 61 % of them over five windows),
    so the mean is per launch seen, over up to ``tries`` windows until half
    the calls' launches were seen; it raises if they never were. ``tools/serve_ab.py`` times its kernels with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    total_us = seen = 0
    for t in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and any(f"{k}(" in e.key or f"{k}<" in e.key for k in KERNEL_FUNCTIONS)]
        total_us += sum(e.self_device_time_total for e in ours)
        seen += sum(e.count for e in ours)
        if seen >= t * iters // 2:
            return total_us / 1e3 / seen, seen / (t * iters)
    raise RuntimeError(f"the profiler saw {seen} kernel launches in {tries * iters} calls")


def kernel_ms(fn):
    """``(ms, note)``: ``fn``'s kernel time a launch on the device
    (``device_ms``), and a note with it and the wrapper's time a call back
    to back."""
    call = time_ms(fn)
    dev, seen = device_ms(fn)
    return dev, (f"{dev:.6f} ms on the device a launch ({seen:g} launches seen a call), wrapper "
                 f"{call:.6f} ms per call back to back")


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def max_abs_err(a, b) -> float:
    """Largest difference; equal infinities and two NaNs differ by 0, a NaN
    against a number by NaN."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if not a.numel():
        return 0.0
    diff = (a.double() - b.double()).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, diff).max())


def assert_same(got, want, what: str, atol: float = 0.0) -> None:
    """Kernel output equal to the plain version's: bit for bit, or within
    ``atol`` where one is given; a NaN equals a NaN."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")
        if g.is_floating_point():
            same = bool(torch.allclose(g, w, atol=atol, rtol=0, equal_nan=True))
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")


def shapes(case):
    """The shapes of a kernel's operands (a dict of weights counts as one, a
    tuple of tensors as a list of shapes, a flag as itself)."""
    return [{k: tuple(v.shape) for k, v in a.items()} if isinstance(a, dict)
            else shapes(a) if isinstance(a, tuple)
            else tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in case]


# ------------------------------------------------------------------ bounds
# Both bounds count what these operands need, each byte once: a dense plane
# the result depends on everywhere is read whole, a gathered or conditional
# one only where the data makes the result depend on it. A word scan that
# finds a hit needs one word (the hit proves it); one that finds none needs
# the words where the query's word is nonzero, since no other word can hit.
def needed_words(hit_words, live, q_nonzero):
    """(..., W) mask of the words that decide ``any(hit_words)`` where
    ``live``: the first hit word where there is one, else the words where
    ``q_nonzero`` (a mask broadcast to ``hit_words``: the query's word is
    nonzero) holds."""
    W = hit_words.shape[-1]
    first = hit_words.to(torch.uint8).argmax(-1, keepdim=True)
    first = torch.arange(W, device=hit_words.device) == first
    return live[..., None] & torch.where(hit_words.any(-1, keepdim=True), first, q_nonzero)


def slot_bound(args, narrow: bool, chunk: int = 32):
    """Bytes and operations of ``frontier_level`` (or, ``narrow``,
    ``frontier_level_narrow``): every frontier id in and every flag out; of
    a valid slot, its node's MBR -- 16 bytes, or 8 bytes of codes and the
    distinct dictionary entries they read -- each node once, however many
    queries need it; of a slot whose MBR also meets the query's rectangle,
    the node words that decide its keyword test (each node word once); the
    rectangles of queries with a valid slot; and the W words of each query
    with a slot that meets, which the kernel reads whole to find its nonzero
    words. Counted ``chunk`` queries at a time, so the (M, F, W) hit plane
    never exists whole."""
    if narrow:
        q_rects, q_bm, codes, bms, frontier, dict_x, dict_y = args
        c = codes.long()
        cx = c[:, 0::2].clamp(0, dict_x.numel() - 1)
        cy = c[:, 1::2].clamp(0, dict_y.numel() - 1)
        x, y = dict_x[cx], dict_y[cy]  # (N, 2): lo, hi
    else:
        q_rects, q_bm, mbrs, bms, frontier = args
        x, y = mbrs[:, 0::2], mbrs[:, 1::2]
    M, F = frontier.shape
    N, W = bms.shape
    valid = frontier >= 0
    node = frontier.long().clamp(0, N - 1)
    qr = q_rects[:, None, :]
    nx, ny = x[node], y[node]  # (M, F, 2)
    meet = (valid & (qr[..., 0] <= nx[..., 1]) & (nx[..., 0] <= qr[..., 2])
            & (qr[..., 1] <= ny[..., 1]) & (ny[..., 0] <= qr[..., 3]))
    node_words = torch.zeros(N * W, dtype=torch.bool, device=bms.device)
    n_need = 0
    cols = torch.arange(W, device=bms.device)
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        qb = q_bm[sl, None, :]
        need = needed_words((bms[node[sl]] & qb) != 0, meet[sl], qb != 0)  # (c, F, W)
        node_words[(node[sl, :, None] * W + cols)[need]] = True
        n_need += int(need.sum())
    mbr_nodes = torch.unique(node[valid])
    if narrow:
        mbr_bytes = (mbr_nodes.numel() * 8 + torch.unique(cx[mbr_nodes]).numel() * 4
                     + torch.unique(cy[mbr_nodes]).numel() * 4)
    else:
        mbr_bytes = mbr_nodes.numel() * 16
    nbytes = (M * F * 4  # frontier
              + int(valid.any(1).sum()) * 16  # rectangles of queries with a valid slot
              + mbr_bytes  # MBRs (codes and dictionary entries) of valid slots' nodes
              + int(meet.any(1).sum()) * W * 4  # query words, read whole to compact them
              + int(node_words.sum()) * 4  # node words
              + M * F)  # out
    ops = M * F + int(valid.sum()) * 4 + n_need * 2  # id test, 4 compares, AND+test
    return nbytes, ops


def level_bound(args, narrow: bool = False):
    """Bytes and operations of ``knn_level_dist`` (or, ``narrow``,
    ``knn_level_dist_narrow``): every frontier id in and every distance
    out; of a valid slot, the node words at the query's packed words that
    decide its keyword test (each node word once, however many queries need
    it), and the node's MBR where it hits -- 16 bytes, or 8 bytes of codes
    and the distinct dictionary entries they read; query points and (id,
    value) word pairs where some slot needs them."""
    if narrow:
        q_pts, wids, bits, codes, bms, frontier, dict_x, dict_y = args
    else:
        q_pts, wids, bits, mbrs, bms, frontier = args
    M, F = frontier.shape
    N, W = bms.shape
    valid = frontier >= 0
    node = frontier.long().clamp(0, N - 1)
    word = node[..., None] * W + wids.long()[:, None, :]  # (M, F, Wp)
    hits = (bms.reshape(-1)[word] & bits[:, None, :]) != 0
    need = needed_words(hits, valid, (bits != 0)[:, None, :])
    hit = valid & hits.any(-1)
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    hit_nodes = torch.unique(node[hit])
    if narrow:
        c = codes[hit_nodes].long()
        mbr_bytes = (hit_nodes.numel() * 8
                     + distinct(c[:, 0::2].clamp(0, dict_x.numel() - 1)) * 4
                     + distinct(c[:, 1::2].clamp(0, dict_y.numel() - 1)) * 4)
    else:
        mbr_bytes = hit_nodes.numel() * 16
    nbytes = (int(hit.any(1).sum()) * 8  # points of queries with a hit
              + int(need.any(1).sum()) * 8  # word pairs some slot needs
              + M * F * 4  # frontier
              + mbr_bytes  # MBRs (codes and dictionary entries) of nodes that hit
              + distinct(word[need]) * 4  # node words
              + M * F * 4)  # out
    ops = M * F + int(hit.sum()) * 11 + int(need.sum()) * 2  # id test, MBR math, AND+test
    return nbytes, ops


def fused_bound(args, query_bytes=None):
    """Leaf ids and flags in, ids and counts out for every (query, slot);
    of the selected leaf rows (each bank element once): object ids of leaves
    some valid slot selects, signatures of live objects, compact words that
    decide a signature-passing object, coordinates of keyword hits; the
    query words some object needs and ``q_sig`` of slots with a live object,
    or ``query_bytes`` in their place (``fused_remap_bound``)."""
    q_rects, q_cbm, q_sig, top_leaf, leaf_ok, ox, oy, ocbm, osig, oid = args
    M, T = top_leaf.shape
    K, OBJ = ox.shape
    Wl = ocbm.shape[2]
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = leaf_ok > 0
    obj = leaf[..., None] * OBJ + torch.arange(OBJ, device=leaf.device)  # (M, T, OBJ)
    live = (oid.reshape(-1)[obj] >= 0) & ok[..., None]
    sig = live & ((osig.reshape(-1)[obj] & q_sig[..., None]) != 0)
    hit = (ocbm.reshape(-1, Wl)[obj] & q_cbm[:, :, None, :]) != 0  # (M, T, OBJ, Wl)
    need = needed_words(hit, sig, (q_cbm != 0)[:, :, None, :])
    kw = sig & hit.any(-1)
    word = obj[..., None] * Wl + torch.arange(Wl, device=leaf.device)
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    if query_bytes is None:
        query_bytes = (int(need.any(2).sum()) * 4  # query words some object needs
                       + int(live.any(-1).sum()) * 4)  # q_sig of slots with a live object
    nbytes = (int(kw.any(-1).any(-1).sum()) * 16  # rects of queries with a hit
              + query_bytes
              + M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(leaf[ok]) * OBJ * 4  # obj_id of the selected rows
              + distinct(obj[live]) * 4  # obj_sig
              + distinct(word[need]) * 4  # obj_cbm
              + distinct(obj[kw]) * 8  # obj_x, obj_y
              + M * T * OBJ * 4 + M * T * 4)  # ids and kwv written once
    ops = (int(ok.sum()) * OBJ + int(live.sum()) * 2  # id test, sig AND+test
           + int(need.sum()) * 2 + int(kw.sum()) * 4)  # word AND+test, 4 compares
    return nbytes, ops


def fused_remap_bound(args, remap):
    """``fused_bound`` of the remapping entry (operands ``q_rects, q_bm,
    leaf_terms, top_leaf, leaf_ok`` and the bank, then the ``words`` flag),
    each byte once: no ``q_cbm``/``q_sig`` read; the ``leaf_terms`` rows of
    the distinct leaves that live slots (``leaf_ok > 0``) select, and the
    distinct (query, word) pairs of ``q_bm`` those rows name at live slots;
    with ``words`` the remapped words of every slot written out; the rest as
    ``fused_bound`` counts it on the words ``remap`` (the plain remap)
    gives."""
    q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, *bank, words = args
    M, W = q_bm.shape
    K, L = leaf_terms.shape
    q_cbm, q_sig = remap(q_bm, leaf_terms, top_leaf)
    ok = leaf_ok > 0
    leaf = top_leaf.long().clamp(0, K - 1)
    terms = leaf_terms[leaf[ok]]  # (live slots, L)
    widx = terms.clamp(0, 32 * W - 1) >> 5
    qrow = torch.arange(M, device=leaf.device)[:, None].expand(M, top_leaf.shape[1])[ok]
    named = (qrow[:, None] * W + widx)[terms >= 0]
    query_bytes = (torch.unique(leaf[ok]).numel() * L * 4  # dictionary rows
                   + torch.unique(named).numel() * 4)  # query words they name
    nbytes, ops = fused_bound((q_rects, q_cbm, q_sig, top_leaf, leaf_ok, *bank), query_bytes)
    if words:
        nbytes += q_cbm.numel() * 4 + q_sig.numel() * 4
    return nbytes, ops + int((terms >= 0).sum()) * 3  # clamp, shift, and per named bit


def fused_wide_bound(args, chunk: int = 32):
    """``fused_bound`` on the full-width bank: object ids of the selected
    rows, the words that decide each live object's keyword test (each bank
    word once, however many queries need it), coordinates of keyword hits,
    and the query words some object needs. Counted ``chunk`` queries at a
    time, so the (M, T, OBJ, W) hit plane never exists whole."""
    q_rects, q_bm, top_leaf, leaf_ok, ox, oy, obm, oid = args
    M, T = top_leaf.shape
    K, OBJ = ox.shape
    W = q_bm.shape[1]
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = leaf_ok > 0
    obj = leaf[..., None] * OBJ + torch.arange(OBJ, device=leaf.device)  # (M, T, OBJ)
    live = (oid.reshape(-1)[obj] >= 0) & ok[..., None]
    bank_words = torch.zeros((K * OBJ, W), dtype=torch.int32, device=leaf.device)
    kw = torch.zeros_like(live)
    q_need = n_need = 0
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        hit = (obm.reshape(-1, W)[obj[sl]] & q_bm[sl, None, None, :]) != 0
        need = needed_words(hit, live[sl], (q_bm[sl] != 0)[:, None, None, :])
        kw[sl] = live[sl] & hit.any(-1)
        bank_words.index_put_((obj[sl].reshape(-1),), need.reshape(-1, W).to(torch.int32),
                              accumulate=True)
        q_need += int(need.any(2).any(1).sum())
        n_need += int(need.sum())
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    nbytes = (int(kw.any(-1).any(-1).sum()) * 16  # rects of queries with a hit
              + q_need * 4  # query words some object needs
              + M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(leaf[ok]) * OBJ * 4  # obj_id of the selected rows
              + int((bank_words > 0).sum()) * 4  # obj_bm
              + distinct(obj[kw]) * 8  # obj_x, obj_y
              + M * T * OBJ * 4 + M * T * 4)  # ids and kwv written once
    ops = int(ok.sum()) * OBJ + n_need * 2 + int(kw.sum()) * 4
    return nbytes, ops


def verify_bound(args, compact: bool):
    """Bytes and operations of an unfused verify (``verify_candidates``, or
    ``verify_candidates_compact``) of gathered candidates: every validity
    flag in and every flag out; of a valid candidate, its signature
    (compact), its coordinates where the signature passes, and the words
    that decide its keyword test where it also lies in the rectangle; query
    rectangles, signatures and words where some candidate needs them. The
    counted entries (``verify_candidates_counted``, ``..._compact_counted``:
    a last operand of ids, -1 where invalid) read and write 4-byte ids for
    the flags and write the two per-query counts besides."""
    counted = args[-1].dtype == torch.int32
    if compact:
        q_rects, q_cbm, q_sig, cx, cy, cbm, csig, cval = args
        T = q_sig.shape[1]
        obj = cx.shape[1] // T
        q_words = q_cbm.repeat_interleave(obj, dim=1)
    else:
        q_rects, q_bm, cx, cy, cbm, cval = args
        q_words = q_bm[:, None, :]
    M, C = cx.shape
    valid = cval >= 0 if counted else cval > 0
    coords = valid & ((csig & q_sig.repeat_interleave(obj, dim=1)) != 0) if compact else valid
    live = coords & ((cx >= q_rects[:, 0:1]) & (cx <= q_rects[:, 2:3])
                     & (cy >= q_rects[:, 1:2]) & (cy <= q_rects[:, 3:4]))
    need = needed_words((cbm & q_words) != 0, live, q_words != 0)  # (M, C, W)
    if compact:
        q_need = int(need.reshape(M, T, obj, -1).any(2).sum())
        sig_bytes = int(valid.sum()) * 4 + int(valid.reshape(M, T, obj).any(2).sum()) * 4
    else:
        q_need, sig_bytes = int(need.any(1).sum()), 0
    flag = 4 if counted else 1
    nbytes = (M * C * flag  # cand_valid, or the ids
              + sig_bytes  # cand_sig of valid candidates, q_sig of their slots
              + int(coords.sum()) * 8  # cand_x, cand_y
              + int(need.sum()) * 4  # candidate words
              + int(coords.any(1).sum()) * 16  # rects of queries that need them
              + q_need * 4  # query words some candidate needs
              + M * C * flag + (M * 8 if counted else 0))  # out
    ops = M * C + int(valid.sum()) * (2 if compact else 0) + int(coords.sum()) * 4 \
        + int(need.sum()) * 2
    return nbytes, ops


def slot_verify_bound(args, compact: bool, chunk: int = 32):
    """Bytes and operations of a slot verify (``verify_slots``, or
    ``compact``, ``verify_slots_compact``) that reads the slot bank itself:
    every (query, slot) leaf id and flag in; the id of each slot of a
    selected leaf (each bank slot once, however many queries select it); of
    a valid slot, its signature (compact) and the words that decide its
    keyword test (each bank word once); the coordinates of keyword hits;
    the rectangles of queries with a keyword hit; the query words: compact,
    the per-slot words some slot needs and the signatures of (query, slot)
    pairs with a valid slot; full width, the W words of each query with a
    valid slot, which the kernel reads whole to compact them; the ids and
    both counts out. Counted ``chunk`` queries at a time, so the
    (M, T, B, W) hit plane never exists whole."""
    if compact:
        q_rects, q_words, q_sig, top_leaf, leaf_ok, x, y, words, sig, sid = args
    else:
        q_rects, q_words, top_leaf, leaf_ok, x, y, words, sid = args
    M, T = top_leaf.shape
    K, B = sid.shape
    W = words.shape[2]
    dev = sid.device
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = (leaf_ok > 0)[..., None].expand(M, T, B)
    slot = leaf[..., None] * B + torch.arange(B, device=dev)  # (M, T, B)
    valid = ok & (sid.reshape(-1)[slot] >= 0)
    live = valid & ((sig.reshape(-1)[slot] & q_sig[..., None]) != 0) if compact else valid
    bank_words = torch.zeros(K * B * W, dtype=torch.bool, device=dev)
    kw = torch.zeros_like(valid)
    cols = torch.arange(W, device=dev)
    q_need = n_need = 0
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        qw = q_words[sl][:, :, None, :] if compact else q_words[sl][:, None, None, :]
        hit = (words.reshape(-1, W)[slot[sl]] & qw) != 0  # (c, T, B, W)
        need = needed_words(hit, live[sl], qw != 0)
        kw[sl] = live[sl] & hit.any(-1)
        bank_words[(slot[sl][..., None] * W + cols)[need]] = True
        q_need += int(need.any(2).sum())
        n_need += int(need.sum())
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    if compact:  # per-slot query words some slot needs, q_sig of pairs with a valid slot
        q_bytes = q_need * 4 + int(valid.any(-1).sum()) * 4
        sig_bytes = distinct(slot[valid]) * 4
    else:  # the W words of each query with a valid slot, read whole
        q_bytes, sig_bytes = int(valid.any(-1).any(-1).sum()) * W * 4, 0
    nbytes = (M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(slot[ok]) * 4  # ids of the selected leaves' slots
              + sig_bytes  # slot signatures of valid slots
              + int(bank_words.sum()) * 4  # slot words
              + distinct(slot[kw]) * 8  # coordinates of keyword hits
              + int(kw.any(-1).any(-1).sum()) * 16  # rectangles of queries with a hit
              + q_bytes
              + M * T * B * 4 + M * 8)  # ids, n_match and n_kw written once
    ops = (int(ok.sum()) + int(valid.sum()) * (2 if compact else 0)  # id test, sig AND+test
           + n_need * 2 + int(kw.sum()) * 4)  # word AND+test, 4 compares
    return nbytes, ops


def filter_bound(args, chunk: int = 32):
    """Bytes and operations of the dense filter (``skr_filter``): every
    query rectangle and node MBR in and every flag out; the words that
    decide a pair whose rectangles meet (each node word once, however many
    queries need it) and the query words some pair needs. Counted ``chunk``
    queries at a time, so the (M, K, W) hit plane never exists whole."""
    q_rects, q_bm, n_mbrs, n_bm = args
    M, W = q_bm.shape
    K = n_mbrs.shape[0]
    node_words = torch.zeros((K, W), dtype=torch.bool, device=q_bm.device)
    q_need = n_need = n_meet = 0
    for m0 in range(0, M, chunk):
        qr = q_rects[m0:m0 + chunk, None, :]
        meet = ((qr[..., 0] <= n_mbrs[:, 2]) & (n_mbrs[:, 0] <= qr[..., 2])
                & (qr[..., 1] <= n_mbrs[:, 3]) & (n_mbrs[:, 1] <= qr[..., 3]))  # (c, K)
        qb = q_bm[m0:m0 + chunk, None, :]
        need = needed_words((qb & n_bm) != 0, meet, qb != 0)  # (c, K, W)
        node_words |= need.any(0)
        q_need += int(need.any(1).sum())
        n_need += int(need.sum())
        n_meet += int(meet.sum())
    nbytes = M * 16 + K * 16 + q_need * 4 + int(node_words.sum()) * 4 + M * K
    ops = M * K * 4 + n_need * 2
    return nbytes, ops


def sub_bound(args, chunk: int = 16):
    """Bytes and operations of ``sub_match``: every object point and
    subscription rectangle in; the signatures of objects and subscriptions
    with a pair inside the rectangle; of the pairs that also pass the
    signature test, the object words (id and value) and the subscription
    words (each once) that decide them; and the output. The matrix
    instance's 7 packed operands write the (N, S) flags; the pairs
    instance's 5 full-width ones (objects' words counted as their packed
    nonzero words and folded signature) write 8 B per matching pair.
    Operations: the points sorted by x and each rectangle's span found in
    them (log2 N compares each), the x test of the pairs whose x lies in
    the span, and the y, signature and word tests that this data needs."""
    if len(args) == 5:
        from repro_torch.kernels.ref import nonzero_words, or_fold

        o_pts, o_bm, s_rects, s_bm, s_sig = args
        (o_wids, o_bits), o_sig = nonzero_words(o_bm), or_fold(o_bm)
    else:
        o_pts, o_wids, o_bits, o_sig, s_rects, s_bm, s_sig = args
    N, Wp = o_wids.shape
    S, W = s_bm.shape
    sub_words = torch.zeros(S * W, dtype=torch.bool, device=s_bm.device)
    s_in = torch.zeros(S, dtype=torch.bool, device=s_bm.device)
    o_in = o_need = n_need = n_in = n_match = n_x = 0
    s_cols = torch.arange(S, device=s_bm.device)[None, :, None] * W
    for n0 in range(0, N, chunk):
        x, y = o_pts[n0:n0 + chunk, 0:1], o_pts[n0:n0 + chunk, 1:2]
        in_x = (x >= s_rects[:, 0]) & (x <= s_rects[:, 2])
        inr = in_x & (y >= s_rects[:, 1]) & (y <= s_rects[:, 3])
        live = inr & ((o_sig[n0:n0 + chunk, None] & s_sig[None, :]) != 0)  # (c, S)
        wid = o_wids[n0:n0 + chunk].long()  # (c, Wp)
        g = s_bm.t()[wid]  # (c, Wp, S)
        hits = ((g & o_bits[n0:n0 + chunk, :, None]) != 0).transpose(1, 2)  # (c, S, Wp)
        need = needed_words(hits, live, (o_bits[n0:n0 + chunk] != 0)[:, None, :])
        sub_words[(s_cols + wid[:, None, :])[need]] = True
        s_in |= inr.any(0)
        o_in += int(inr.any(1).sum())
        o_need += int(need.any(1).sum())
        n_need += int(need.sum())
        n_in += int(inr.sum())
        n_match += int((live & hits.any(-1)).sum())
        n_x += int(in_x.sum())
    out = n_match * 8 if len(args) == 5 else N * S
    nbytes = (N * 8 + S * 16  # points, rectangles
              + o_in * 4 + int(s_in.sum()) * 4  # signatures where a pair is in the rectangle
              + o_need * 8  # object words (id, value) some pair needs
              + int(sub_words.sum()) * 4  # subscription words
              + out)  # flags, or 8 B a matching pair
    log_n = max(N - 1, 1).bit_length()
    ops = (N + S) * log_n + n_x * 4 + n_in * 2 + n_need * 2
    return nbytes, ops


def cdf_bound(args):
    """Bytes (the points and the weights in, the (N, B) CDF plane out) and
    flops (2 N B (H + 2 H^2 + H)) of the CDF-MLP bank."""
    params, x = args
    B, _, H = params["w0"].shape
    N = x.shape[0]
    nbytes = N * 4 + sum(t.numel() for t in params.values()) * 4 + N * B * 4
    return nbytes, 2 * N * B * (H + 2 * H * H + H)


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(label: str, serve_one, warm, plan_cache_cls) -> None:
    """Where one warm batch's time goes: ``profile_call`` over a single
    serving call at the learned widths of ``warm``."""
    cache = plan_cache_cls()
    cache.widths = dict(warm.widths)
    profile_call(f"{label} batch", lambda: serve_one(cache))


def profile_call(label: str, fn) -> float:
    """``torch.profiler`` over one call of ``fn``: device time by operation
    against the host clock. Returns the device's idle share in percent."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # device-side events only (kernels and copies): the operator events that
    # launched them carry the same time again
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    busy_ms = sum(dev(e) for e in on_device)
    copy_ms = sum(dev(e) for e in on_device if e.key.startswith(("Memcpy", "Memset")))
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    idle = 100 - 100 * busy_ms / wall_ms
    log(f"profile of one {label} (profiler on): wall {wall_ms:.6f} ms, device busy "
        f"{busy_ms:.6f} ms ({100 * busy_ms / wall_ms:.3f} %), "
        f"device idle {idle:.3f} %, "
        f"{sum(e.count for e in on_device)} device events, "
        f"{sum(e.count for e in host if e.key.startswith('aten::'))} host aten calls; copies "
        f"and sets {copy_ms:.6f} ms, other device work {busy_ms - copy_ms:.6f} ms")
    for e in sorted(on_device, key=dev, reverse=True)[:8]:
        log(f"  device {dev(e):.6f} ms x{e.count}: {e.key[:100]}")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host {e.self_cpu_time_total / 1e3:.6f} ms x{e.count}: {e.key[:100]}")
    return idle


# --------------------------------------------------------- ragged operands
def _words(g, *shape):
    return (g.integers(0, 2 ** 32, shape, dtype=np.uint32)
            * g.integers(0, 2, shape, dtype=np.uint32)).view(np.int32)


def ragged_slots(dev, narrow: bool, knn: bool, M=37, F=131, W=3, D=61, seed=5):
    """Operands of a frontier (``knn=False``: query rectangles) or kNN
    filter (query points) at ragged shapes: int16 rank codes into two sorted
    dictionaries (``narrow``) or the f32 MBRs they decode to, sparse random
    words, random validity and an all-invalid last row."""
    g = np.random.default_rng(seed)
    dx = np.sort(g.uniform(0, 1, D)).astype(np.float32)
    dy = np.sort(g.uniform(0, 1, D)).astype(np.float32)
    lo = g.integers(0, D, (M, F, 2))
    hi = np.minimum(lo + g.integers(0, 8, (M, F, 2)), D - 1)
    codes = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], -1).astype(np.int16)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    valid = g.integers(0, 2, (M, F)).astype(np.int8)
    if M > 1:
        valid[-1] = 0
    q = g.uniform(0, 1, (M, 2)).astype(np.float32) if knn else rects
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    qw, fw = t(_words(g, M, W)), t(_words(g, M, F, W))
    if narrow:
        return (t(q), qw, t(codes), fw, t(valid), t(dx), t(dy))
    mbrs = np.stack([dx[codes[..., 0]], dy[codes[..., 1]], dx[codes[..., 2]], dy[codes[..., 3]]], -1)
    return (t(q), qw, t(mbrs), fw, t(valid))


def ragged_fused(dev, M=13, T=5, K=11, OBJ=37, Wl=2, seed=7, W=None):
    """Compact fused-verify operands at ragged shapes: dirty leaf ids,
    ``leaf_ok = 0`` slots, -1 id pads. Without ``W``, the given-words form
    (random ``q_cbm`` and its OR-fold ``q_sig``); with ``W``, the remapping
    entry's ``(q_bm, leaf_terms)`` form followed by ``words=True``: leaf
    dictionaries of even term ids, a quarter ``-1`` pads, a tenth past bit
    32*W - 1 (the remap clamps them) and an all-``-1`` last one; a first
    query whose bits are odd term ids, in no dictionary (``q_sig == 0`` in
    every slot), an all-ones second one, and a last of ``leaf_ok = 0``
    slots only."""
    g = np.random.default_rng(seed)
    words = lambda *s: _words(g, *s)  # noqa: E731
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    cbm = words(K, OBJ, Wl)
    sig = np.bitwise_or.reduce(cbm.view(np.uint32), axis=-1).view(np.int32)
    oid = np.where(g.integers(0, 4, (K, OBJ)) > 0, g.integers(0, 10_000, (K, OBJ)), -1)
    leaf_ok = g.integers(0, 2, (M, T)).astype(np.int8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if W is None:
        q_cbm = words(M, T, Wl)
        q_sig = np.bitwise_or.reduce(q_cbm.view(np.uint32), axis=-1).view(np.int32)
        query = (t(q_cbm), t(q_sig))
    else:
        nbits = 32 * W
        terms = 2 * g.integers(0, max(nbits // 2, 1), (K, 32 * Wl))
        clamped = g.integers(0, 10, terms.shape) == 0  # entries past the bitmap's bits
        terms = np.where(clamped, nbits + g.integers(0, 64, terms.shape), terms)
        terms = np.where(g.integers(0, 4, terms.shape) == 0, -1, terms)
        q_bm = words(M, W).view(np.uint32)
        if K > 1:
            terms[-1] = -1
        if M > 1:
            odd = np.arange(1, nbits - 1, 2)
            q_bm[0] = 0
            np.bitwise_or.at(q_bm[0], odd >> 5, np.uint32(1) << (odd & 31).astype(np.uint32))
            leaf_ok[-1] = 0
        if M > 2:
            q_bm[1] = np.uint32(0xFFFFFFFF)
        query = (t(q_bm.view(np.int32)), t(terms.astype(np.int32)))
    bank = (t(g.integers(-2, K + 3, (M, T)).astype(np.int32)), t(leaf_ok),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(cbm), t(sig), t(oid.astype(np.int32)))
    return (t(rects), *query, *bank) + (() if W is None else (True,))


def _terms(g, n, W, pool, lo, hi):
    """(n, W) u32 bitmaps of ``lo`` to ``hi - 1`` terms each from ``pool``."""
    bm = np.zeros((n, W), np.uint32)
    for r in range(n):
        picks = g.choice(pool, size=min(int(g.integers(lo, hi)), pool.size), replace=False)
        np.bitwise_or.at(bm[r], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32))
    return bm


def _query_words(g, ops, M, W, pool, sparse):
    """Query bitmaps -- dense random words (Wp = W at small W), or up to
    three pool terms each (Wp below W at wide W) -- the first query with no
    nonzero word, and their packing as int32 tensors' arrays."""
    q_bm = _words(g, M, W).view(np.uint32) if not sparse else _terms(g, M, W, pool, 1, 4)
    if M > 1:
        q_bm[0] = 0
    wids, bits = ops.pack_query_words(q_bm)
    return q_bm.view(np.int32), wids, bits.view(np.int32)


def ragged_fused_wide(dev, ops, M=13, T=5, K=11, OBJ=37, W=3, sparse=False, seed=7):
    """Full-width fused-verify operands at ragged shapes, and the queries'
    packed words as a last ``(wids, bits)`` operand: dirty leaf ids, invalid
    slots, -1 id pads, a ``NEVER_RECT`` query and one with no nonzero word
    (with sparse queries, the bank's objects share their term pool)."""
    g = np.random.default_rng(seed)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    if M > 1:
        rects[-1] = ops.NEVER_RECT
    oid = np.where(g.integers(0, 4, (K, OBJ)) > 0, g.integers(0, 10_000, (K, OBJ)), -1)
    pool = g.choice(32 * W, size=min(32 * W, 24), replace=False)
    q_bm, wids, bits = _query_words(g, ops, M, W, pool, sparse)
    obj_bm = (_terms(g, K * OBJ, W, pool, 0, 5).reshape(K, OBJ, W).view(np.int32) if sparse
              else _words(g, K, OBJ, W))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(rects), t(q_bm), t(g.integers(-2, K + 3, (M, T)).astype(np.int32)),
            t(g.integers(0, 2, (M, T)).astype(np.int8)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(obj_bm), t(oid.astype(np.int32)), (t(wids), t(bits)))


# query points with NaN or infinite coordinates, None keeping one
NONFINITE_POINTS = [(float("nan"), None), (float("inf"), None), (-float("inf"), -float("inf")),
                    (None, float("nan"))]


def ragged_level(dev, ops, M=37, F=131, N=53, W=3, sparse=False, seed=19, D=None,
                 nonfinite=False):
    """``knn_level_dist`` operands at ragged shapes: one level of N nodes
    with a few pool terms each, an (M, F) frontier with -1 pads, dirty ids
    past N - 1 and a last row of padding only, and packed query words
    (``_query_words``). With ``D``, ``knn_level_dist_narrow``'s: the MBRs
    as int16 rank codes into two sorted dictionaries of D entries, which
    come last. ``nonfinite``: ``NONFINITE_POINTS`` over the first query
    points (a NaN x first)."""
    g = np.random.default_rng(seed)
    pool = g.choice(32 * W, size=min(32 * W, 48), replace=False)
    _, wids, bits = _query_words(g, ops, M, W, pool, sparse)
    lo = g.uniform(0, 1, (N, 2)).astype(np.float32)
    mbrs = np.concatenate([lo, lo + g.uniform(0, 0.3, (N, 2)).astype(np.float32)], 1)
    frontier = g.integers(0, N + 3, (M, F)).astype(np.int32)
    frontier[g.uniform(0, 1, (M, F)) < 0.3] = -1
    if M > 1:
        frontier[-1] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pts, bms = g.uniform(0, 1, (M, 2)).astype(np.float32), _terms(g, N, W, pool, 0, 7)
    for r, pat in enumerate(NONFINITE_POINTS[:M] if nonfinite else []):
        for c, v in enumerate(pat):
            if v is not None:
                pts[r, c] = v
    if D is None:
        return (t(pts), t(wids), t(bits), t(mbrs), t(bms.view(np.int32)), t(frontier))
    dx, dy = (np.sort(g.uniform(0, 1, D)).astype(np.float32) for _ in range(2))
    c_lo = g.integers(0, D, (N, 2))
    c_hi = np.minimum(c_lo + g.integers(0, 8, (N, 2)), D - 1)
    codes = np.stack([c_lo[:, 0], c_lo[:, 1], c_hi[:, 0], c_hi[:, 1]], -1).astype(np.int16)
    return (t(pts), t(wids), t(bits), t(codes), t(bms.view(np.int32)), t(frontier), t(dx),
            t(dy))


def ragged_frontier_level(dev, ops, M=37, F=131, N=53, W=3, sparse=False, seed=31, D=None):
    """``frontier_level`` operands at ragged shapes: query rectangles (the
    second ``NEVER_RECT``, which meets nothing) and bitmaps
    (``_query_words``: the first with no nonzero word), one level of N nodes
    with a few pool terms each, and an (M, F) frontier with -1 pads, dirty
    ids past N - 1 and a last row of padding only. The term pool lies in the
    last 100 words, so past 2,048 words (one compaction round) the nodes'
    terms fall on both sides of a round's edge. With ``D``,
    ``frontier_level_narrow``'s: the MBRs as int16 rank codes into two
    sorted dictionaries of D entries, which come last."""
    g = np.random.default_rng(seed)
    lo_word = max(0, W - 100)
    pool = 32 * lo_word + g.choice(32 * (W - lo_word), size=min(32 * (W - lo_word), 48),
                                   replace=False)
    q_bm, _, _ = _query_words(g, ops, M, W, pool, sparse)
    rects = _rects(g, M)
    rects[:, 2:] += np.float32(0.1)
    if M > 2:
        rects[1] = ops.NEVER_RECT
    frontier = g.integers(0, N + 3, (M, F)).astype(np.int32)
    frontier[g.uniform(0, 1, (M, F)) < 0.3] = -1
    if M > 1:
        frontier[-1] = -1
    bms = _terms(g, N, W, pool, 0, 7).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if D is None:
        lo = g.uniform(0, 1, (N, 2)).astype(np.float32)
        mbrs = np.concatenate([lo, lo + g.uniform(0, 0.3, (N, 2)).astype(np.float32)], 1)
        return (t(rects), t(q_bm), t(mbrs), t(bms), t(frontier))
    dx, dy = (np.sort(g.uniform(0, 1, D)).astype(np.float32) for _ in range(2))
    c_lo = g.integers(0, D, (N, 2))
    c_hi = np.minimum(c_lo + g.integers(0, 8, (N, 2)), D - 1)
    codes = np.stack([c_lo[:, 0], c_lo[:, 1], c_hi[:, 0], c_hi[:, 1]], -1).astype(np.int16)
    return (t(rects), t(q_bm), t(codes), t(bms), t(frontier), t(dx), t(dy))


def ragged_verify(dev, compact: bool, M=13, T=5, OBJ=37, W=3, seed=11):
    """Unfused verify operands at ragged shapes: T slots of OBJ candidates
    (half of them inside their query's rectangle), W (or, compact, Wl)
    words, random validity and an all-invalid last row."""
    g = np.random.default_rng(seed)
    C = T * OBJ
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    inside = g.uniform(0, 1, (2, M, C)).astype(np.float32)
    cx = np.where(inside[0] < 0.5, rects[:, 0:1] + inside[0] * 2 * (rects[:, 2:3] - rects[:, 0:1]),
                  g.uniform(0, 1, (M, C))).astype(np.float32)
    cy = np.where(inside[1] < 0.5, rects[:, 1:2] + inside[1] * 2 * (rects[:, 3:4] - rects[:, 1:2]),
                  g.uniform(0, 1, (M, C))).astype(np.float32)
    valid = g.integers(0, 2, (M, C)).astype(np.int8)
    if M > 1:
        valid[-1] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if not compact:
        return (t(rects), t(_words(g, M, W)), t(cx), t(cy), t(_words(g, M, C, W)), t(valid))
    fold = lambda w: np.bitwise_or.reduce(w.view(np.uint32), axis=-1).view(np.int32)  # noqa: E731
    q_cbm, cbm = _words(g, M, T, W), _words(g, M, C, W)
    return (t(rects), t(q_cbm), t(fold(q_cbm)), t(cx), t(cy), t(cbm), t(fold(cbm)), t(valid))


def ragged_slot_bank(dev, ops, compact, M=13, T=5, K=11, B=8, W=3, seed=41, empty=False):
    """Slot-verify operands at ragged shapes: a bank of K leaves x B slots,
    about a third empty (``empty``: all), points near the query rectangles
    with some exactly on their edges; dirty leaf ids (-2 to past K),
    ``leaf_ok = 0`` slots and an all-zero last row; a first query with no
    nonzero word and a ``NEVER_RECT`` second one. Compact: per-slot query
    words and OR-fold signatures."""
    g = np.random.default_rng(seed)
    rects = _rects(g, M)
    near = rects[g.integers(0, M, K)]  # (K, 4): each leaf's points near one query
    u = g.uniform(0, 1, (2, K, B)).astype(np.float32)
    x = (near[:, 0:1] + u[0] * 2 * (near[:, 2:3] - near[:, 0:1])).astype(np.float32)
    y = (near[:, 1:2] + u[1] * 2 * (near[:, 3:4] - near[:, 1:2])).astype(np.float32)
    on_edge = g.integers(0, 6, (K, B)) == 0
    x = np.where(on_edge, near[:, 2:3], x).astype(np.float32)
    ids = np.where(g.integers(0, 3, (K, B)) > 0, g.integers(0, 10 * K * B, (K, B)), -1)
    if empty:
        ids[:] = -1
    top_leaf = g.integers(-2, K + 3, (M, T)).astype(np.int32)
    leaf_ok = g.integers(0, 2, (M, T)).astype(np.int8)
    leaf_ok[-1] = 0
    q_words = _words(g, M, T, W) if compact else _words(g, M, W)
    q_words[0] = 0
    rects[1] = ops.NEVER_RECT
    fold = lambda w: np.bitwise_or.reduce(w.view(np.uint32), axis=-1).view(np.int32)  # noqa: E731
    words = _words(g, K, B, W)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    head = (rects, q_words, fold(q_words)) if compact else (rects, q_words)
    bank = (x, y, words, fold(words)) if compact else (x, y, words)
    return tuple(t(a) for a in head + (top_leaf, leaf_ok) + bank + (ids.astype(np.int32),))


def _rects(g, n):
    lo = g.uniform(0, 0.8, (n, 2)).astype(np.float32)
    return np.concatenate([lo, lo + g.uniform(0.01, 0.3, (n, 2)).astype(np.float32)], 1)


def ragged_filter(dev, never_rect, M=37, K=131, W=3, seed=13, sparse=False):
    """Dense-filter operands at ragged shapes: a ``NEVER_RECT`` node, a node
    and a query with empty bitmaps, a zero-area query on a node's corner;
    ``sparse``: one to three terms a row, so that most word tests miss."""
    g = np.random.default_rng(seed)
    q_rects, n_mbrs = _rects(g, M), _rects(g, K)
    if sparse:
        pool = np.arange(32 * W)
        q_bm, n_bm = (_terms(g, n, W, pool, 1, 4).view(np.int32) for n in (M, K))
    else:
        q_bm, n_bm = _words(g, M, W), _words(g, K, W)
    if K > 1:
        n_mbrs[0] = never_rect
        n_bm[-1] = 0
    if M > 1:
        q_bm[-1] = 0
        q_rects[0] = np.concatenate([n_mbrs[K // 2, 2:], n_mbrs[K // 2, 2:]])
        q_bm[0] = n_bm[K // 2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(q_rects), t(q_bm), t(n_mbrs), t(n_bm))


def ragged_sub(dev, ops, N=37, S=131, W=3, seed=17, pairs=False, late=False):
    """``sub_match`` operands at ragged shapes, packed as
    ``match_subscriptions`` packs them (``pairs``: the pairs instance's
    full-width ones): ``NEVER_RECT`` and zero-area subscriptions, empty
    bitmaps on both sides, points on rectangle edges. ``late``: every
    object word nonzero, and each subscription's one word past the 32nd a
    bit of an object's there or another, so that matches are decided past
    the words the pairs instance stages."""
    g = np.random.default_rng(seed)
    s_rects = _rects(g, S)
    s_bm = _words(g, S, W).view(np.uint32)
    o_bm = _words(g, N, W).view(np.uint32)
    pts = g.uniform(0, 1, (N, 2)).astype(np.float32)
    if late:
        o_bm = np.uint32(1) << g.integers(0, 32, (N, W)).astype(np.uint32)
        cols = g.integers(32, W, S)
        s_bm = np.zeros((S, W), np.uint32)
        s_bm[np.arange(S), cols] = np.where(g.random(S) < 0.5, o_bm[g.integers(0, N, S), cols],
                                            np.uint32(1) << g.integers(0, 32, S).astype(np.uint32))
        s_rects[::3] = (0.0, 0.0, 1.0, 1.0)
    if S > 2:
        s_rects[0] = ops.NEVER_RECT
        s_rects[1, 2:] = s_rects[1, :2]  # zero area
        s_bm[2] = 0
    if N > 2:
        pts[0] = s_rects[S // 2, 2:]  # a corner
        pts[1] = s_rects[min(1, S - 1), :2]
        o_bm[2] = 0
    fold = lambda w: np.bitwise_or.reduce(w, axis=1).view(np.int32)  # noqa: E731
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    block = (t(s_rects), t(s_bm.view(np.int32)), t(fold(s_bm)))
    if pairs:
        return (t(pts), t(o_bm.view(np.int32))) + block
    wids, bits = ops.pack_query_words(o_bm)
    return (t(pts), t(wids), t(bits.view(np.int32)), t(fold(o_bm))) + block


# the CDF bank's edge points: NaN, both infinities, both zeros, and finite
# points far enough out that a He-scale bank's outputs saturate or no
# longer depend on x
CDF_EDGE_X = (float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1e6, -1e6, 3e7, -3e7)


def cdf_bank(dev, B, H, gen, x=None, N=1001, edges=False):
    """``(params, x)``: a bank of B MLPs 1->H->H->H->1 at ``mlp_init``'s He
    scale (weights N(0, 2/fan_in)) with biases N(0, 0.1^2), all drawn from
    ``gen``; ``x`` defaults to N uniform points. ``edges``: a copy of ``x``
    with ``CDF_EDGE_X`` over as many points, spread over it."""
    dims = dict(w0=(B, 1, H), b0=(B, H), w1=(B, H, H), b1=(B, H), w2=(B, H, H), b2=(B, H),
                w3=(B, H, 1), b3=(B, 1))
    params = {}
    for k, shape in dims.items():
        scale = (2.0 / shape[1]) ** 0.5 if k[0] == "w" else 0.1
        params[k] = (torch.randn(shape, generator=gen) * scale).to(dev)
    if x is None:
        x = torch.rand(N, generator=gen).to(dev)
    if edges:
        k = min(x.numel(), len(CDF_EDGE_X))
        x = x.clone()
        x[torch.arange(k, device=x.device) * x.numel() // k] = torch.tensor(
            CDF_EDGE_X[:k], dtype=x.dtype, device=x.device)
    return params, x


def plain_pairs(o_pts, o_bm, s_rects, s_bm, s_sig):
    """``match_subscription_pairs`` on the plain version, through the same
    capacity retry."""
    from repro_torch.kernels import ops, ref

    args = (o_pts, o_bm, s_rects, s_bm, s_sig)
    pairs, count = ref.sub_match_pairs_ref(*args, ops.SUB_PAIRS_CAPACITY)
    n = int(count)
    if n > ops.SUB_PAIRS_CAPACITY:
        pairs, _ = ref.sub_match_pairs_ref(*args, n)
    return pairs[:n]


def query_points(wl) -> np.ndarray:
    """kNN query points: the centres of the workload's rectangles."""
    return np.stack(
        [(wl.rects[:, 0] + wl.rects[:, 2]) / 2, (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1
    ).astype(np.float32)


def assert_outputs_equal(got, want, what: str) -> None:
    """Two serving outputs equal on every key, dtype, shape and value."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ ({sorted(got)} vs {sorted(want)})")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs")


def check_knn_oracle(knn_query, index, ds, out, points, bms, rows, k: int, what: str) -> None:
    """ids and dist2 of ``rows`` bit-equal to the host best-first oracle."""
    for q in rows:
        r = knn_query(index, ds, points[q], bms[q], k)
        row = out["ids"][q]
        if not np.array_equal(row[row >= 0], r.ids):
            raise AssertionError(f"{what} query {q}: ids differ from knn_query")
        if not np.array_equal(out["dist2"][q][: r.ids.size], r.dist2):
            raise AssertionError(f"{what} query {q}: dist2 differs from knn_query")
        if (row[r.ids.size:] != -1).any():
            raise AssertionError(f"{what} query {q}: more ids than knn_query")


def check_skr_oracle(execute_serial, index, ds, wl, out, rows, what: str):
    """ids, ``nodes_checked`` and ``verified`` of ``rows`` (queries of ``wl``
    without overflow) equal to the host oracle ``execute_serial``, whose
    stats it returns."""
    st = execute_serial(index, ds, wl.subset(rows))
    for j, q in enumerate(rows):
        row = out["ids"][q]
        if not np.array_equal(np.sort(row[row >= 0]), np.sort(st.results[j])):
            raise AssertionError(f"{what} query {q}: ids differ from execute_serial")
    if not np.array_equal(out["nodes_checked"][rows], st.nodes_accessed):
        raise AssertionError(f"{what}: nodes_checked differs from execute_serial")
    if not np.array_equal(out["verified"][rows], st.verified):
        raise AssertionError(f"{what}: verified differs from execute_serial")
    return st


def eq1(out) -> np.ndarray:
    """Per-query Eq. 1 cost of served outputs: 0.1 * nodes_checked + verified."""
    return 0.1 * out["nodes_checked"].astype(np.float64) + out["verified"]


def construction(dev, ds, wl, batches, str_out) -> None:
    """The construction phase: ``build_wisk`` at full size on the card, the
    learned index served against ``execute_serial`` and its Eq. 1 cost
    beside the STR R-tree's (``str_out``: the STR main path's outputs on
    the same batches), twin builds at the profile's own size, an
    accelerated build and a served warm-start rebuild."""
    from repro_torch.core.build import BuildConfig, build_wisk, warm_start_rebuild
    from repro_torch.core.query import execute_serial
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_workload
    from repro_torch.launch.wisk_serve import serve_batch
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot

    def build(data, train, what, **cfg):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        art = build_wisk(data, train, BuildConfig(**cfg), device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        bank = art.bank
        log(f"{what}: {total:.3f} s; phase s {json.dumps(art.timings)}")
        log(f"  counters {json.dumps(art.counters)}")
        log(f"  K={art.partition.clusters.k} level widths {[l.n for l in art.index.levels]}; leaf "
            f"sizes max {int(art.partition.clusters.sizes().max())} mean "
            f"{float(art.partition.clusters.sizes().mean()):.1f}; bank B="
            f"{0 if bank.nn_params is None else bank.nn_params['w0'].shape[0]} MLPs, "
            f"E={bank.n_entries} entries, final loss {bank.train_loss:.9f}; packed levels' n_upper "
            f"{[p.n_upper for p in art.hierarchy.packs] if art.hierarchy else []}")
        log(f"  peak device memory {torch.cuda.max_memory_allocated()} B "
            f"({torch.cuda.max_memory_allocated() - start} B above the build's start)")
        return art

    def serve(snap, rects, bms, rows):
        cache = PlanCache()
        outs, times = [], []
        for b in rows:
            serve_batch(snap, rects[b], bms[b], MAX_LEAVES, plan_cache=cache)  # learn the widths
        for b in rows:
            t = time.perf_counter()
            outs.append(serve_batch(snap, rects[b], bms[b], MAX_LEAVES, plan_cache=cache))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, times

    # the full-size build: train on one sample of the distribution, serve another
    train = make_workload(ds, m=N_TRAIN, dist="MIX", seed=3)
    art = build(ds, train, f"build_wisk {PROFILE} n={ds.n}, MIX m={train.m} seed 3, BuildConfig()")
    t = time.perf_counter()
    snap = IndexSnapshot.build(art.index, ds, device=dev)
    torch.cuda.synchronize()
    log(f"learned snapshot: {time.perf_counter() - t:.3f} s, {snap.nbytes()} B on the device, "
        f"OBJ={snap.obj_per_leaf} has_compact_bank={snap.has_compact_bank} "
        f"has_narrow_planes={snap.has_narrow_planes}")
    outs, times = serve(snap, wl.rects, wl.kw_bitmap, batches)
    log(f"learned index serve_batch x{len(batches)}: batch s {times}")
    rows = np.flatnonzero(outs[0]["overflow"] == 0)
    if rows.size < N_ORACLE:
        raise AssertionError(f"only {rows.size} queries of the first batch without overflow")
    t = time.perf_counter()
    check_skr_oracle(execute_serial, art.index, ds, wl.subset(batches[0]), outs[0], rows,
                     "learned index")
    log(f"learned index: the first batch's {rows.size} queries without overflow equal "
        f"execute_serial ({time.perf_counter() - t:.3f} s)")
    cat = {k: np.concatenate([o[k] for o in outs]) for k in ("nodes_checked", "verified", "overflow")}
    ref = {k: np.concatenate([o[k] for o in str_out]) for k in ("nodes_checked", "verified", "overflow")}
    both = (cat["overflow"] == 0) & (ref["overflow"] == 0)
    log(f"Eq. 1 per query (0.1 * nodes_checked + verified, max_leaves={MAX_LEAVES}) on the "
        f"{wl.m} served queries: learned {float(eq1(cat).mean()):.6f} (overflow "
        f"{int((cat['overflow'] > 0).sum())}), STR R-tree {float(eq1(ref).mean()):.6f} (overflow "
        f"{int((ref['overflow'] > 0).sum())}); on the {int(both.sum())} without overflow in "
        f"either: learned {float(eq1(cat)[both].mean()):.6f}, STR {float(eq1(ref)[both].mean()):.6f}")
    del snap, outs

    # twin builds at the profile's own size: the same config gives the same index
    small = make_dataset(PROFILE, n=N_TWIN, seed=SEED)
    strain = make_workload(small, m=N_TRAIN, dist="MIX", seed=3)
    twins = [build(small, strain, f"twin build {i} n={small.n}") for i in (1, 2)]
    a, b = twins
    if not np.array_equal(a.partition.clusters.assign, b.partition.clusters.assign):
        raise AssertionError("twin builds: partitions differ")
    if len(a.hierarchy.parents) != len(b.hierarchy.parents) or not all(
            np.array_equal(x, y) for x, y in zip(a.hierarchy.parents, b.hierarchy.parents)):
        raise AssertionError("twin builds: hierarchies differ")
    if a.bank.train_loss != b.bank.train_loss or not all(
            torch.equal(a.bank.nn_params[k], b.bank.nn_params[k]) for k in a.bank.nn_params):
        raise AssertionError("twin builds: banks differ")
    log("twin builds: equal partition, hierarchy parents and bank, bit for bit")
    build(small, strain, f"accelerated build n={small.n}", accelerated=True)

    # a warm-start rebuild for a shifted workload, leaves regressed detected
    shifted = make_workload(small, m=N_TRAIN, dist="GAU", seed=4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    warm = warm_start_rebuild(small, shifted, a, device=dev)
    torch.cuda.synchronize()
    log(f"warm_start_rebuild (GAU m={shifted.m} seed 4): {time.perf_counter() - t:.3f} s; "
        f"refined_leaves={warm.counters['refined_leaves']} kept_clusters="
        f"{warm.counters['kept_clusters']}; phase s {json.dumps(warm.timings)}; counters "
        f"{json.dumps(warm.counters)}; level widths {[l.n for l in warm.index.levels]}")
    wsnap = IndexSnapshot.build(warm.index, small, device=dev)
    first = [np.arange(BATCH)]
    (out,), (t_batch,) = serve(wsnap, shifted.rects, shifted.kw_bitmap, first)
    rows = np.flatnonzero(out["overflow"] == 0)
    if rows.size < N_ORACLE:
        raise AssertionError(f"only {rows.size} rebuilt-index queries without overflow")
    check_skr_oracle(execute_serial, warm.index, small, shifted.subset(first[0]), out, rows,
                     "warm-rebuilt index")
    log(f"warm-rebuilt index: a batch of {BATCH} in {t_batch:.6f} s, its {rows.size} queries "
        f"without overflow equal execute_serial")
    return art, train, (small, strain, a)


# PERF.md section 6's rows, by the launch counts' names
KERNEL_ROWS = {
    "frontier_level_narrow": 1, "fused_verify_remap_tile": 2, "fused_verify_compact_tile": 2,
    "fused_verify_remap_slot": 3, "fused_verify_compact_slot": 3, "frontier_level": 4,
    "fused_verify_tile": 5, "fused_verify_slot": 6, "knn_level_dist_narrow": 7,
    "knn_level_dist": 8, "skr_verify_slots_compact": 9, "skr_verify_compact": 9,
    "skr_verify_slots": 10, "skr_verify": 10, "sub_match": 11, "sub_match_pairs": 11,
    "skr_filter": 12, "cdf_mlp_bank": 13,
}


def rows_launched(counts) -> str:
    """The launch counts by PERF.md row, e.g. ``row 4 frontier_level x5``."""
    hit = sorted((KERNEL_ROWS[k], k, n) for k, n in counts.items() if n)
    return ", ".join(f"row {r} {k} x{n}" for r, k, n in hit) or "no kernel"


def live_front_door(dev, ds, train, art) -> None:
    """The live front door on the construction phase's learned index: a
    ``LiveIndex`` over ``art`` (no second build), same-distribution traffic
    with the drift monitor armed, 100,000 geofences, 10,000 inserts and
    5,000 deletes matched and served with the live delta, shifted traffic
    until the monitor trips, ``maybe_rebuild()`` (no force) while an
    in-flight reader holds the old generation, then inserts and traffic on
    the new one. Checks (a)-(e) each raise on failure."""
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.core.cost import exact_query_result_ids
    from repro_torch.core.drift import DriftConfig
    from repro_torch.core.query import SubscriptionOracle, execute_serial, knn_query
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import wisk_serve
    from repro_torch.launch.wisk_serve import LiveIndex, serve_batch
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot
    from repro_torch.serve.subscribe import SubscriptionIndex

    lat = {"same": [], "shift": [], "post": []}
    mix_seed = iter(range(11, 100))  # fresh MIX samples: training used 3, serving 1, geofences 2
    shift_seed = iter(range(31, 100))

    def batch(dist, seeds):
        return make_workload(ds, m=LIVE_BATCH, dist=dist, seed=next(seeds))

    def serve(wl, what):
        t = time.perf_counter()
        out = live.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES)
        torch.cuda.synchronize()
        lat[what].append(time.perf_counter() - t)
        m = live.monitor
        log(f"  {what} batch: {lat[what][-1]:.6f} s; monitor {m.state} ratio {m.ratio:.6f} "
            f"(ewma {m.ewma:.6f}, baseline {m.baseline})")
        return out

    cfg = DriftConfig(threshold=LIVE_THRESHOLD, min_queries=LIVE_MIN_QUERIES)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with phase("LiveIndex over the learned build"):
        live = LiveIndex(ds, train, drift_config=cfg, artifacts=art, device=dev)
    gen0 = live.generation
    log(f"live generation 0: snapshot {gen0.snapshot.nbytes()} B on the device, "
        f"OBJ={gen0.snapshot.obj_per_leaf} has_compact_bank={gen0.snapshot.has_compact_bank} "
        f"Wl={gen0.snapshot.n_compact_words if gen0.snapshot.has_compact_bank else None}; device "
        f"memory {torch.cuda.memory_allocated()} B ({torch.cuda.memory_allocated() - mem0} B above "
        f"the phase's start); DriftConfig threshold={cfg.threshold} min_queries={cfg.min_queries}")

    # 1) the monitor's warm-up, then same-distribution traffic: it must stay armed
    with phase("warm-up and same-distribution traffic"):
        serve(batch("MIX", mix_seed), "same")
        if live.monitor.state != "armed":
            raise AssertionError(f"the monitor is {live.monitor.state} after its warm-up batch")
        same_ratios = []
        for _ in range(N_LIVE_SAME):
            serve(batch("MIX", mix_seed), "same")
            same_ratios.append(live.monitor.ratio)
            if live.monitor.state != "armed":
                raise AssertionError(f"same-distribution traffic moved the monitor to "
                                     f"{live.monitor.state} (ratio {live.monitor.ratio})")
    log(f"same-distribution ratios {same_ratios}: the highest {max(same_ratios):.6f} below the "
        f"threshold {cfg.threshold}")

    # 2) standing geofences
    subs_wl = make_workload(ds, m=N_SUBS, dist="MIX", seed=2)
    with phase(f"subscribe {N_SUBS} geofences"):
        for r, kw in zip(subs_wl.rects, subs_wl.kw_ids):
            live.subscribe(r, kw)

    # 3) inserts (matched in the same step) and deletes
    rng = np.random.default_rng(31)
    arrivals, t_ins = [], []
    with phase(f"{N_INSERT} inserts in batches of {INSERT_BATCH}"):
        for i in range(N_INSERT // INSERT_BATCH):
            locs, kw = make_update_stream(ds, INSERT_BATCH, rng, 1e-3)
            t = time.perf_counter()
            ids = live.insert(locs, kw)
            torch.cuda.synchronize()
            t_ins.append(time.perf_counter() - t)
            arrivals.append((ids, locs, kw))
            if i == N_INSERT // INSERT_BATCH // 2 - 1:  # the rest stays queued across the swap
                drained = [live.drain_notifications()]
    pre_max = int(arrivals[-1][0].max())
    log(f"live inserts: host s per batch of {INSERT_BATCH} (DeltaLog.insert and the subscription "
        f"match) {t_ins} (mean {1e3 * np.mean(t_ins):.3f} ms per 1,000); "
        f"{drained[0].shape[0]} notifications drained after {N_INSERT // 2} inserts")
    with phase(f"{N_DELETE} deletes"):
        new_ids = np.concatenate([a[0] for a in arrivals])
        dels = np.concatenate([rng.choice(ds.n, N_DELETE - N_DELETE_BUFFERED, replace=False),
                               rng.choice(new_ids, N_DELETE_BUFFERED, replace=False)])
        if live.delete(dels) != N_DELETE:
            raise AssertionError("not every live delete took")
    dlog = live.generation.delta_log
    log(f"live delta: {dlog.n_updates()} updates, slots_per_leaf={dlog.buffer.slots_per_leaf} "
        f"compact_ok={dlog.compact_ok}, {dlog.buffer.nbytes()} B on the device")

    # 4) SKR and kNN with the live delta: checks (a) and (b)
    with phase("SKR batch with the delta, check (a)"):
        wl = batch("MIX", mix_seed)
        out = serve(wl, "same")
        merged = live.generation.delta_log.merged_dataset()
        rows = np.flatnonzero(out["overflow"] == 0)[:N_ORACLE]
        if rows.size < N_ORACLE // 2:
            raise AssertionError(f"only {rows.size} live queries without overflow")
        for q in rows:
            row = out["ids"][q]
            want = exact_query_result_ids(merged, wl.rects[q], wl.kw_bitmap[q])
            if not np.array_equal(np.sort(row[row >= 0]), want):
                raise AssertionError(f"(a) live query {q}: ids differ from exact_query_result_ids")
    log(f"(a) SKR with the live delta: the {rows.size} queries without overflow equal "
        f"exact_query_result_ids over the {merged.n} merged objects")
    with phase(f"kNN batch (k={K}) with the delta, check (b)"):
        kwl = batch("MIX", mix_seed)
        pts = query_points(kwl)
        torch.cuda.synchronize()
        kmem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        kout = live.serve_knn(pts, kwl.kw_bitmap, K)
        torch.cuda.synchronize()
        t_knn = time.perf_counter() - t
        kpeak = torch.cuda.max_memory_allocated() - kmem
        cold = build_str_rtree(merged, leaf_size=LEAF_SIZE, fanout=FANOUT)
        check_knn_oracle(knn_query, cold, merged, kout, pts, kwl.kw_bitmap,
                         range(min(N_ORACLE, LIVE_BATCH)), K, "(b) live kNN")
    log(f"(b) kNN with the live delta: {t_knn:.6f} s, peak device memory {kpeak} B above its "
        f"start; ids and dist2 equal knn_query over a cold STR index of the merged objects")
    del merged, cold

    # 5) shifted traffic until the monitor trips; no force. UNI trips it
    # (PERF.md section 6, with little to spare), GAU and LAP follow if not
    with phase("shifted traffic"):
        tripped = None
        for dist in LIVE_SHIFTS:
            for _ in range(N_SHIFT_BATCHES):
                swl = batch(dist, shift_seed)
                serve(swl, "shift")
                if live.monitor.triggered:
                    tripped = dist
                    break
            if tripped:
                break
    if tripped is None:
        raise AssertionError(f"no shift of {LIVE_SHIFTS} tripped the monitor")
    log(f"the monitor tripped on {tripped} traffic at ratio {live.monitor.ratio:.6f} > threshold "
        f"{cfg.threshold} (same-distribution ratios at most {max(same_ratios):.6f})")

    # the in-flight reader: the old generation on one batch before and after the swap
    old = live.generation

    def in_flight():
        return serve_batch(old.snapshot, swl.rects, swl.kw_bitmap, MAX_LEAVES,
                           plan_cache=old.plan_cache, delta=old.delta())

    before = in_flight()
    split = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name] = time.perf_counter() - t
            return r
        return run

    torch.cuda.synchronize()
    swap0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with patched(wisk_serve, warm_start_rebuild=timed("warm_start_rebuild",
                                                      wisk_serve.warm_start_rebuild)), \
            patched(IndexSnapshot, build=staticmethod(timed("snapshot", IndexSnapshot.build))):
        if not timed("swap", live.maybe_rebuild)():
            raise AssertionError("maybe_rebuild() did not swap after the monitor tripped")
    swap_peak = torch.cuda.max_memory_allocated()
    new = live.generation
    warm = new.artifacts
    log(f"swap: maybe_rebuild {split['swap']:.3f} s = warm_start_rebuild "
        f"{split['warm_start_rebuild']:.3f} s + the new snapshot {split['snapshot']:.3f} s + the "
        f"rest (merged dataset, observed workload, DeltaLog); rebuild phase s "
        f"{json.dumps(warm.timings)} counters {json.dumps(warm.counters)}; level widths "
        f"{[l.n for l in warm.index.levels]}")
    log(f"swap memory: old generation {old.snapshot.nbytes()} B, new {new.snapshot.nbytes()} B "
        f"(OBJ {old.snapshot.obj_per_leaf} -> {new.snapshot.obj_per_leaf}); peak device memory "
        f"across the swap {swap_peak} B ({swap_peak - swap0} B above its start, "
        f"{torch.cuda.get_device_properties(0).total_memory} B on the card)")
    if new.snapshot.obj_per_leaf > old.snapshot.obj_per_leaf:
        raise AssertionError(f"the warm rebuild grew OBJ from {old.snapshot.obj_per_leaf} to "
                             f"{new.snapshot.obj_per_leaf}")

    # (c) the in-flight generation, (d) the new one
    assert_outputs_equal({k: before[k] for k in ("ids", "counts")},
                         {k: in_flight()[k] for k in ("ids", "counts")}, "(c) the old generation")
    log("(c) the old generation serves the same ids and counts before and after the swap")
    n_pre = sum(a[0].size for a in arrivals)
    if new.seq != old.seq + 1 or new.delta() is not None or new.dataset.n != ds.n + n_pre:
        raise AssertionError(f"(d) the new generation: seq {new.seq}, delta {new.delta()}, "
                             f"n {new.dataset.n}")
    del old, before
    gc.collect()
    torch.cuda.empty_cache()
    with phase("first post-swap batch, check (d)"):
        pwl = batch(tripped, shift_seed)
        pout = serve(pwl, "post")
        rows = np.flatnonzero(pout["overflow"] == 0)[:N_ORACLE]
        if rows.size < N_ORACLE // 2:
            raise AssertionError(f"only {rows.size} post-swap queries without overflow")
        check_skr_oracle(execute_serial, new.artifacts.index, new.dataset, pwl, pout, rows,
                         "(d) the new generation")
    log(f"(d) the new generation: seq {new.seq}, no delta, {new.dataset.n} objects; the first "
        f"batch's {rows.size} queries without overflow equal execute_serial")

    # 6) inserts after the swap, then traffic until the monitor re-arms;
    # one batch of each kind profiled, with the rows it launches
    def profiled(label, fn):
        _build.reset_launch_counts()
        profile_batch(label, lambda cache: fn(), live.generation.plan_cache, PlanCache)
        log(f"  {label}: launches {rows_launched(_build.launch_counts())}")

    profiled("live SKR batch without a delta", lambda: live.serve(pwl.rects, pwl.kw_bitmap,
                                                                  MAX_LEAVES))
    with phase(f"{N_POST_INSERT} inserts after the swap"):
        for i in range(N_POST_INSERT // INSERT_BATCH):
            locs, kw = make_update_stream(ds, INSERT_BATCH, rng, 1e-3)
            got = []
            if i == 0:
                profiled(f"live insert batch of {INSERT_BATCH}",
                         lambda: got.append(live.insert(locs, kw)))
            else:
                got.append(live.insert(locs, kw))
            arrivals.append((got[0], locs, kw))
    post_min = int(min(a[0].min() for a in arrivals[N_INSERT // INSERT_BATCH:]))
    if post_min <= pre_max:
        raise AssertionError(f"post-swap ids start at {post_min}, not above {pre_max}")
    with phase("post-swap traffic"):
        for _ in range(N_POST_BATCHES):
            pwl = batch(tripped, shift_seed)
            serve(pwl, "post")
        if live.monitor.state != "armed":
            raise AssertionError(f"the monitor is {live.monitor.state} after the post-swap traffic")
    profiled("live SKR batch with the delta", lambda: live.serve(pwl.rects, pwl.kw_bitmap,
                                                                 MAX_LEAVES))

    # (e) the notification stream: drained before the swap, and after it
    # (queued across it and post-swap)
    with phase("notifications, check (e)"):
        drained.append(live.drain_notifications())
        stream = np.concatenate(drained)
        if live.drain_notifications().shape != (0, 2):
            raise AssertionError("(e) a second drain was not empty")
        plain = SubscriptionIndex(ds.vocab_size, device=dev)
        for r, kw in zip(subs_wl.rects, subs_wl.kw_ids):
            plain.subscribe(r, kw)
        _build.reset_launch_counts()
        with patched(ops, match_subscription_pairs=plain_pairs):
            for ids, locs, kw in arrivals:
                plain.match_arrivals(ids, locs, kw_ids=kw)
        if any(_build.launch_counts().values()):
            raise AssertionError("(e) the plain rerun launched a kernel")
        if not np.array_equal(plain.drain(), stream):
            raise AssertionError("(e) the stream differs from its plain rerun")
        sample_rng = np.random.default_rng(29)
        notified = np.unique(stream[:, 1])
        half = min(N_SUB_SAMPLE // 2, notified.size)
        sample = np.union1d(sample_rng.choice(notified, half, replace=False),
                            sample_rng.choice(N_SUBS, N_SUB_SAMPLE - half, replace=False))
        oracle = SubscriptionOracle()
        to_oracle = {int(sid): oracle.subscribe(subs_wl.rects[sid], subs_wl.kw_ids[sid])
                     for sid in sample}
        for ids, locs, kw in arrivals:
            oracle.arrive(ids, locs, kw)
        keep = np.isin(stream[:, 1], sample)
        mapped = np.stack([stream[keep, 0], [to_oracle[int(s)] for s in stream[keep, 1]]], 1)
        want = oracle.drain()
        if not np.array_equal(mapped.reshape(-1, 2), want):
            raise AssertionError("(e) the sampled stream differs from SubscriptionOracle's replay")
    log(f"(e) notifications: {stream.shape[0]} ({drained[0].shape[0]} drained before the swap, "
        f"{drained[1].shape[0]} after it, of them "
        f"{int((drained[1][:, 0] <= pre_max).sum())} queued across it); equal to the plain "
        f"rerun pair for pair; on {sample.size} sampled geofences ({half} notified) the "
        f"{want.shape[0]} notifications equal SubscriptionOracle's replay; post-swap ids from "
        f"{post_min} above the pre-swap {pre_max}; a second drain is empty")
    log(f"live batch latencies of {LIVE_BATCH} (s): before the shift {lat['same']}, under it "
        f"{lat['shift']}, after the swap {lat['post']}")


# ------------------------------------------------- multi-rank serving (phase 15)
N_RANKS = 2
KNN_RANK_QUERIES = 1024  # the kNN batch of the multi-rank phase
FLAT_SEED = SEED + 15  # the flat step's queries; shard s's leaf rows take FLAT_SEED + 1 + s
FLAT_SHAPE = None  # (n_queries, n_nodes) of the flat step; None: WiskServeConfig()'s own
N_LIVE_INSERT = 1_000  # the sharded LiveIndex's inserts before the swap
N_LIVE_DELETE = 500  # of which 50 are buffered inserts
RANK_TIMEOUT_S = 900
COLLECTIVE_NAMES = ("all_gather", "allgather", "all_reduce", "allreduce", "broadcast")
# the kernels each run of the multi-rank phase must launch on every rank
RANK_RUNS_NEED = {
    "index SKR": ("frontier_level_narrow", "fused_verify_remap_slot"),
    "index kNN": ("knn_level_dist_narrow",),
    "query SKR": ("frontier_level_narrow", "fused_verify_remap_slot"),
    "query kNN": ("knn_level_dist_narrow",),
    "index SKR delta": ("frontier_level", "fused_verify_remap_slot", "skr_verify_slots"),
    "index kNN delta": ("knn_level_dist",),
    "flat step": ("skr_filter", "skr_verify"),
}


def share(obj):
    """``obj`` with every tensor field of its dataclass in shared memory, so
    the spawned ranks map the parent's host arrays instead of copying
    them; returns ``obj``."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        for t in v if isinstance(v, list) else [v]:
            if isinstance(t, torch.Tensor):
                t.share_memory_()
    return obj


def run_live_steps(li, steps):
    """Drive a ``LiveIndex`` through ``steps`` (``("serve", rects, bms,
    max_leaves)``, ``("knn", points, bms, k)``, ``("insert", locs, kw)``,
    ``("delete", ids)``, ``("rebuild",)``); each step's result and the
    generation's ``seq`` after it."""
    out = []
    for op, *args in steps:
        if op == "serve":
            got = li.serve(*args)
        elif op == "knn":
            got = li.serve_knn(*args)
        elif op == "insert":
            got = li.insert(*args)
        elif op == "delete":
            got = li.delete(*args)
        else:
            got = li.maybe_rebuild(force=True)
        out.append((op, got, li.generation.seq))
    return out


def same_id_sets(got, want, what: str) -> None:
    """SKR outputs served on another layout: equal counters and, per query,
    equal id sets (the ids' order follows the layout)."""
    for k in ("counts", "nodes_checked", "verified", "overflow"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs")
    for q, (a, b) in enumerate(zip(got["ids"], want["ids"])):
        if not np.array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0])):
            raise AssertionError(f"{what}: query {q}'s ids differ")


def collective_share(prof, wall_us: float) -> float:
    """The share of ``wall_us`` the host spent inside collectives: the union
    of the profiler's host intervals of events named for one."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if any(n in e.name.lower() for n in COLLECTIVE_NAMES))
    total, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / wall_us


@contextlib.contextmanager
def timed_collectives():
    """Host seconds spent inside ``torch.distributed``'s all-gathers,
    all-reduces and reduce-scatters while inside (gloo and NCCL both return
    from these calls once the collective is done), as ``box[0]``."""
    import torch.distributed as dist

    box = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                box[0] += time.perf_counter() - t
        return call

    with patched(dist, all_gather_into_tensor=timed(dist.all_gather_into_tensor),
                 all_reduce=timed(dist.all_reduce),
                 reduce_scatter_tensor=timed(dist.reduce_scatter_tensor)):
        yield box


@contextlib.contextmanager
def split_collectives(sync):
    """Inside, every all-gather and all-reduce first waits for this rank's
    own device work (``sync``), then for the other ranks of its group (a
    barrier on that group), and only then runs; the host seconds of each
    part add up by op in ``box[op] = [own device, peer wait, collective,
    calls]``. The first two are what a collective's host time holds
    besides its own transfer (ranks that share a card also wait there for
    each other's kernels); the barrier's own round trip counts as peer
    wait. The syncs and barriers slow the batch: its wall is not a batch
    time."""
    import torch.distributed as dist

    box = {}

    def split(op, fn):
        def call(*a, **kw):
            part = box.setdefault(op, [0.0, 0.0, 0.0, 0])
            t0 = time.perf_counter()
            sync()
            t1 = time.perf_counter()
            dist.barrier(group=kw.get("group"))
            t2 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                part[0] += t1 - t0
                part[1] += t2 - t1
                part[2] += time.perf_counter() - t2
                part[3] += 1
        return call

    with patched(dist, all_gather_into_tensor=split("all_gather", dist.all_gather_into_tensor),
                 all_reduce=split("all_reduce", dist.all_reduce)):
        yield box


def profiled(serve_one):
    """``(wall ms, device idle %, collective %)`` of one call of
    ``serve_one`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        serve_one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return wall_us / 1e3, 100 - 100 * busy / wall_us, 100 * collective_share(prof, wall_us)


def rank_phase(rank: int, world: int, init: str, backend: str, p: dict) -> None:
    """One rank of the multi-rank phase (spawned): every rank makes the same
    calls; rank 0 logs. Any failed check raises, which ends this rank with
    a non-zero exit and the parent's phase with it."""
    import datetime

    import torch.distributed as dist

    from repro_torch.kernels import _build, ops
    from repro_torch.launch import wisk_serve
    from repro_torch.launch.flat_legacy import wisk_serve_step
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.wisk_serve import (
        LiveIndex, serve_index_sharded, serve_knn_index_sharded, serve_knn_sharded, serve_sharded,
    )
    from repro_torch.serve.plan import PlanCache

    on_card = p["device_type"] == "cuda"  # else a rehearsal on the CPU
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}" if on_card else "cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    say = log if rank == 0 else (lambda *a: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    qmesh = make_serving_mesh(query=world, index=1, device=dev)
    imesh = make_serving_mesh(query=1, index=world, device=dev)
    say(f"  rank 0 up, its group joined and its meshes made: {time.time() - p['spawned']:.3f} s "
        f"after the spawn")
    psnap, host = p["psnap"], p["host"]
    rects, bms, points, batches = p["rects"], p["bms"], p["points"], p["batches"]
    b0, kq = batches[0], p["knn_rows"]
    counts = {}  # run -> this rank's launch counts
    secs = {}

    def run(name, fn):
        """``fn()`` with the launch counts zeroed before and read after, the
        host clock around it (synchronized)."""
        sync()
        _build.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        sync()
        secs.setdefault(name, []).append(time.perf_counter() - t)
        counts[name] = {k: v for k, v in _build.launch_counts().items() if v}
        return out

    t = time.perf_counter()
    slab = wisk_serve._placed(psnap, imesh).snap
    sync()
    say(f"  rank slab: {slab.nbytes()} B on {dev} of the whole snapshot's {host.nbytes()} B "
        f"(per_shard_bytes {psnap.per_shard_bytes()}), placed in {time.perf_counter() - t:.3f} s")

    # index-parallel SKR: the 4 batches, a cold cache converged on batch 0
    icache = PlanCache()
    run("index SKR cold", lambda: serve_index_sharded(psnap, rects[b0], bms[b0], MAX_LEAVES,
                                                      mesh=imesh, plan_cache=icache))
    with timed_collectives() as in_coll:
        outs = [run("index SKR", lambda b=b: serve_index_sharded(
            psnap, rects[b], bms[b], MAX_LEAVES, mesh=imesh, plan_cache=icache)) for b in batches]
    for bi, (got, want) in enumerate(zip(outs, p["skr"])):
        same_id_sets(got, want, f"index-parallel SKR batch {bi}")
    say(f"  index-parallel SKR (S={world}): cold batch {secs['index SKR cold'][0]:.6f} s, warm "
        f"batch s {secs['index SKR']}, of them {in_coll[0]:.6f} s "
        f"({100 * in_coll[0] / sum(secs['index SKR']):.3f} %) in collectives (host clock, waits "
        f"for the peer rank included); id sets, counts, nodes_checked, verified and overflow "
        f"equal the single-device batches; widths {sorted(icache.widths.items())}")

    # index-parallel kNN, from a cold cache (its warm repeat, 7.6 s, is cut
    # for the smoke's time limit)
    kcache = PlanCache()
    with timed_collectives() as in_coll:
        kout = run("index kNN", lambda: serve_knn_index_sharded(
            psnap, points[kq], bms[kq], K, mesh=imesh, plan_cache=kcache))
    want = {k: v[:kq.size] for k, v in p["knn"].items() if k != "frontier_widths"}
    assert_outputs_equal({k: kout[k] for k in want}, want, "index-parallel kNN")
    say(f"  index-parallel kNN (S={world}, k={K}, {kq.size} queries): cold "
        f"{secs['index kNN'][0]:.6f} s, of it {in_coll[0]:.6f} s "
        f"({100 * in_coll[0] / secs['index kNN'][0]:.3f} %) in collectives (host clock, waits "
        f"for the peer rank included); ids, dist2 and every counter equal the single-device "
        f"batch; widths {sorted(kcache.widths.items())}")

    # query-parallel: the same batches at the single-device run's learned
    # widths, where every key is equal (the cold-cache batch is cut for the
    # smoke's time limit; tests/test_torch_sharded.py converges from cold)
    qcache = PlanCache()
    qcache.widths = dict(p["warm_skr"])
    outs = [run("query SKR", lambda b=b: serve_sharded(host, rects[b], bms[b], MAX_LEAVES,
                                                       mesh=qmesh, plan_cache=qcache))
            for b in batches]
    for bi, (got, want) in enumerate(zip(outs, p["skr"])):
        assert_outputs_equal(got, want, f"query-parallel SKR batch {bi}")
    qkcache = PlanCache()
    qkcache.widths = dict(p["warm_knn"])
    got = run("query kNN", lambda: serve_knn_sharded(host, points[kq], bms[kq], K, mesh=qmesh,
                                                     plan_cache=qkcache))
    assert_outputs_equal(got, {k: (v[:kq.size] if k != "frontier_widths" else v)
                               for k, v in p["knn"].items()}, "query-parallel kNN")
    say(f"  query-parallel (Q={world}): SKR at the learned widths batch s {secs['query SKR']}; "
        f"kNN {secs['query kNN'][0]:.6f} s; every key equal, id order included")

    # log B's delta routed to the owning shards
    dcache, dkcache = PlanCache(), PlanCache()
    got = run("index SKR delta", lambda: serve_index_sharded(
        psnap, rects[b0], bms[b0], MAX_LEAVES, mesh=imesh, plan_cache=dcache, delta=p["delta"]))
    same_id_sets(got, p["delta_skr"], "index-parallel SKR with log B's delta")
    got = run("index kNN delta", lambda: serve_knn_index_sharded(
        psnap, points[b0], bms[b0], K, mesh=imesh, plan_cache=dkcache, delta=p["delta"]))
    want = {k: v for k, v in p["delta_knn"].items() if k != "frontier_widths"}
    assert_outputs_equal({k: got[k] for k in want}, want, "index-parallel kNN with log B's delta")
    say(f"  log B's delta (partition_delta): SKR {secs['index SKR delta'][0]:.6f} s, kNN "
        f"{secs['index kNN delta'][0]:.6f} s (cold caches); equal to the single-device delta runs")

    # the flat fallback step: each rank draws only its own leaf rows
    q_rects, q_bm = flat_queries(dev)
    leaves = flat_shard(imesh.axis("index").index, world, dev)
    flat = run("flat step", lambda: wisk_serve_step(q_rects, q_bm, *leaves,
                                                    axis=imesh.axis("index")))
    for name, g, w in zip(("counts", "scanned", "overflow"), flat, p["flat_want"]):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"flat step: {name} differs from the plain per-shard sum")
    say(f"  flat step at WiskServeConfig() ({q_rects.shape[0]} queries, {world} x "
        f"{leaves[0].shape[0]} nodes, W={q_bm.shape[1]}, OBJ={leaves[2].shape[1]}): "
        f"{secs['flat step'][0]:.6f} s, equal to the plain per-shard sum")
    del q_rects, q_bm, leaves, flat
    if on_card:
        torch.cuda.empty_cache()

    # the sharded LiveIndex against the single-device one
    live = run("LiveIndex up", lambda: LiveIndex(index_mesh=imesh, **p["live_kw"]))
    got = run("LiveIndex steps", lambda: run_live_steps(live, p["live_steps"]))
    for i, ((op, g, seq), (_, w, wseq)) in enumerate(zip(got, p["live_want"])):
        if seq != wseq:
            raise AssertionError(f"LiveIndex step {i} ({op}): seq {seq} != {wseq}")
        if op == "serve":
            same_id_sets(g, w, f"LiveIndex step {i}")
        elif op == "knn":
            assert_outputs_equal({k: g[k] for k in KNN_OUT}, {k: w[k] for k in KNN_OUT},
                                 f"LiveIndex step {i}")
        elif not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"LiveIndex step {i} ({op}): {g} != {w}")
    n_ins = sum(len(s[1]) for s in p["live_steps"] if s[0] == "insert")
    n_del = sum(len(s[1]) for s in p["live_steps"] if s[0] == "delete")
    say(f"  LiveIndex(index_shards={world}) over the {p['live_kw']['dataset'].n}-object twin "
        f"build: up in {secs['LiveIndex up'][0]:.6f} s; {len(got)} steps (serves, {n_ins} "
        f"inserts, {n_del} deletes, kNN, a forced swap) in {secs['LiveIndex steps'][0]:.6f} s, "
        f"equal step for step to the single-device LiveIndex")

    # where a SKR batch's time goes, on rank 0 (every rank serves the
    # batch); a kNN batch's profile would hold hundreds of thousands of
    # events (a chunk loop of thousands of steps), so the kNN batch above
    # reads its collectives on the host clock instead
    t = time.perf_counter()
    for label, fn in (
        ("index-parallel SKR", lambda: serve_index_sharded(
            psnap, rects[b0], bms[b0], MAX_LEAVES, mesh=imesh, plan_cache=icache)),
        ("query-parallel SKR", lambda: serve_sharded(
            host, rects[b0], bms[b0], MAX_LEAVES, mesh=qmesh, plan_cache=qcache)),
    ):
        if rank == 0 and on_card:
            wall, idle, coll = profiled(fn)
            say(f"  profile of one warm {label} batch on rank 0 (profiler on): wall {wall:.6f} ms, "
                f"device idle {idle:.3f} %, in collectives {coll:.3f} % of the wall")
        else:
            fn()
            sync()
    say(f"  profiles: {time.perf_counter() - t:.3f} s")

    # what the host time inside collectives holds: the same warm SKR batch
    # per regime with each collective split into the wait for this rank's
    # own device work, the wait for the peer rank, and the collective itself
    splits = {}
    for label, fn in (
        ("index-parallel SKR", lambda: serve_index_sharded(
            psnap, rects[b0], bms[b0], MAX_LEAVES, mesh=imesh, plan_cache=icache)),
        ("query-parallel SKR", lambda: serve_sharded(
            host, rects[b0], bms[b0], MAX_LEAVES, mesh=qmesh, plan_cache=qcache)),
    ):
        sync()
        t = time.perf_counter()
        with split_collectives(sync) as box:
            fn()
        sync()
        splits[label] = (time.perf_counter() - t, box)

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    everyone = [None] * world
    dist.all_gather_object(everyone, (rank, counts, peak, slab.nbytes(), splits))
    for r, c, pk, sb, sp in everyone:
        say(f"  rank {r}: slab {sb} B, peak device memory {pk} B; launches by run: "
            + "; ".join(f"{name}: {rows_launched(v)}" for name, v in c.items()))
        for label, (wall, box) in sp.items():
            say(f"  rank {r}, one warm {label} batch with its collectives split (wall "
                f"{wall:.6f} s, slowed by the split): " + "; ".join(
                    f"{op} x{n}: own device {a:.6f} s, peer wait {b:.6f} s, collective "
                    f"{c_:.6f} s" for op, (a, b, c_, n) in sorted(box.items())))
    for name, need in RANK_RUNS_NEED.items() if on_card else ():
        for r, c, _, _, _ in everyone:
            for k in need:
                if not c[name].get(k):
                    raise AssertionError(f"rank {r}'s {name} run never launched {k}")
    dist.destroy_process_group()


KNN_OUT = ("ids", "dist2", "nodes_checked", "verified", "leaves_verified", "pruned")


def _device_words(g, shape, dev) -> torch.Tensor:
    """Random int32 bitmap words drawn on ``dev``, about half of them zero."""
    w = torch.randint(-2 ** 31, 2 ** 31, shape, generator=g, device=dev, dtype=torch.int64)
    return w.to(torch.int32) * torch.randint(0, 2, shape, generator=g, device=dev,
                                             dtype=torch.int32)


def flat_config():
    """``WiskServeConfig()``, at ``FLAT_SHAPE`` where a rehearsal set one."""
    from repro_torch.configs.wisk import WiskServeConfig

    cfg = WiskServeConfig()
    if FLAT_SHAPE is not None:
        cfg.n_queries, cfg.n_nodes = FLAT_SHAPE
    return cfg


def flat_queries(dev):
    """The flat step's ``n_queries`` query rectangles and bitmap words
    (int32 views), drawn on ``dev`` from ``FLAT_SEED``."""
    cfg = flat_config()
    g = torch.Generator(dev).manual_seed(FLAT_SEED)
    lo = 0.8 * torch.rand(cfg.n_queries, 2, generator=g, device=dev)
    ext = 0.01 + 0.19 * torch.rand(cfg.n_queries, 2, generator=g, device=dev)
    return torch.cat([lo, lo + ext], 1), _device_words(g, (cfg.n_queries, cfg.vocab // 32), dev)


def flat_shard(s: int, n_shards: int, dev) -> list:
    """Leaf shard ``s`` of ``n_shards`` of the flat step's operands at
    ``WiskServeConfig``'s widths (``n_nodes`` leaves in all, ``OBJ_PER_LEAF``
    slots a leaf, ``vocab // 32`` words), drawn on ``dev`` from its own seed,
    so a rank draws only its slab and the plain run draws the same rows:
    leaf MBRs and words, objects inside their leaf with two keywords each,
    80 % of the slots valid. In ``wisk_serve_step``'s argument order."""
    from repro_torch.launch.flat_legacy import OBJ_PER_LEAF

    cfg = flat_config()
    K, W = cfg.n_nodes // n_shards, cfg.vocab // 32
    g = torch.Generator(dev).manual_seed(FLAT_SEED + 1 + s)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    lo, ext = 0.9 * rand(K, 2), 0.005 + 0.095 * rand(K, 2)
    obj_bm = torch.zeros((K, OBJ_PER_LEAF, W), dtype=torch.int32, device=dev)
    for _ in range(2):
        w = torch.randint(0, W, (K, OBJ_PER_LEAF, 1), generator=g, device=dev)
        bit = torch.randint(0, 32, (K, OBJ_PER_LEAF, 1), generator=g, device=dev,
                            dtype=torch.int32)
        obj_bm.scatter_(2, w, obj_bm.gather(2, w) | torch.bitwise_left_shift(
            torch.ones_like(bit), bit))
    leaf_bm = _device_words(g, (K, W), dev) | _device_words(g, (K, W), dev)
    obj_x = lo[:, :1] + ext[:, :1] * rand(K, OBJ_PER_LEAF)
    obj_y = lo[:, 1:] + ext[:, 1:] * rand(K, OBJ_PER_LEAF)
    obj_valid = (rand(K, OBJ_PER_LEAF) < 0.8).to(torch.int8)
    return [torch.cat([lo, lo + ext], 1), leaf_bm, obj_x, obj_y, obj_bm, obj_valid]


def multi_rank_serving(dev, wl, points, batches, snap, warm, skr_out, warm_knn, knn_out, delta,
                       delta_skr, delta_knn, twin) -> None:
    """Phase 15: both multi-rank regimes over the smoke's index on
    ``N_RANKS`` ranks. The parent builds the host arrays once (the snapshot,
    its partition, log B's delta, the flat step's operands, the twin
    build) in shared memory and the single-device outputs to hold the ranks
    to; the ranks place their slabs and serve (``rank_phase``)."""
    from repro_torch.core.drift import DriftConfig
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.flat_legacy import OBJ_PER_LEAF, wisk_serve_step
    from repro_torch.launch.wisk_serve import LiveIndex
    from repro_torch.serve.snapshot import PartitionedSnapshot

    cards = torch.cuda.device_count()
    backend = "nccl" if dev.type == "cuda" and cards >= N_RANKS else "gloo"
    log(f"multi-rank serving: {N_RANKS} ranks on {min(cards, N_RANKS)} card(s) of {cards}, "
        f"backend {backend} (NCCL takes one card a rank; ranks that share a card use gloo, "
        f"which runs all_reduce, all_gather_into_tensor and broadcast on CUDA tensors itself: "
        f"no collective is copied through the host)")
    t = time.perf_counter()
    host = share(dataclasses.replace(snap, child_matrix=[]).to("cpu"))
    psnap = share(PartitionedSnapshot.build(host, N_RANKS))
    log(f"host snapshot and PartitionedSnapshot.build(S={N_RANKS}): {time.perf_counter() - t:.3f} "
        f"s; whole snapshot {host.nbytes()} B, per shard {psnap.per_shard_bytes()} B "
        f"(level pads {psnap.part.level_pads})")

    # the flat step at WiskServeConfig(): the plain per-shard sum, one shard
    # on the card at a time (each rank draws its own shard again)
    t = time.perf_counter()
    q_rects, q_bm = flat_queries(dev)
    parts, nbytes = [], 0
    with patched(ops, filter_pairs=ref.skr_filter_ref, verify_candidates=ref.skr_verify_ref):
        for s in range(N_RANKS):
            leaves = flat_shard(s, N_RANKS, dev)
            nbytes += sum(v.numel() * v.element_size() for v in leaves)
            parts.append(wisk_serve_step(q_rects, q_bm, *leaves))
            del leaves
    flat_want = [sum(x[i] for x in parts).cpu() for i in range(3)]
    log(f"flat step operands at WiskServeConfig(): {q_rects.shape[0]} queries x "
        f"{N_RANKS} shards of {flat_config().n_nodes // N_RANKS} nodes, "
        f"W={q_bm.shape[1]}, OBJ={OBJ_PER_LEAF} ({nbytes} B of leaf rows, drawn on the card); "
        f"plain per-shard sum in {time.perf_counter() - t:.3f} s: {int(flat_want[0].sum())} "
        f"matches, {int(flat_want[1].sum())} relevant leaves, {int(flat_want[2].sum())} overflow")
    del q_rects, q_bm, parts

    # the sharded LiveIndex's scenario, first on one device for the outputs to hold it to
    small, strain, art = twin
    g = np.random.default_rng(SEED + 16)
    wls = [make_workload(small, m=LIVE_BATCH, dist="MIX", seed=s) for s in (61, 62, 63, 64)]
    locs, kw = make_update_stream(small, N_LIVE_INSERT, g, 0.05)
    locs2, kw2 = make_update_stream(small, N_LIVE_INSERT // 5, g, 0.05)
    steps = [("serve", wls[0].rects, wls[0].kw_bitmap, MAX_LEAVES),
             ("insert", locs, kw),
             ("serve", wls[1].rects, wls[1].kw_bitmap, MAX_LEAVES)]
    live_kw = dict(dataset=small, workload=strain,
                   drift_config=DriftConfig(threshold=LIVE_THRESHOLD, min_queries=LIVE_MIN_QUERIES),
                   artifacts=dataclasses.replace(art, bank=art.bank.to("cpu")))
    single = LiveIndex(device=dev, **live_kw)
    want = run_live_steps(single, steps)
    new_ids = want[1][1]
    dels = np.concatenate([g.choice(small.n, N_LIVE_DELETE - 50, replace=False),
                           g.choice(new_ids, 50, replace=False)])
    more = [("delete", dels),
            ("serve", wls[1].rects, wls[1].kw_bitmap, MAX_LEAVES),
            ("knn", query_points(wls[2]), wls[2].kw_bitmap, K),
            ("rebuild",),
            ("serve", wls[3].rects, wls[3].kw_bitmap, MAX_LEAVES),
            ("insert", locs2, kw2),
            ("serve", wls[3].rects, wls[3].kw_bitmap, MAX_LEAVES)]
    t = time.perf_counter()
    want += run_live_steps(single, more)
    steps += more
    torch.cuda.synchronize()
    log(f"single-device LiveIndex scenario over the twin build ({small.n} objects, "
        f"{len(steps)} steps, the forced swap included): {time.perf_counter() - t:.3f} s after "
        f"the first three steps")
    del single
    gc.collect()
    torch.cuda.empty_cache()

    payload = dict(
        psnap=psnap, host=host, rects=wl.rects, bms=wl.kw_bitmap, points=points, batches=batches,
        warm_skr=dict(warm.widths), skr=skr_out, warm_knn=dict(warm_knn.widths), knn=knn_out[0],
        delta=share(delta.to("cpu")), delta_skr=delta_skr,
        delta_knn=delta_knn, flat_want=flat_want, live_kw=live_kw,
        live_steps=steps, live_want=want, device_type=dev.type,
        knn_rows=batches[0][:KNN_RANK_QUERIES],
    )
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        payload["spawned"] = time.time()
        torch.multiprocessing.spawn(rank_phase, args=(N_RANKS, f"file://{d}/rendezvous", backend,
                                                      payload), nprocs=N_RANKS, join=True)
    log(f"ranks: {time.perf_counter() - t:.3f} s from spawn to join")


# ------------------------------------------------------- LM serving (phase 16)
LM_ARCH = "tinyllama-1.1b"  # the retrieval-augmented path's model, published widths
LM_QUERIES = 128  # the first SKR batch's first queries prompt one decode row each
LM_PROMPT = 32  # retrieved ids per prompt (teacher-forced decode steps)
LM_CACHE = 4096  # KV cache slots
LM_NEW = 64  # greedy tokens after the prompt
LM_PREFILL = (8, 2048)  # prefill_step's (B, S), masked_scan at attn_chunk 1024
LM_CHECK = (8, 512)  # decode against prefill: (B, teacher-forced steps)
LM_CPU = (2, 4)  # the card against the port's CPU run: (B, decode steps), as many greedy
LM_OTHERS = ("deepseek-7b", "minitron-8b", "starcoder2-7b", "phi-3-vision-4.2b")
LM_SHORT = (2, 256, 8)  # the other configs: prefill (B, S) and decode steps
LM_REL = 0.05  # the reference's test_decode_matches_prefill_tinyllama bound, of max |logit|
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate


def lm_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _attn_params(cfg) -> int:
    """Attention weights one token multiplies in a layer: GQA's q, k, v and
    o; or MLA's projections, ``wk_b`` and ``wv_b`` once a token as the
    path computes them (materialized k and v at prefill, the absorbed
    q and context at decode)."""
    if cfg.use_mla:
        H = cfg.n_heads
        return (cfg.d_model * cfg.q_lora + cfg.q_lora * H * (cfg.qk_nope + cfg.qk_rope)
                + cfg.d_model * (cfg.kv_lora + cfg.qk_rope) + cfg.kv_lora * H * cfg.qk_nope
                + cfg.kv_lora * H * cfg.v_head + H * cfg.v_head * cfg.d_model)
    H = cfg.pad_heads_to or cfg.n_heads
    return cfg.d_model * (2 * H + 2 * cfg.n_kv_heads) * cfg.head_dim


def _qk_dim(cfg) -> int:
    """The width the prefill's scores and context run at: q/k's head width
    (MLA pads v to it)."""
    return cfg.qk_nope + cfg.qk_rope if cfg.use_mla else cfg.head_dim


def lm_matmul_params(cfg) -> int:
    """Weights one token multiplies in the layer stacks in the model's dtype
    (no head, no table, no router): per layer its attention and its FFN --
    a dense SwiGLU, or the token's top-k experts and the shared experts.
    Enc-dec: a decoder token's self attention, its cross attention's q and
    o (k and v are the frames', ``enc_matmul_params``) and the GELU FFN.
    xLSTM: the mLSTM layers' ``up``, q, k, v and ``down`` (the f32 gates are
    ``xlstm_f32_ops``'), the sLSTM layers' ``w_in``, ``w_rec`` and ``down``.
    Hybrid: the attention layers' attention, the Mamba layers'
    ``mamba_params``, and each layer's dense FFN or top-k experts."""
    from repro_torch.models.model import block_kinds

    d = cfg.d_model
    if cfg.family == "encdec":
        H = cfg.pad_heads_to or cfg.n_heads
        return cfg.n_layers * (_attn_params(cfg) + 2 * d * H * cfg.head_dim + 2 * d * cfg.d_ff)
    if cfg.family == "xlstm":
        di, n_s = cfg.d_inner, cfg.n_layers // cfg.slstm_every
        return (cfg.n_layers - n_s) * (2 * d * di + 3 * di * di + di * d) + n_s * 9 * d * d
    _, _, n_dense, n_moe = block_kinds(cfg)
    f = cfg.d_expert or cfg.d_ff
    moe = 3 * cfg.d_model * f * (cfg.moe_topk + cfg.n_shared_experts)
    if cfg.family == "hybrid":
        n_attn = n_attn_layers(cfg)
        return (n_attn * _attn_params(cfg) + (cfg.n_layers - n_attn) * mamba_params(cfg)
                + n_dense * 3 * d * cfg.d_ff + n_moe * moe)
    return (n_dense * (_attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff)
            + n_moe * (_attn_params(cfg) + moe))


def n_attn_layers(cfg) -> int:
    """The layers with attention, and a k/v cache: the hybrid's one a
    superblock, every layer elsewhere."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def mamba_params(cfg) -> int:
    """The model-dtype weights one token multiplies in a Mamba mixer:
    ``in_proj``, ``x_proj`` and ``out_proj`` (``dt_proj`` is f32:
    ``mamba_f32_ops``)."""
    di = cfg.d_inner
    return cfg.d_model * 2 * di + di * (cfg.dt_rank + 2 * cfg.d_state) + di * cfg.d_model


def mamba_f32_ops(cfg, B: int, S: int) -> int:
    """The hybrid's f32 work of B x S tokens in its Mamba layers: a token's
    ``dt_proj`` product (2 dt_rank d_inner), conv (2 d_conv d_inner) and
    per (d_inner, d_state) element the recurrence's least work -- ``dA =
    exp(dt A)`` (2), ``dB x`` (1), ``h = dA h + dB x`` (2) and the
    contraction with C (2); a decode step's (S = 1) the same."""
    n_m = cfg.n_layers - n_attn_layers(cfg)
    di = cfg.d_inner
    return n_m * B * S * (2 * cfg.dt_rank * di + 2 * cfg.d_conv * di + 7 * di * cfg.d_state)


def enc_matmul_params(cfg) -> int:
    """Enc-dec: weights one frame multiplies -- every encoder layer's
    attention and GELU FFN, and every decoder layer's cross-attention k and
    v of the encoder's output."""
    kv = 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    return cfg.enc_layers * (_attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff) + cfg.n_layers * kv


def xlstm_f32_ops(cfg, B: int, S: int) -> int:
    """xLSTM: the f32 products of B x S tokens -- each mLSTM layer's gates
    and its chunks' intra-chunk terms per head (the L x L scores, the
    decayed values and normalizer: 6 L^2 dh a chunk) and inter-chunk terms
    (q against C and the carried C: 4 L dh^2; q against N, the normalizer
    and the carried N: 6 L dh). S = 1 is a decode step's (q against C and
    N, and the gates)."""
    H, di = cfg.n_heads, cfg.d_inner
    dh, n_m = di // H, cfg.n_layers - cfg.n_layers // cfg.slstm_every
    gates = 2 * B * S * di * 2 * H
    if S == 1:
        return n_m * (gates + 2 * B * H * (dh * dh + dh))
    L = min(cfg.ssm_chunk, S)
    return n_m * (gates + B * H * S * (6 * L * dh + 4 * dh * dh + 6 * dh))


def _padded(cfg, n: int) -> int:
    """A key length padded to the masked scan's chunk."""
    C = min(cfg.attn_chunk, n)
    return -(-n // C) * C


def enc_len(cfg, S: int) -> int:
    """Enc-dec: the frames' (and the cross cache's) length at sequence S
    (at S >= 256 both TokenPipeline's and ``cache_shape``'s S // 4)."""
    return max(S // cfg.enc_frames_div, 64)


def lm_forward_ops(cfg, B: int, S: int, S_enc: int = 0):
    """``(bf16, f32)`` operations of one forward over B x S tokens, no head:
    the layer stacks' products and the masked scans' scores over every
    (query, key) pair of the padded key length (QK and PV, at q/k's head
    width); the routers' products at the f32 rate. Enc-dec: also the
    encoder over B x ``S_enc`` f32 frames (TokenPipeline's; f32 frames make
    the encoder's products, the cross attention's k and v and its scores
    f32, as JAX promotes them), its scores, and the cross scores. xLSTM:
    no scores; ``xlstm_f32_ops``. Hybrid: the attention layers' scores;
    ``mamba_f32_ops``."""
    H = cfg.pad_heads_to or cfg.n_heads
    bf16, f32 = 2 * B * S * lm_matmul_params(cfg), lm_router_ops(cfg, B * S)
    if cfg.family == "xlstm":
        return bf16, f32 + xlstm_f32_ops(cfg, B, S)
    if cfg.family == "hybrid":
        f32 += mamba_f32_ops(cfg, B, S)
    bf16 += 4 * n_attn_layers(cfg) * B * H * S * _padded(cfg, S) * _qk_dim(cfg)
    if cfg.family == "encdec":
        f32 += 2 * B * S_enc * enc_matmul_params(cfg) + 4 * B * H * cfg.head_dim * _padded(
            cfg, S_enc) * (cfg.n_layers * S + cfg.enc_layers * S_enc)
    return bf16, f32


def lm_router_ops(cfg, T: int) -> int:
    """The routers' f32 products for ``T`` tokens (all padded experts), in
    each MoE layer (``block_kinds``: the hybrid's every ``moe_every``-th)."""
    from repro_torch.models.model import block_kinds
    from repro_torch.models.moe import n_experts_padded

    n_moe = block_kinds(cfg)[3]
    return 2 * T * n_moe * cfg.d_model * n_experts_padded(cfg) if n_moe else 0


def lm_ops_ms(bf16_ops: int, f32_ops: int = 0) -> float:
    return (bf16_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3


def lm_cache_bytes(cfg, B: int, S: int) -> int:
    """The decode cache's bytes: bf16 k and v per layer, or MLA's latent and
    rope key; enc-dec's self k and v and its cross cache (``enc_len``
    slots); xLSTM's f32 states (C, N, m of every mLSTM layer; c, n, h, m
    of every sLSTM layer), whatever S; the hybrid's k and v in its
    attention layers and its Mamba layers' f32 ``h`` and ``conv``
    (``mamba_state_bytes``)."""
    if cfg.family == "xlstm":
        H, d = cfg.n_heads, cfg.d_model
        dh, n_s = cfg.d_inner // H, cfg.n_layers // cfg.slstm_every
        return 4 * B * ((cfg.n_layers - n_s) * H * (dh * dh + dh + 1) + n_s * 4 * d)
    per_slot = cfg.kv_lora + cfg.qk_rope if cfg.use_mla else 2 * cfg.n_kv_heads * cfg.head_dim
    cross = cfg.n_layers * B * enc_len(cfg, S) * per_slot * 2 if cfg.family == "encdec" else 0
    return n_attn_layers(cfg) * B * S * per_slot * 2 + cross + mamba_state_bytes(cfg, B)


def mamba_state_bytes(cfg, B: int) -> int:
    """The hybrid's f32 Mamba states of B rows (``h`` and ``conv`` of every
    Mamba layer; 0 for the other families)."""
    if cfg.family != "hybrid":
        return 0
    n_m = cfg.n_layers - n_attn_layers(cfg)
    return 4 * n_m * B * cfg.d_inner * (cfg.d_state + cfg.d_conv - 1)


def lm_decode_bound(cfg, model, B: int, S: int, chosen=None):
    """``(ms, bytes, operations)`` of one decode step: every weight read
    once but the table (B rows) and, for MoE, the experts no token of the
    step chose (``chosen``: the distinct experts chosen, summed over the MoE
    layers; every expert where None), the whole cache read and one slot
    written (enc-dec: the cross cache read; xLSTM: every state read and
    written; the hybrid: its attention layers' k and v read and one slot
    written, its Mamba states read and written), the logits written; the
    products (the routers', xLSTM's and the Mamba layers' f32 ones at the
    f32 rate), and the scores over every slot of the attention layers (MLA:
    the latent's and the rope key's widths, and the context over the
    latent; enc-dec: the cross cache's slots too)."""
    H = cfg.pad_heads_to or cfg.n_heads
    el = model.embed.table.element_size()
    cache = lm_cache_bytes(cfg, B, S)
    unchosen = 0
    if chosen is not None and cfg.n_experts:
        from repro_torch.models.model import block_kinds
        from repro_torch.models.moe import n_experts_padded

        f = cfg.d_expert or cfg.d_ff
        n_moe = block_kinds(cfg)[3]
        unchosen = (n_moe * n_experts_padded(cfg) - chosen) * 3 * cfg.d_model * f * el
    if cfg.family == "xlstm":
        traffic, scores = 2 * cache, 0
    elif cfg.family == "encdec":
        self_slot = cfg.n_layers * B * 2 * cfg.n_kv_heads * cfg.head_dim * 2
        traffic = cache + self_slot
        scores = 4 * B * H * (S + enc_len(cfg, S)) * cfg.head_dim
    else:
        state = mamba_state_bytes(cfg, B)
        traffic = cache - state + (cache - state) // S + 2 * state
        if cfg.use_mla:
            scores = 2 * B * H * S * (2 * cfg.kv_lora + cfg.qk_rope)
        else:
            scores = 4 * B * H * S * cfg.head_dim
    nbytes = (lm_bytes(model) - model.embed.table.numel() * el - unchosen + B * cfg.d_model * el
              + traffic + B * cfg.vocab * el)
    ops = 2 * B * (lm_matmul_params(cfg) + cfg.d_model * cfg.vocab) + n_attn_layers(cfg) * scores
    f32 = lm_router_ops(cfg, B) + (xlstm_f32_ops(cfg, B, 1) if cfg.family == "xlstm" else 0) \
        + mamba_f32_ops(cfg, B, 1) * (cfg.family == "hybrid")
    ms = max(nbytes / HBM_BYTES_PER_S * 1e3, lm_ops_ms(ops, f32))
    return ms, nbytes, ops


def lm_prefill_bound(cfg, model, B: int, S: int, S_enc: int = 0):
    """``(ms, operations, bytes)`` of one prefill: ``lm_forward_ops`` (the
    f32 ones at the f32 rate; ``operations`` counts the bf16 ones) and the
    head at the last position; every weight but the table read once, the
    tokens (and enc-dec's f32 frames) read, the logits written."""
    bf16, f32 = lm_forward_ops(cfg, B, S, S_enc)
    ops = bf16 + 2 * B * cfg.d_model * cfg.vocab
    el = model.embed.table.element_size()
    nbytes = lm_bytes(model) - model.embed.table.numel() * el + B * S * (cfg.d_model * el + 4) \
        + B * S_enc * cfg.d_model * 4 + B * cfg.vocab * el
    return max(lm_ops_ms(ops, f32), nbytes / HBM_BYTES_PER_S * 1e3), ops, nbytes


def rel_err(got, want, block: int = 1 << 26) -> float:
    """max |got - want| over max |want|, both as f32, on ``got``'s device
    (the card's copy of a CPU tensor is one block at a time; an f32 max of
    differences is the same there as on the host)."""
    g, w = got.detach().reshape(-1), want.detach().reshape(-1)
    diff = top = 0.0
    for i in range(0, g.numel(), block):
        a, b = g[i:i + block].float(), w[i:i + block].to(g.device).float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite values")
        diff = max(diff, float((a - b).abs().max()))
        top = max(top, float(b.abs().max()))
    if not top:  # an all-zero reference (Adafactor's sentinel of a 1-D leaf)
        return 0.0 if not diff else float("inf")
    return diff / top


def first_ids(ids: np.ndarray, n: int) -> np.ndarray:
    """Each row's first ``n`` retrieved ids (slots >= 0, in slot order),
    padded with -1."""
    out = np.full((ids.shape[0], n), -1, np.int64)
    for i, row in enumerate(ids):
        hit = row[row >= 0][:n]
        out[i, :hit.size] = hit
    return out


def decode_against_prefill(steps, params, toks, moe: bool = False, frames=None) -> float:
    """``decode_prefill_gap``; fails above ``LM_REL``."""
    err = decode_prefill_gap(steps, params, toks, moe, frames)
    if err > LM_REL:
        S = toks.shape[1]
        raise AssertionError(f"decode after {S} steps differs from prefill: {err} > {LM_REL}")
    return err


def decode_prefill_gap(steps, params, toks, moe: bool = False, frames=None) -> float:
    """The last of ``toks.shape[1]`` teacher-forced decode steps' logits
    against ``prefill_step`` at the last position, relative to the largest
    prefill logit. The decode starts from
    ``start_cache`` (enc-dec: the cross cache filled from ``frames``,
    which prefill reads too; xLSTM: ``init_*_state``). With ``moe`` each
    decode step replays prefill's expert choices for its tokens
    (``RoutingLog``): a token's top-k experts are a discontinuous function
    of its router logits, and the two paths' roundings may flip a near tie.
    It needs a capacity (``params.cfg``'s) of at least ``B * S``, so that
    none binds at prefill (decode, a token a row, drops nothing)."""
    from repro_torch.models.moe import _capacity

    B, S = toks.shape
    if moe and _capacity(B * S, params.cfg, params.cfg.n_experts) < B * S:
        raise ValueError(f"{B * S} tokens: a capacity could bind at prefill")
    batch = dict(tokens=toks) if frames is None else dict(tokens=toks, frames=frames)
    with RoutingLog(keep=True) if moe else contextlib.nullcontext() as pl:
        want = steps.prefill_step(params, batch)
    replay = None
    if moe:  # call t * L + layer of the decode is prefill's layer at position t
        L = len(pl.calls)
        replay = types.SimpleNamespace(calls=[
            dict(top_idx=pl.calls[layer]["top_idx"].view(B, S, -1)[:, t])
            for t in range(S) for layer in range(L)])
    cache = start_cache(steps, params, B, S, frames)
    pos = torch.zeros((), dtype=torch.int32, device=toks.device)
    with RoutingLog(replay=replay) if moe else contextlib.nullcontext():
        for t in range(S):
            got, cache = steps.decode_step(params, cache, toks[:, t:t + 1], pos)
            pos = pos + 1
    del cache
    return rel_err(got, want)


def greedy_against_cpu(steps, params, csteps, cpu, caches, last, hn: int, err: float,
                       replay: bool = False) -> int:
    """Greedy decoding for ``hn`` steps from the last teacher-forced logits
    (``last``: the card's and the CPU's) into ``caches`` (written at
    positions ``hn`` on) on both. The tokens must be equal up to each row's
    first position where the CPU's top-2 margin is within ``err`` times its
    largest logit (a near tie: the rest of the row may follow either
    token). With ``replay`` the card replays the CPU's routing decisions
    (``RoutingLog``). Returns how many tokens were compared."""
    from repro_torch.train.decode import greedy_generate

    hb = last["cpu"].shape[0]
    ref_logits = last["cpu"].float()
    scale = float(ref_logits.abs().max())
    tok = {n: torch.argmax(last[n][:, -1:], dim=-1).to(torch.int32) for n in last}
    cpu_toks, margins = [tok["cpu"]], []
    c, pos_c = caches["cpu"], torch.tensor(hn, dtype=torch.int32)
    top = torch.topk(ref_logits[:, -1], 2, dim=-1).values
    margins.append(top[:, 0] - top[:, 1])
    with RoutingLog(keep=True) if replay else contextlib.nullcontext() as cl:
        for _ in range(hn):
            lg, c = csteps.decode_step(cpu, c, cpu_toks[-1], pos_c)
            pos_c = pos_c + 1
            top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            cpu_toks.append(torch.argmax(lg[:, -1:], dim=-1).to(torch.int32))
    with RoutingLog(replay=cl) if replay else contextlib.nullcontext():
        card_toks, _ = greedy_generate(steps, params, caches["card"], tok["card"], n_new=hn,
                                       start_pos=hn)
    cpu_seq = torch.cat(cpu_toks, dim=1)  # (hb, hn + 1): the first, then hn greedy
    card_seq = torch.cat([tok["card"].cpu(), card_toks[:, :hn].cpu()], dim=1)
    margin = torch.stack(margins, dim=1)
    compared = 0
    for r in range(hb):
        for j in range(hn + 1):
            if float(margin[r, j]) <= err * scale:
                break  # a near tie: the rest of the row may follow either token
            if int(card_seq[r, j]) != int(cpu_seq[r, j]):
                raise AssertionError(f"greedy token {j} of row {r}: card {card_seq[r].tolist()} "
                                     f"cpu {cpu_seq[r].tolist()}")
            compared += 1
    return compared


def lm_serving(dev, card: str, ds, index, snap, wl) -> None:
    """Phase 16: retrieval-augmented LM serving at published widths.

    (a) ``tinyllama-1.1b`` (bf16, weights from a seeded generator): the
    first ``LM_QUERIES`` queries of the first SKR batch through
    ``retrieve_workload`` (counts zeroed before, read after: rows 1 and 3
    must launch; ids of the queries without overflow equal
    ``execute_serial``), each query's first ``LM_PROMPT`` ids modulo the
    vocabulary teacher-forced through ``decode_step`` into a
    ``LM_CACHE``-slot cache, then ``greedy_generate(n_new=LM_NEW)``; the
    warm step's time (CUDA events) against its bound, tokens/s, peak
    device memory; ``prefill_step`` at ``LM_PREFILL`` against its bound.
    (b) decode against prefill at ``LM_CHECK`` and the card against the
    port's CPU run at ``LM_CPU``, both within ``LM_REL`` of the largest
    logit, greedy tokens equal where the CPU's top-2 margin exceeds the
    error. (c) ``LM_OTHERS`` at published widths, one short pass each.
    """
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.query import execute_serial
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import retrieve_workload
    from repro_torch.train.decode import greedy_generate
    from repro_torch.train.step import build_steps

    cfg = get_config(LM_ARCH)
    log(f"LM serving on {card}: {LM_ARCH} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads} kv={cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} {cfg.dtype}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    # (a) retrieval, then the model fed by it; launches read across both
    rows = np.arange(LM_QUERIES)
    sub = wl.subset(rows)
    _build.reset_launch_counts()
    t = time.perf_counter()
    hits = retrieve_workload(snap, sub, max_leaves=MAX_LEAVES)
    torch.cuda.synchronize()
    t_ret = time.perf_counter() - t
    exact = np.flatnonzero(np.asarray(hits["overflow"]) == 0)
    check_skr_oracle(execute_serial, index, ds, sub, hits, exact, "LM retrieval")
    prompt_ids = first_ids(np.asarray(hits["ids"]), LM_PROMPT)
    prompt = torch.from_numpy((prompt_ids % cfg.vocab).astype(np.int32)).to(dev)
    log(f"retrieval: {LM_QUERIES} queries in {t_ret:.6f} s, {exact.size} without overflow equal "
        f"execute_serial; retrieved per query min {int(np.min(hits['counts']))} max "
        f"{int(np.max(hits['counts']))}; prompt slots that are ids {(prompt_ids >= 0).mean():.4f}")

    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    params = steps.bundle.init(gen, dev)  # serving: no optimizer state
    torch.cuda.synchronize()
    log(f"init {LM_ARCH}: {lm_bytes(params)} B of weights in {time.perf_counter() - t:.3f} s")
    B = LM_QUERIES
    cache = steps.init_cache(B, LM_CACHE)
    log(f"cache: {sum(c.numel() * c.element_size() for c in cache.values())} B "
        f"({B} x {LM_CACHE} slots, bf16)")
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    t = time.perf_counter()
    for i in range(LM_PROMPT):
        logits, cache = steps.decode_step(params, cache, prompt[:, i:i + 1], pos)
        pos = pos + 1
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t = time.perf_counter()
    toks, cache = greedy_generate(steps, params, cache, first, n_new=LM_NEW, start_pos=LM_PROMPT)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    counts = _build.launch_counts()
    log(f"  launches (retrieval and LM, counts zeroed before): {rows_launched(counts)}")
    for name in ("frontier_level_narrow", "fused_verify_remap_slot"):
        if counts[name] <= 0:
            raise AssertionError(f"the LM path's retrieval never launched {name}")
    if toks.shape != (B, LM_NEW) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"greedy tokens out of range: {tuple(toks.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite decode logits")
    tpos = torch.tensor(LM_PROMPT + LM_NEW, dtype=torch.int32, device=dev)
    step_ms = time_ms(lambda: steps.decode_step(params, cache, first, tpos), iters=10, warmup=2)
    b_ms, b_bytes, b_ops = lm_decode_bound(cfg, params, B, LM_CACHE)
    log(f"decode ({card}): {LM_PROMPT} teacher-forced steps {t_prompt:.6f} s, greedy "
        f"{LM_NEW} steps {t_gen:.6f} s = {B * LM_NEW / t_gen:.3f} tokens/s "
        f"({1e3 * t_gen / LM_NEW:.6f} ms a step, host clock); warm decode_step "
        f"{step_ms:.6f} ms (CUDA events) = {B / step_ms * 1e3:.3f} tokens/s; bound {b_ms:.6f} "
        f"ms ({b_bytes} B / 3.35 TB/s; {b_ops} operations / 989 TFLOP/s): "
        f"{100 * b_ms / step_ms:.3f} % of it")
    log(f"  first row's tokens: {toks[0, :16].tolist()}")
    profile_call(f"{LM_ARCH} decode_step (B={B}, {LM_CACHE} slots)",
                 lambda: steps.decode_step(params, cache, first, tpos))
    del cache, logits
    torch.cuda.empty_cache()

    pb, ps = LM_PREFILL
    ptoks = torch.randint(0, cfg.vocab, (pb, ps), generator=gen, device=dev, dtype=torch.int32)
    out = steps.prefill_step(params, dict(tokens=ptoks))
    if out.shape != (pb, 1, cfg.vocab) or not torch.isfinite(out).all():
        raise AssertionError(f"prefill logits: {tuple(out.shape)}")
    pre_ms = time_ms(lambda: steps.prefill_step(params, dict(tokens=ptoks)), iters=3, warmup=1)
    p_ms, p_ops, p_bytes = lm_prefill_bound(cfg, params, pb, ps)
    log(f"prefill ({card}): B={pb} S={ps} masked_scan attn_chunk={cfg.attn_chunk}: "
        f"{pre_ms:.6f} ms (CUDA events) = {pb * ps / pre_ms * 1e3:.1f} tokens/s; bound "
        f"{p_ms:.6f} ms ({p_ops} operations / 989 TFLOP/s; {p_bytes} B): "
        f"{100 * p_ms / pre_ms:.3f} % of it")
    profile_call(f"{LM_ARCH} prefill_step (B={pb}, S={ps})",
                 lambda: steps.prefill_step(params, dict(tokens=ptoks)))
    log(f"peak device memory (a): {torch.cuda.max_memory_allocated() - base} B above the "
        f"phase's start ({base} B)")
    del out, ptoks

    # (b) decode against prefill, then the card against the CPU
    cb, cs = LM_CHECK
    ctoks = prompt[:cb].repeat(1, cs // LM_PROMPT + 1)[:, :cs].contiguous()
    t = time.perf_counter()
    err = decode_against_prefill(steps, params, ctoks)
    log(f"check: {cs} decode steps at B={cb} against prefill_step: max |err| / max |logit| "
        f"{err:.6f} <= {LM_REL} ({time.perf_counter() - t:.3f} s)")

    hb, hn = LM_CPU
    csteps = build_steps(cfg, device="cpu")
    cpu = copy.deepcopy(params).to("cpu")
    htoks = prompt[:hb, :hn]
    caches = dict(card=steps.init_cache(hb, 2 * hn), cpu=csteps.init_cache(hb, 2 * hn))
    t = time.perf_counter()
    errs, last = [], {}
    for i in range(hn):
        for name, st, p in (("card", steps, params), ("cpu", csteps, cpu)):
            d = st.device
            last[name], caches[name] = st.decode_step(
                p, caches[name], htoks[:, i:i + 1].to(d), torch.tensor(i, dtype=torch.int32,
                                                                        device=d))
        errs.append(rel_err(last["card"], last["cpu"]))
    err = max(errs)
    if err > LM_REL:
        raise AssertionError(f"the card's decode logits differ from the CPU's: {errs}")
    compared = greedy_against_cpu(steps, params, csteps, cpu, caches, last, hn, err)
    log(f"check: the card against the port's CPU run at full width, B={hb}, {hn} decode steps: "
        f"max |err| / max |logit| {err:.6f} <= {LM_REL} (per step {[f'{e:.6f}' for e in errs]}); "
        f"greedy tokens equal at {compared} of {hb * (hn + 1)} positions (compared up to each "
        f"row's first CPU top-2 margin within the error) ({time.perf_counter() - t:.3f} s)")
    del params, cpu, caches
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the other configs of the path at their published widths
    sb, ss, sn = LM_SHORT
    for arch in LM_OTHERS:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        cfg = get_config(arch)
        steps = build_steps(cfg, device=dev)
        params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        toks = torch.randint(0, cfg.vocab, (sb, ss), generator=gen, device=dev, dtype=torch.int32)
        batch = dict(tokens=toks)
        if cfg.family == "vlm":
            batch["patches"] = torch.randn((sb, cfg.n_patches, cfg.d_model), generator=gen,
                                           device=dev).to(torch.bfloat16)
        out = steps.prefill_step(params, batch)
        pre_ms = time_ms(lambda: steps.prefill_step(params, batch), iters=2, warmup=1)
        if out.shape != (sb, 1, cfg.vocab) or not torch.isfinite(out).all():
            raise AssertionError(f"{arch}: prefill logits {tuple(out.shape)}")
        err = decode_against_prefill(steps, params, toks[:, :sn])
        H = cfg.pad_heads_to or cfg.n_heads
        pad_note = ""
        if H > cfg.n_heads:
            g, g_pad = cfg.n_heads // cfg.n_kv_heads, H // cfg.n_kv_heads
            pad = torch.arange(H, device=dev) % g_pad >= g
            attn = params.dense_blocks.attn
            if attn.wq[:, :, pad].any() or attn.wo[:, pad].any():
                raise AssertionError(f"{arch}: a padded head slot is not zero")
            pad_note = f"; {int(pad.sum())} padded head slots of {H} zero in wq and wo"
        n_seq = ss + (cfg.n_patches if cfg.family == "vlm" else 0)
        log(f"{arch} ({card}): {lm_bytes(params)} B of weights; prefill B={sb} S={n_seq}"
            f"{f' ({cfg.n_patches} patches)' if cfg.family == 'vlm' else ''} {pre_ms:.6f} "
            f"ms (CUDA events), logits finite; {sn} decode steps against prefill: "
            f"{err:.6f} <= {LM_REL}{pad_note}; peak device memory "
            f"{torch.cuda.max_memory_allocated()} B ({time.perf_counter() - t:.3f} s)")
        del params, out, batch, toks
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------ LM training (phase 17)
TRAIN_ARCH = "tinyllama-1.1b"  # published config: bf16, AdamW, remat="full"
TRAIN_SHAPE = (4, 2048)  # (a): B, S -- 8,192 tokens a step
TRAIN_STEPS = 12  # (a): timed one by one; the first TRAIN_WARM are warm-up
TRAIN_WARM = 2
TRAIN_CPU = (1, 128)  # (b): one step at full width, the card against the CPU
TRAIN_VLM = ("phi-3-vision-4.2b", 1, 1024)  # (c): one step, batch_spec("train", S, B)
TRAIN_LOOP = (200, 220, 50, 8, 128)  # (d): steps, restart to, save every, B, S
TRAIN_OPT_STEPS = 3  # (d): steps of each optimizer, the card against the CPU
# (b) and (d): the card against the CPU, relative to each value's or leaf's
# largest magnitude; v is g^2, so twice m's relative error
TRAIN_REL = dict(loss=1e-2, grad_norm=2e-2, m=5e-2, v=1e-1)
# the optimizer's bytes a bf16 parameter: AdamW reads p, g (bf16), m, v
# (f32) and writes m, v, p; Adafactor reads p, g and writes p (its factored
# moments are a row and a column a matrix)
OPT_BYTES_PER_PARAM = dict(adamw=22, adafactor=6)


def lm_train_bound(cfg, n_params: int, B: int, S: int, S_enc: int = 0):
    """``(ms, operations, bytes)`` of one training step: four forwards'
    operations (the forward, the remat recompute and a backward of two), a
    forward being ``lm_forward_ops`` (the f32 ones at the f32 rate;
    ``operations`` counts the bf16 ones) and the head at every position;
    with an MTP block, its projection, dense block and head three times
    over (it is not recomputed); and the optimizer's bytes
    (``OPT_BYTES_PER_PARAM``)."""
    T = B * S
    head = 2 * T * cfg.d_model * cfg.vocab
    bf16, f32 = lm_forward_ops(cfg, B, S, S_enc)
    ops = 4 * (bf16 + head)
    if cfg.mtp_depth:
        H = cfg.pad_heads_to or cfg.n_heads
        scores = 4 * B * H * S * _padded(cfg, S) * _qk_dim(cfg)
        block = _attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff
        ops += 3 * (2 * T * (2 * cfg.d_model * cfg.d_model + block) + head + scores)
    nbytes = OPT_BYTES_PER_PARAM[cfg.optimizer] * n_params
    ms = max(lm_ops_ms(ops, 4 * f32), nbytes / HBM_BYTES_PER_S * 1e3)
    return ms, ops, nbytes


def check_metrics(metrics, what: str) -> None:
    for k, v in metrics.items():
        if not np.isfinite(float(v)):
            raise AssertionError(f"{what}: {k} = {float(v)}")


def card_against_cpu_losses(got, want, what: str) -> float:
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or err > TRAIN_REL["loss"]:
        raise AssertionError(f"{what}: card losses {got} against the CPU's {want}")
    return err


def lm_training(dev, card: str) -> None:
    """Phase 17: LM training on the card.

    (a) ``tinyllama-1.1b`` at its published config (bf16, AdamW,
    ``remat="full"``, weights from a seeded generator on the card) on the
    ``TokenPipeline`` of seed 0 at ``TRAIN_SHAPE``: ``TRAIN_STEPS``
    ``train_step``s, each timed with CUDA events; the warm steps' time and
    spread against ``lm_train_bound``, tokens/s, one profiled step's device
    idle share, peak device memory, every step's loss, grad_norm and lr
    finite. (b) One step at ``TRAIN_CPU`` from the same fresh state on the
    card and on the CPU: loss, grad_norm and every AdamW moment within
    ``TRAIN_REL``. (c) One step of ``phi-3-vision-4.2b`` at published
    width, ``batch_spec("train", ...)``: the text region's loss finite, peak
    memory. (d) The reduced dense config through ``train``: ``TRAIN_LOOP``
    steps with checkpoints, the loss falling, a restart to the second step
    count restored from the first; its first 3 losses, and Adafactor's and
    SGD's ``TRAIN_OPT_STEPS``, against the port's CPU runs.
    """
    import copy
    import dataclasses

    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    # (a) the published config at full width
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_SHAPE
    log(f"LM training on {card}: {TRAIN_ARCH} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"vocab={cfg.vocab} {cfg.dtype} {cfg.optimizer} remat={cfg.remat} "
        f"attn_chunk={cfg.attn_chunk}; B={B} S={S}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = build_steps(cfg, device=dev)
    t = time.perf_counter()
    state = steps.init_state(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    w_bytes = lm_bytes(state["params"])
    o_bytes = sum(x.numel() * x.element_size() for x in leaves(state["opt"]))
    log(f"init: {n_params} parameters, {w_bytes} B of weights, {o_bytes} B of f32 moments "
        f"({time.perf_counter() - t:.3f} s)")
    pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
    batches = [pipe.next_batch(cfg, dev) for _ in range(TRAIN_STEPS)]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    metrics = []
    t = time.perf_counter()
    for (start, end), batch in zip(events, batches):
        start.record()
        state, m = steps.train_step(state, batch)
        end.record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ms = [s.elapsed_time(e) for s, e in events]
    for i, m in enumerate(metrics):
        check_metrics(m, f"step {i}")
    log("  per step (loss, grad_norm, lr): " + "; ".join(
        f"{float(m['loss']):.6f} {float(m['grad_norm']):.6f} {float(m['lr']):.3e}"
        for m in metrics))
    warm = ms[TRAIN_WARM:]
    mean = float(np.mean(warm))
    b_ms, b_ops, b_bytes = lm_train_bound(cfg, n_params, B, S)
    log(f"train_step ({card}): first {ms[0]:.6f} ms; warm steps mean {mean:.6f} ms, min "
        f"{min(warm):.6f}, max {max(warm):.6f}, std {float(np.std(warm)):.6f} over {len(warm)} "
        f"(CUDA events) = {B * S / mean * 1e3:.3f} tokens/s; host wall {wall:.3f} s for "
        f"{TRAIN_STEPS} steps; bound {b_ms:.6f} ms ({b_ops} operations / 989 TFLOP/s; "
        f"{b_bytes} B / 3.35 TB/s): {100 * b_ms / mean:.3f} % of it")
    profile_call(f"{TRAIN_ARCH} train_step (B={B}, S={S})",
                 lambda: steps.train_step(state, batches[-1]))
    log(f"peak device memory (a): {torch.cuda.max_memory_allocated() - base} B above the "
        f"phase's start ({base} B); the state {w_bytes + o_bytes} B")
    del state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one step from the same fresh state on the card and on the CPU
    hb, hs = TRAIN_CPU
    state = steps.init_state(torch.Generator(device=dev).manual_seed(SEED + 1))
    csteps = build_steps(cfg, device="cpu")
    cmodel = copy.deepcopy(state["params"]).to("cpu")
    opt_init, _ = get_optimizer(cfg.optimizer)
    cstate = dict(params=cmodel, opt=opt_init(cmodel.tree()),
                  step=torch.zeros((), dtype=torch.int32))
    batch = TokenPipeline(cfg.vocab, hs, hb, seed=1).next_batch(cfg, "cpu")
    t = time.perf_counter()
    state, gm = steps.train_step(state, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    cstate, cm = csteps.train_step(cstate, batch)
    t_cpu = time.perf_counter() - t
    errs = {k: abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k])) for k in ("loss", "grad_norm")}
    for name in ("m", "v"):
        errs[name] = max(rel_err(a.detach(), b.detach()) for a, b in zip(
            leaves(getattr(state["opt"], name)), leaves(getattr(cstate["opt"], name))))
    p_err = max(rel_err(a.detach(), b.detach())
                for a, b in zip(leaves(state["params"]), leaves(cmodel)))
    for k, v in errs.items():
        if not v <= TRAIN_REL[k]:
            raise AssertionError(f"(b) the card's {k} differs from the CPU's: {v} > {TRAIN_REL[k]}")
    log(f"check: one train_step at full width, B={hb} S={hs}, the card against the port's CPU "
        f"run: loss {float(gm['loss']):.6f} / {float(cm['loss']):.6f}, errors (of the largest "
        f"value, per leaf for m and v) " + ", ".join(f"{k} {v:.6f} <= {TRAIN_REL[k]}"
                                                    for k, v in errs.items())
        + f"; parameters after the step {p_err:.6f} (lr {float(cm['lr']):.3e}); card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s")
    del state, cstate, cmodel, steps, csteps
    gc.collect()
    torch.cuda.empty_cache()

    # (c) vlm at published width
    arch, vb, vs = TRAIN_VLM
    vcfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    vsteps = build_steps(vcfg, device=dev)
    state = vsteps.init_state(torch.Generator(device=dev).manual_seed(SEED))
    n_vlm = sum(p.numel() for p in state["params"].parameters())
    spec, _ = vsteps.batch_spec("train", vs, vb)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    vbatch = dict(
        tokens=torch.randint(0, vcfg.vocab, spec["tokens"].shape, generator=gen, device=dev,
                             dtype=torch.int32),
        patches=torch.randn(spec["patches"].shape, generator=gen, device=dev).to(
            spec["patches"].dtype))
    _, loss_start = state["params"].embed_inputs(vbatch)
    state, vm = vsteps.train_step(state, vbatch)
    torch.cuda.synchronize()
    check_metrics(vm, arch)
    if loss_start != spec["patches"].shape[1]:
        raise AssertionError(f"{arch}: the text region starts at {loss_start}")
    log(f"{arch} ({card}): {n_vlm} parameters, one train_step at B={vb}, "
        f"{spec['patches'].shape[1]} patches + {spec['tokens'].shape[1]} tokens: the text "
        f"region's loss {float(vm['loss']):.6f}, grad_norm {float(vm['grad_norm']):.6f}, finite; "
        f"peak device memory {torch.cuda.max_memory_allocated() - base} B above the start "
        f"({base} B) ({time.perf_counter() - t:.3f} s)")
    del state, vsteps, vbatch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the reduced dense config through the whole loop
    n1, n2, every, lb, ls = TRAIN_LOOP
    rcfg = get_config(TRAIN_ARCH).reduced()
    with full_f32_matmul(), tempfile.TemporaryDirectory() as d:
        tc = dict(batch=lb, seq=ls, ckpt_every=every, log_every=0)
        t = time.perf_counter()
        r1 = train(rcfg, TrainConfig(n_steps=n1, ckpt_dir=d, **tc), device=dev)
        t1 = time.perf_counter() - t
        r2 = train(rcfg, TrainConfig(n_steps=n2, ckpt_dir=d, **tc), device=dev)
        first, last = float(np.mean(r1.losses[:10])), float(np.mean(r1.losses[-10:]))
        if not (r1.restored_from is None and len(r1.losses) == n1 and last < first):
            raise AssertionError(f"(d) the loss did not fall: {first} -> {last}")
        if r2.restored_from != n1 or len(r2.losses) != n2 - n1 or not np.all(
                np.isfinite(r2.losses)):
            raise AssertionError(f"(d) restart: restored_from {r2.restored_from}, "
                                 f"{len(r2.losses)} losses")
        cpu = train(rcfg, TrainConfig(n_steps=3, **tc), device="cpu")
        err = card_against_cpu_losses(r1.losses[:3], cpu.losses, "(d) adamw")
        opt_errs = {}
        for opt in ("adafactor", "sgd"):
            ocfg = dataclasses.replace(rcfg, optimizer=opt)
            got = train(ocfg, TrainConfig(n_steps=TRAIN_OPT_STEPS, **tc), device=dev).losses
            want = train(ocfg, TrainConfig(n_steps=TRAIN_OPT_STEPS, **tc), device="cpu").losses
            opt_errs[opt] = card_against_cpu_losses(got, want, f"(d) {opt}")
    log(f"(d) reduced {TRAIN_ARCH} (f32, B={lb} S={ls}) through train ({card}): {n1} steps in "
        f"{t1:.3f} s (median step {1e3 * float(np.median(r1.step_times)):.3f} ms host clock), "
        f"loss {first:.6f} (first 10) -> {last:.6f} (last 10), saves every {every}; restart to "
        f"{n2}: restored_from {r2.restored_from}, {len(r2.losses)} steps, last loss "
        f"{r2.losses[-1]:.6f}; first 3 losses against the CPU {err:.2e}, "
        + ", ".join(f"{k} {TRAIN_OPT_STEPS} steps {v:.2e}" for k, v in opt_errs.items())
        + f" <= {TRAIN_REL['loss']}")


# ------------------------------------------ MoE and MLA families (phase 18)
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
# (b): deepseek-v3's depth cut, 3 dense layers and 1 MoE layer of its 61 (the
# 61 layers are 1.3 TB in bf16); qwen2-moe keeps its 24 layers
MOE_DEPTH = {"deepseek-v3-671b": 4}
MOE_PREFILL = {"qwen2-moe-a2.7b": (8, 2048), "deepseek-v3-671b": (1, 2048)}  # (B, S)
# (B, slots) of the decode: qwen2-moe's 24 layers of 16 kv heads x 128 hold
# 196,608 B of bf16 cache a slot, so 128 rows x 4,096 slots would be 103 GB
# beside 30.3 GB of weights; it decodes into 1,024 slots (25.8 GB). The
# latent cache of deepseek-v3's cut is 4,608 B a slot: 2.4 GB at 4,096.
MOE_DECODE = {"qwen2-moe-a2.7b": (128, 1024), "deepseek-v3-671b": (128, 4096)}
MOE_STEPS = (4, 8)  # teacher-forced steps, then greedy tokens, at the decode shape
# decode against prefill: (B, S), the decode replaying prefill's expert
# choices. At B * S <= 8 tokens no expert's capacity (8 at least) binds at
# prefill, so both compute one function; where it binds, a prefill drops
# choices that a decode (a token a row) keeps -- the reference's semantics
MOE_CHECK = (2, 4)
# ... with the weights in this dtype. Decode reads k and v rounded to the
# bf16 cache (the reference's), prefill does not; qwen2-moe's random experts
# (std 1/8, fan_in the expert count) grow that gap layer by layer: 9.2 % of
# the largest logit at 24 layers in bf16, 2.8-3.1 % in f32, 4.1 % at 8 layers
# in bf16 (tools/moe_decode_drift.py; NVIDIA H100 80GB HBM3, 700.00 W). f32
# keeps the check's 24 layers and widths within LM_REL
MOE_CHECK_DTYPE = {"qwen2-moe-a2.7b": "float32", "deepseek-v3-671b": "bfloat16"}
# (c): the card against the port's CPU run -- qwen2-moe at published width
# cut to 2 layers, deepseek-v3 at its reduced() config (None); prefill
# (B, S), then as many teacher-forced decode steps as greedy tokens
MOE_CPU = {"qwen2-moe-a2.7b": dict(n_layers=2), "deepseek-v3-671b": None}
MOE_CPU_SHAPE = (8, 16, 4)
# (d): one train_step at published width, depth cut, on the card at
# MOE_TRAIN_SHAPE against lm_train_bound; one against the CPU's
MOE_TRAIN = {"qwen2-moe-a2.7b": dict(n_layers=2),
             "deepseek-v3-671b": dict(n_layers=2, first_dense=1)}
# (B, S, config) of the step against the CPU: "published" compares the
# published-width state itself (bf16: MOE_TRAIN_REL); "reduced" the arch's
# reduced() config in f32 (MOE_TRAIN_F32). deepseek-v3's CPU step at
# published width, read once at B=1 S=32 (NVIDIA H100 80GB HBM3, 700.00 W):
# 318.8 s on the machine's 8 host cores, too long for the smoke; the card
# within vr 1.23 %, vc 3.00 % of it
MOE_TRAIN_CPU = {"qwen2-moe-a2.7b": (1, 64, "published"),
                 "deepseek-v3-671b": (1, 32, "reduced")}
MOE_TRAIN_SHAPE = (1, 2048)
MOE_TRAIN_REL = dict(TRAIN_REL, vr=TRAIN_REL["v"], vc=TRAIN_REL["v"])  # Adafactor's g^2 factors
# in f32 under full f32 products the devices differ by their sums' order:
# tests/test_torch_cuda_train.py's f32 bounds
MOE_TRAIN_F32 = dict(loss=1e-5, grad_norm=1e-5, m=1e-4, v=1e-4, vr=1e-4, vc=1e-4)
DENSE_ARCHS = ("tinyllama-1.1b", "deepseek-7b", "minitron-8b", "starcoder2-7b",
               "phi-3-vision-4.2b")


class RoutingLog:
    """The routing of every MoE call while active (``moe._route`` and
    ``moe._select`` wrapped): per call the (token, expert) choices, the
    slots capacity kept and the distinct experts chosen (0-d device
    tensors, read after the run), and with ``keep`` the routing itself on
    the host, for ``compare_routing``. With ``replay`` (another log, kept,
    or anything with such ``calls``) each call's discrete decisions -- the
    top-k experts and, where the replayed call has them, each expert's
    selected tokens -- are that log's call's instead of its own, the gates
    still this run's: one run then computes the other's function. The log
    keeps its own top-k experts."""

    def __init__(self, keep: bool = False, replay=None):
        self.keep = keep or replay is not None
        self.replay = replay
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        route, select = moe._route, moe._select

        def logged_route(x2d, w_router, cfg):
            probs, top_idx = route(x2d, w_router, cfg)
            seen = torch.zeros(probs.shape[1], dtype=torch.int32, device=probs.device)
            seen.index_fill_(0, top_idx.reshape(-1), 1)
            rec = dict(choices=top_idx.numel(), chosen=seen.sum())
            if self.keep:
                rec.update(probs=probs.detach().cpu(), top_idx=top_idx.cpu())
            self.calls.append(rec)
            if self.replay is not None:
                top_idx = self.replay.calls[len(self.calls) - 1]["top_idx"].to(top_idx.device)
            return probs, top_idx

        def logged_select(probs, top_idx, e_lo, e_n, cap):
            top_val, tok_idx = select(probs, top_idx, e_lo, e_n, cap)
            rec = self.calls[-1]
            rec.update(kept=(top_val > 0).sum(), cap=cap)
            if self.keep:
                rec.update(top_val=top_val.detach().cpu(), tok_idx=tok_idx.cpu())
            rc = self.replay.calls[len(self.calls) - 1] if self.replay is not None else {}
            if "tok_idx" in rc:  # the replayed selection at this run's gates (its experts')
                tok_idx = rc["tok_idx"][e_lo:e_lo + e_n].to(tok_idx.device)
                eids = e_lo + torch.arange(e_n, device=probs.device)
                chosen = (top_idx[None, :, :] == eids[:, None, None]).any(-1)
                score = torch.where(chosen, probs[:, e_lo:e_lo + e_n].T, -1.0)
                top_val = torch.gather(score, 1, tok_idx)
            return top_val, tok_idx

        self._patch = patched(moe, _route=logged_route, _select=logged_select)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)

    def dropped(self) -> list:
        """Per MoE call: the (token, expert) choices no slot kept."""
        return [r["choices"] - int(r["kept"]) for r in self.calls]

    def chosen(self) -> int:
        """The distinct experts chosen, summed over the calls."""
        return sum(int(r["chosen"]) for r in self.calls)


def compare_routing(g: dict, c: dict, n_experts: int, what: str) -> str:
    """One MoE call's routing on the card (``g``, a kept ``RoutingLog``
    call) against the CPU's (``c``) from inputs that differ by the devices'
    roundings alone. A token is decided where the CPU's k-th and (k+1)-th
    router log-probabilities (the logits' own gap) are further apart than
    twice the largest difference between the two runs' (no error of either
    side can then swap them): its top-k experts must be equal. An expert is
    decided where the same tokens chose it on both runs and either its
    capacity does not bind or the CPU's gates at the cut (its C-th and
    (C+1)-th chooser) are further apart than twice the gates' largest
    difference: the tokens it keeps must be equal. Where every token and
    expert is decided, the dropped choices must be equal. Returns a
    summary."""
    T, K = c["top_idx"].shape
    lg = torch.log(g["probs"][:, :n_experts].double())
    lc = torch.log(c["probs"][:, :n_experts].double())
    srt = torch.sort(lc, dim=1, descending=True).values
    decided = srt[:, K - 1] - srt[:, K] > 2 * float((lg - lc).abs().max())
    same = (torch.sort(g["top_idx"], 1).values == torch.sort(c["top_idx"], 1).values).all(1)
    if not bool(same[decided].all()):
        raise AssertionError(f"{what}: a decided token's experts differ")
    E, C = c["tok_idx"].shape
    eids = torch.arange(E)
    perr = float((g["probs"].double() - c["probs"].double()).abs().max())
    chooser = {n: (r["top_idx"][None, :, :] == eids[:, None, None]).any(-1)
               for n, r in (("card", g), ("cpu", c))}
    score = torch.where(chooser["cpu"], c["probs"].T.double(), -1.0)
    srt = torch.sort(score, dim=1, descending=True).values
    unbound = chooser["cpu"].sum(1) <= C
    cut = unbound if C >= T else unbound | (srt[:, C - 1] - srt[:, C] > 2 * perr)
    e_decided = (chooser["card"] == chooser["cpu"]).all(1) & cut
    kept = [torch.zeros((E, T), dtype=torch.bool).scatter_(1, r["tok_idx"], r["top_val"] > 0)
            for r in (g, c)]
    if not bool((kept[0] == kept[1])[e_decided].all()):
        raise AssertionError(f"{what}: a decided expert keeps other tokens")
    d = (g["choices"] - int(g["kept"]), c["choices"] - int(c["kept"]))
    whole = bool(decided.all()) and bool(e_decided.all())
    if whole and d[0] != d[1]:
        raise AssertionError(f"{what}: dropped {d[0]} on the card, {d[1]} on the CPU")
    return (f"the first MoE call's own routing: {int(decided.sum())} of {T} tokens decided "
            f"above the margin, their experts equal; {int(e_decided.sum())} of {E} expert "
            f"selections decided, their kept tokens equal; dropped choices {d[0]} on the card, "
            f"{d[1]} on the CPU" + (" (equal: every decision above the margin)" if whole else ""))


def cpu_copy(bundle, model):
    """A CPU copy of ``model``, the same bits, made leaf by leaf into an
    empty skeleton (a copy on the card first would double its share)."""
    out = type(model)(bundle.cfg, bundle.init_tree(torch.Generator(), device="meta"))
    out = out.to_empty(device="cpu")
    with torch.no_grad():
        for p, q in zip(out.parameters(), model.parameters()):
            p.copy_(q)
    return out.requires_grad_(next(model.parameters()).requires_grad)


def moe_layer_params(model):
    """The first MoE layer's ``moe`` parameters (views of the stack)."""
    return next(lp["moe"] for kind, lp in model._layers() if kind.endswith("moe"))


def moe_serving(dev, card: str, arch: str) -> None:
    """(a) / (b): ``arch`` at its published widths (``MOE_DEPTH``'s cut
    where given), bf16 weights from a seeded generator: ``prefill_step`` at
    ``MOE_PREFILL`` against its bound and the choices it dropped at
    capacity; (e) the first MoE layer's forward twice on one input with
    repeated rows, the same bits; at ``MOE_DECODE`` teacher-forced and
    greedy steps (tokens/s, host clock), a warm ``decode_step`` (CUDA
    events) against its bound with the experts its tokens chose, the
    choices it dropped, one profiled step; peak device memory; then decode
    against prefill at ``MOE_CHECK`` within ``LM_REL``, the weights drawn
    anew in ``MOE_CHECK_DTYPE``."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn_dense
    from repro_torch.train.decode import greedy_generate
    from repro_torch.train.step import build_steps

    cfg = get_config(arch)
    cut = MOE_DEPTH.get(arch)
    if cut:
        cfg = dataclasses.replace(cfg, n_layers=cut)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    params = steps.bundle.init(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{arch} on {card}: n_layers={cfg.n_layers}"
        + (f" (a depth cut: {cut} of {get_config(arch).n_layers}, first_dense="
           f"{cfg.first_dense})" if cut else "")
        + f" d_model={cfg.d_model} heads={cfg.n_heads} experts={cfg.n_experts} top-"
        f"{cfg.moe_topk} shared={cfg.n_shared_experts} d_expert={cfg.d_expert} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} mla={cfg.use_mla} {cfg.dtype}: {n_params} parameters, "
        f"{lm_bytes(params)} B of weights ({time.perf_counter() - t:.3f} s)")

    # prefill, and the choices it dropped at capacity
    pb, ps = MOE_PREFILL[arch]
    toks = torch.randint(0, cfg.vocab, (pb, ps), generator=gen, device=dev, dtype=torch.int32)
    with RoutingLog() as rl:
        out = steps.prefill_step(params, dict(tokens=toks))
    if out.shape != (pb, 1, cfg.vocab) or not torch.isfinite(out).all():
        raise AssertionError(f"{arch}: prefill logits {tuple(out.shape)}")
    drops, per = rl.dropped(), rl.calls[0]["choices"]
    pre_ms = time_ms(lambda: steps.prefill_step(params, dict(tokens=toks)), iters=3, warmup=1)
    p_ms, p_ops, p_bytes = lm_prefill_bound(cfg, params, pb, ps)
    log(f"prefill ({card}): B={pb} S={ps}: {pre_ms:.6f} ms (CUDA events) = "
        f"{pb * ps / pre_ms * 1e3:.1f} tokens/s; bound {p_ms:.6f} ms ({p_ops} bf16 operations / "
        f"989 TFLOP/s + {lm_router_ops(cfg, pb * ps)} f32 router operations / 67 TFLOP/s; "
        f"{p_bytes} B): {100 * p_ms / pre_ms:.3f} % of it; capacity {rl.calls[0]['cap']} an "
        f"expert; dropped (token, expert) choices per MoE layer {drops} of {per} "
        f"({100 * sum(drops) / (len(drops) * per):.3f} %)")
    del out

    # (e) one MoE layer's forward twice from the same input: the same bits.
    # The first half of the tokens is one vector, so its top-k experts are
    # chosen by that many tokens at equal gates: their capacity binds and the
    # tie order decides which are kept (the lowest indices, as top_k)
    mp = moe_layer_params(params)
    x = torch.randn((pb, ps, cfg.d_model), generator=gen, device=dev).to(mp["w_gate"].dtype)
    x2d = x.view(-1, cfg.d_model)
    n_tied = x2d.shape[0] // 2
    x2d[:n_tied] = x2d[0]
    with RoutingLog(keep=True) as rl:
        y1 = moe_ffn_dense(mp, x, cfg)
        y2 = moe_ffn_dense(mp, x, cfg)
    if not torch.equal(y1, y2):
        raise AssertionError(f"{arch}: two forwards of the MoE layer differ")
    r = rl.calls[0]
    if rl.dropped()[0] != rl.dropped()[1] or not torch.equal(r["tok_idx"],
                                                            rl.calls[1]["tok_idx"]):
        raise AssertionError(f"{arch}: two routings of one input differ: {rl.dropped()}")
    for e in r["top_idx"][0].tolist():
        kept = r["tok_idx"][e][r["top_val"][e] > 0]
        tied = torch.sort(kept[kept < n_tied]).values
        if not torch.equal(tied, torch.arange(tied.numel())) or tied.numel() >= n_tied:
            raise AssertionError(f"{arch}: expert {e} kept tied tokens {tied.tolist()[:8]}...")
    log(f"(e) {arch}: the first MoE layer's forward twice on one ({pb}, {ps}) input, its first "
        f"{n_tied} tokens one vector: the same bits ({y1.numel()} {str(y1.dtype)[6:]} values), "
        f"{rl.dropped()[0]} of {r['choices']} choices dropped both times (capacity "
        f"{r['cap']}); each of the tied tokens' {r['top_idx'].shape[1]} experts kept the "
        f"lowest-indexed tied tokens")
    del x, x2d, y1, y2, mp

    ctoks = toks[:MOE_CHECK[0], :MOE_CHECK[1]].clone()
    del toks

    # decode at the serving shape
    B, slots = MOE_DECODE[arch]
    n_tf, n_new = MOE_STEPS
    cache = steps.init_cache(B, slots)
    log(f"cache: {sum(c.numel() * c.element_size() for c in cache.values())} B ({B} x {slots} "
        f"slots, bf16: {sorted(cache)})")
    prompt = torch.randint(0, cfg.vocab, (B, n_tf), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    t = time.perf_counter()
    for i in range(n_tf):
        logits, cache = steps.decode_step(params, cache, prompt[:, i:i + 1], pos)
        pos = pos + 1
    torch.cuda.synchronize()
    t_tf = time.perf_counter() - t
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t = time.perf_counter()
    gtoks, cache = greedy_generate(steps, params, cache, first, n_new=n_new, start_pos=n_tf)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    if gtoks.shape != (B, n_new) or int(gtoks.min()) < 0 or int(gtoks.max()) >= cfg.vocab:
        raise AssertionError(f"{arch}: greedy tokens {tuple(gtoks.shape)}")
    tpos = torch.tensor(n_tf + n_new, dtype=torch.int32, device=dev)
    with RoutingLog() as rl:
        logits = steps.decode_step(params, cache, first, tpos)[0]  # the cache is ``cache``
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: non-finite decode logits")
    chosen = rl.chosen()
    step_ms = time_ms(lambda: steps.decode_step(params, cache, first, tpos), iters=10, warmup=2)
    b_ms, b_bytes, b_ops = lm_decode_bound(cfg, params, B, slots, chosen=chosen)
    log(f"decode ({card}): {n_tf} teacher-forced steps {t_tf:.6f} s, greedy {n_new} steps "
        f"{t_gen:.6f} s = {B * n_new / t_gen:.3f} tokens/s (host clock); warm decode_step "
        f"{step_ms:.6f} ms (CUDA events) = {B / step_ms * 1e3:.3f} tokens/s; bound {b_ms:.6f} ms "
        f"({b_bytes} B / 3.35 TB/s, the weights of the {chosen} experts the step's tokens chose "
        f"over its {len(rl.calls)} MoE layers; {b_ops} bf16 operations / 989 TFLOP/s): "
        f"{100 * b_ms / step_ms:.3f} % of it; dropped choices a step per MoE layer "
        f"{rl.dropped()} of {rl.calls[0]['choices']} (capacity {rl.calls[0]['cap']})")
    log(f"  first row's tokens: {gtoks[0].tolist()}")
    profile_call(f"{arch} decode_step (B={B}, {slots} slots)",
                 lambda: steps.decode_step(params, cache, first, tpos))
    log(f"peak device memory ({arch}): {torch.cuda.max_memory_allocated() - base} B above the "
        f"start ({base} B)")
    del params, cache, logits, steps

    # decode against prefill where no capacity binds, prefill's experts
    # replayed, the weights drawn anew in MOE_CHECK_DTYPE
    gc.collect()
    torch.cuda.empty_cache()
    ccfg = dataclasses.replace(cfg, dtype=MOE_CHECK_DTYPE[arch])
    csteps = build_steps(ccfg, device=dev)
    t = time.perf_counter()
    cparams = csteps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    err = decode_against_prefill(csteps, cparams, ctoks, moe=True)
    log(f"check: {ctoks.shape[1]} decode steps at B={ctoks.shape[0]} against prefill_step, "
        f"{ccfg.n_layers} layers, {ccfg.dtype} weights, the cache bf16 (no capacity binds at "
        f"{ctoks.numel()} tokens; each step replaying prefill's expert choices): max |err| / "
        f"max |logit| {err:.6f} <= {LM_REL} ({time.perf_counter() - t:.3f} s)")
    del cparams, csteps


def moe_card_against_cpu(dev, card: str, arch: str, cfg=None, rel: float = LM_REL,
                         shape=MOE_CPU_SHAPE, part: str = "(c)") -> None:
    """(c): ``arch`` cut as ``MOE_CPU`` says (or ``cfg``), one set of
    weights on the card and on the CPU: prefill at ``shape``, then
    teacher-forced decode steps and greedy tokens, the card replaying the
    CPU's routing decisions (``RoutingLog``) so that both compute one
    function: every row's logits within ``rel``, greedy tokens equal above
    the top-2 margin. The card's own routing is held once, on the first MoE
    call of a prefill with its own decisions, by ``compare_routing``'s
    margin rule."""
    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_steps

    cut = MOE_CPU.get(arch)
    if cfg is None:
        cfg = get_config(arch)
        cfg = cfg.reduced() if cut is None else dataclasses.replace(cfg, **cut)
    steps, csteps = build_steps(cfg, device=dev), build_steps(cfg, device="cpu")
    t = time.perf_counter()
    params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED + 3), dev)
    cpu = cpu_copy(csteps.bundle, params)
    B, S, n = shape
    toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(SEED + 3),
                         dtype=torch.int32)
    with full_f32_matmul():
        with RoutingLog(keep=True) as cl:
            want = csteps.prefill_step(cpu, dict(tokens=toks))
        with RoutingLog(keep=True) as own:
            steps.prefill_step(params, dict(tokens=toks.to(dev)))
        routing = compare_routing(own.calls[0], cl.calls[0], cfg.n_experts, f"{arch} prefill")
        with RoutingLog(replay=cl):
            got = steps.prefill_step(params, dict(tokens=toks.to(dev)))
        pre_err = rel_err(got, want)
        if pre_err > rel:
            raise AssertionError(f"{arch}: the card's prefill logits differ: {pre_err}")
        caches = dict(card=steps.init_cache(B, 2 * n), cpu=csteps.init_cache(B, 2 * n))
        last, logits, dl = {}, {}, {}
        for name, st, p in (("cpu", csteps, cpu), ("card", steps, params)):
            d = st.device
            dl[name] = RoutingLog(keep=True) if name == "cpu" else RoutingLog(replay=dl["cpu"])
            logits[name] = []
            with dl[name]:
                for i in range(n):
                    last[name], caches[name] = st.decode_step(
                        p, caches[name], toks[:, i:i + 1].to(d),
                        torch.tensor(i, dtype=torch.int32, device=d))
                    logits[name].append(last[name])
        errs = [rel_err(g, w) for g, w in zip(logits["card"], logits["cpu"])]
        err = max(errs)
        if err > rel:
            raise AssertionError(f"{arch}: the card's decode logits differ: {errs}")
        compared = greedy_against_cpu(steps, params, csteps, cpu, caches, last, n, err,
                                      replay=True)
    log(f"check {part} {arch} ({'reduced()' if cut is None else f'published width, {cut}'}, "
        f"{cfg.dtype}), the card against the port's CPU run: prefill B={B} S={S}: {routing}; "
        f"the card replaying the CPU's routing from here: prefill max |err| / max |logit| "
        f"{pre_err:.3e} <= {rel}; {n} decode steps at B={B} "
        f"{[f'{e:.3e}' for e in errs]} <= {rel}; greedy tokens equal at {compared} of "
        f"{B * (n + 1)} positions (compared up to each row's first CPU top-2 margin within the "
        f"error); the CPU dropped {sum(dl['cpu'].dropped())} choices over the decode's "
        f"{len(dl['cpu'].calls)} MoE calls ({time.perf_counter() - t:.3f} s)")
    del params, cpu, caches


def train_step_against_cpu(dev, cfg, steps, state, hb: int, hs: int, what: str, rel: dict):
    """One ``train_step`` at (``hb``, ``hs``) from ``state`` (fresh, on the
    card) and from its copy on the CPU, the card replaying the CPU's
    routing decisions at its own gates (a near tie flipped by the devices'
    roundings would send a token's gradient to another expert: the
    comparison is of the arithmetic; the card's own decisions in the first
    MoE call are held by ``compare_routing``): loss, grad_norm and each
    optimizer-state leaf within ``rel``. Returns the stepped state and a
    summary."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    csteps = build_steps(cfg, device="cpu")
    t = time.perf_counter()
    cmodel = cpu_copy(csteps.bundle, state["params"])
    cstate = dict(params=cmodel, opt=get_optimizer(cfg.optimizer)[0](cmodel.tree()),
                  step=torch.zeros((), dtype=torch.int32))
    t_copy = time.perf_counter() - t
    batch = TokenPipeline(cfg.vocab, hs, hb, seed=1).next_batch(cfg, "cpu")
    t = time.perf_counter()
    with RoutingLog(keep=True) as cl:
        cstate, cm = csteps.train_step(cstate, batch)
    t_cpu = time.perf_counter() - t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with RoutingLog(replay=cl) as gl:
        start.record()
        state, gm = steps.train_step(state, {k: v.to(dev) for k, v in batch.items()})
        end.record()
        end.synchronize()
    check_metrics(gm, what)
    # the first call's experts are the card's own (the log keeps them), and
    # an expert its choosers agree on selects from the same tokens either way
    own = (compare_routing(gl.calls[0], cl.calls[0], cfg.n_experts, what) if cl.calls
           else "no MoE call")
    errs = {k: abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k])) for k in ("loss", "grad_norm")}
    for name in type(state["opt"])._fields:
        errs[name] = max(rel_err(a, b) for a, b in zip(leaves(getattr(state["opt"], name)),
                                                       leaves(getattr(cstate["opt"], name))))
    for k, v in errs.items():
        if not v <= rel[k]:
            raise AssertionError(f"{what}: the card's {k} differs from the CPU's: {v} > {rel[k]}")
    replayed = (f" (replaying the CPU's routing decisions in its {len(cl.calls)} MoE calls, "
                f"forward and recompute, at its own gates)" if cl.calls else "")
    return state, (
        f"check {what}: one train_step at B={hb} S={hs}, the card{replayed} "
        f"against the port's CPU run: loss {float(gm['loss']):.6f} / {float(cm['loss']):.6f}, "
        f"errors (of the largest value, per leaf for the optimizer's state) " + ", ".join(
            f"{k} {v:.3e} <= {rel[k]}" for k, v in errs.items())
        + (f"; {own}" if cl.calls else "") + f"; card {start.elapsed_time(end):.3f} ms (CUDA "
        f"events), CPU {t_cpu:.3f} s, the CPU copy {t_copy:.3f} s")


def moe_training(dev, card: str, arch: str) -> None:
    """(d): ``arch`` at published width cut to ``MOE_TRAIN``'s depth, with
    its published optimizer and ``remat="full"``: where ``MOE_TRAIN_CPU``
    says ``"published"``, one step from the fresh state against the CPU's
    (``train_step_against_cpu``); one step on the card at
    ``MOE_TRAIN_SHAPE`` (CUDA events) against ``lm_train_bound``, peak
    device memory; where it says ``"reduced"``, the step against the CPU
    at the arch's ``reduced()`` config (f32, ``remat="full"``, within
    ``MOE_TRAIN_F32``)."""
    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(arch), **MOE_TRAIN[arch])
    hb, hs, at = MOE_TRAIN_CPU[arch]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    steps = build_steps(cfg, device=dev)
    state = steps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    w_bytes = lm_bytes(state["params"])
    o_bytes = sum(x.numel() * x.element_size() for x in leaves(state["opt"]))
    log(f"(d) {arch} on {card}: {MOE_TRAIN[arch]} of the published config, {cfg.optimizer}, "
        f"remat={cfg.remat}: {n_params} parameters, {w_bytes} B of weights, {o_bytes} B of "
        f"optimizer state ({time.perf_counter() - t:.3f} s)")
    if at == "published":
        state, line = train_step_against_cpu(dev, cfg, steps, state, hb, hs, f"(d) {arch}",
                                             MOE_TRAIN_REL)
        log(line + f"; peak device memory {torch.cuda.max_memory_allocated() - base} B above "
            f"the start")
        gc.collect()

    B, S = MOE_TRAIN_SHAPE
    batch = TokenPipeline(cfg.vocab, S, B, seed=2).next_batch(cfg, dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, m = steps.train_step(state, batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    check_metrics(m, f"(d) {arch}")
    b_ms, b_ops, b_bytes = lm_train_bound(cfg, n_params, B, S)
    log(f"(d) {arch} train_step ({card}): B={B} S={S} {ms:.6f} ms (CUDA events, the state's "
        f"{'second' if at == 'published' else 'first'} step) = {B * S / ms * 1e3:.3f} tokens/s, "
        f"loss {float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}; bound "
        f"{b_ms:.6f} ms ({b_ops} bf16 operations / 989 TFLOP/s + "
        f"{4 * lm_router_ops(cfg, B * S)} f32 router operations; {b_bytes} B / 3.35 TB/s): "
        f"{100 * b_ms / ms:.3f} % of it; peak device memory "
        f"{torch.cuda.max_memory_allocated() - base} B above the start ({base} B), the state "
        f"{w_bytes + o_bytes} B")
    del state, batch, steps
    if at == "reduced":
        gc.collect()
        torch.cuda.empty_cache()
        rcfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
        rsteps = build_steps(rcfg, device=dev)
        rstate = rsteps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
        with full_f32_matmul():
            _, line = train_step_against_cpu(dev, rcfg, rsteps, rstate, hb, hs,
                                             f"(d) {arch} reduced() ({rcfg.optimizer}, f32)",
                                             MOE_TRAIN_F32)
        log(line)


def moe_families(dev, card: str) -> None:
    """Phase 18: the MoE and MLA decoder-only families on the card.

    (a) ``qwen2-moe-a2.7b`` (24 layers, 60 routed experts padded to 64,
    top-4, 4 shared) and (b) ``deepseek-v3-671b`` (MLA, 256 routed experts,
    top-8, 1 shared, the MTP block) depth cut to 4 layers (3 dense, one
    MoE), both at their published widths: ``moe_serving``. (c) the card
    against the port's CPU run on the same weights:
    ``moe_card_against_cpu``. (d) one ``train_step`` of each at published
    width, depth cut: ``moe_training``. (e) inside (a) and (b): one MoE
    layer's forward twice on the card, the same bits.
    """
    from repro_torch.configs import get_config

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the routers' f32 products would be rounded")
    # the bound helpers keep the dense families' numbers
    for c in map(get_config, DENSE_ARCHS):
        H = c.pad_heads_to or c.n_heads
        assert lm_matmul_params(c) == c.n_layers * (c.d_model * (2 * H + 2 * c.n_kv_heads) * c.head_dim + 3 * c.d_model * c.d_ff) and not lm_router_ops(c, 1), c.name  # noqa: E501
    for arch in MOE_ARCHS:
        with phase(f"{arch} serving"):
            moe_serving(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_ARCHS:
        with phase(f"{arch} card against CPU"):
            moe_card_against_cpu(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_ARCHS:
        with phase(f"{arch} train_step"):
            moe_training(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------ enc-dec and xLSTM families (phase 19)
SEQ_ARCHS = ("whisper-base", "xlstm-125m")
SEQ_PREFILL = (8, 2048)  # (B, S); whisper's TokenPipeline frames then (8, 512, 512) f32
# (B, slots): whisper's self cache 3.22 GB at 2,048 slots and its cross cache
# (512 slots) 0.81 GB; xLSTM's states 3.03 GB whatever the slots
SEQ_DECODE = (128, 2048)
SEQ_STEPS = (4, 8)  # teacher-forced steps, then greedy tokens, at the decode shape
# the prefills profiled: xLSTM's makes 256,641 host aten calls (its sLSTM's
# time loop), and its profile took 61.3 s to summarize (NVIDIA H100 80GB
# HBM3, 700.00 W)
SEQ_PROFILE_PREFILL = ("whisper-base",)
SEQ_CHECK = (8, 256)  # decode against prefill: (B, teacher-forced steps); whisper: 64 frames
# ... with the weights in this dtype. xLSTM's bf16 residual stream rounds
# differently in the chunked mixer and the recurrent decode, and its
# exponential gates grow that gap with depth: at published width over 12
# layers 15.1 % of the largest logit in the reference's own bf16 run
# (tools/reference_seq_drift.py, JAX on the CPU, B = 2, S = 256), 9.6e-5 in
# f32 (tools/seq_decode_drift.py has the port's). f32 weights keep the
# check's 12 layers and widths within LM_REL; whisper stays bf16
SEQ_CHECK_DTYPE = {"whisper-base": "bfloat16", "xlstm-125m": "float32"}
# (c): the card against the port's CPU run on one set of weights, at the
# arch's reduced() config (f32, full f32 products) and at published width
# cut to 2 layers (bf16; xLSTM's unit cut to one mLSTM and one sLSTM layer):
# prefill (B, S), then as many teacher-forced decode steps as greedy tokens
SEQ_CPU_CUT = {"whisper-base": dict(n_layers=2, enc_layers=2),
               "xlstm-125m": dict(n_layers=2, slstm_every=2)}
SEQ_CPU_SHAPE = (4, 16, 4)
SEQ_F32_REL = 1e-5  # reduced() f32, the card against the CPU (prefill; xLSTM's f32 states)
# ... what whisper's decode reads from its bf16 self cache: an f32 ulp
# apart rounds to neighbouring bf16 values (tests/test_torch_lm.py's bound)
SEQ_CACHE_REL = 2e-2
# (d): B, S of the full-depth step. xLSTM's S is cut to 512: its sLSTM
# runs a Python loop over time in the forward, the remat recompute and the
# backward, and a step at S = 2048 took 12,191-13,525 ms (NVIDIA H100 80GB
# HBM3, 700.00 W)
SEQ_TRAIN = {"whisper-base": (4, 2048), "xlstm-125m": (4, 512)}
SEQ_TRAIN_STEPS = (1, 3)  # (d): warm-up steps, then timed steps
SEQ_TRAIN_CPU = (1, 32)  # (d): reduced() f32 step, the card against the CPU
# PR 27's f32 bounds; xLSTM's exponential gates amplify f32 roundings past
# them: one f32 ulp on every weight moves its reduced() config's gradient
# leaves by up to 4.05e-4 and three steps' grad_norm by up to 8.9e-5
# (tools/seq_noise_floor.py on the CPU), so its grad_norm and state leaves
# are held to 5e-5 and 1e-3
SEQ_TRAIN_F32 = {"whisper-base": dict(loss=1e-5, grad_norm=1e-5, m=1e-4, v=1e-4),
                 "xlstm-125m": dict(loss=1e-5, grad_norm=5e-5, m=1e-3, v=1e-3)}


def fill_cross_cache(model, cache, enc_out):
    """The enc-dec cross cache from the encoder's output: each decoder
    layer's cross-attention k and v projections of it, rounded to the
    cache's bf16. (The reference fills nothing: its decode reads the zeros
    of ``cache_shape``.)"""
    from repro_torch.models.layers import _proj

    ca = model.tree()["dec_blocks"]["cross_attn"]
    with torch.no_grad():
        for i in range(cache["xk"].shape[0]):
            cache["xk"][i].copy_(_proj(enc_out, ca["wk"][i]))
            cache["xv"][i].copy_(_proj(enc_out, ca["wv"][i]))
    return cache


def start_cache(steps, params, B: int, S: int, frames=None):
    """A decode cache of (B, S) that starts where prefill does: enc-dec's
    cross cache filled from ``frames`` (``fill_cross_cache``; their length
    must be the cache's), xLSTM's stabilizers at ``init_*_state``'s
    ``-1e30`` (the zero cache starts them at 0, the reference's own decode);
    the zero cache otherwise."""
    cache = steps.init_cache(B, S)
    if steps.cfg.family == "encdec":
        if frames is None or frames.shape[1] != cache["xk"].shape[2]:
            raise ValueError(f"frames of the cross cache's {cache['xk'].shape[2]} slots needed")
        with torch.no_grad():
            return fill_cross_cache(params, cache, params.encode(frames))
    if steps.cfg.family == "xlstm":
        from repro_torch.models.xlstm import STAB_INIT

        cache["m"].fill_(STAB_INIT)
        cache["sm"].fill_(STAB_INIT)
    return cache


def seq_frames(cfg, B: int, S: int, gen, dev):
    """Enc-dec: (B, enc_len(S), d) f32 frames from ``gen`` (the cross
    cache's length at S slots), else None."""
    if cfg.family != "encdec":
        return None
    return torch.randn((B, enc_len(cfg, S), cfg.d_model), generator=gen, device=gen.device).to(
        dev)


def seq_serving(dev, card: str, arch: str) -> None:
    """(a) / (b): ``arch`` at its published widths and depth, bf16 weights
    from a seeded generator: ``prefill_step`` at ``SEQ_PREFILL`` on the
    ``TokenPipeline``'s batch (whisper: its f32 frames) against its bound,
    one profiled prefill (``SEQ_PROFILE_PREFILL``); at ``SEQ_DECODE`` a
    cache that starts where prefill does (``start_cache``: whisper's cross
    cache filled from the encoder over the pipeline's frames, timed),
    teacher-forced and greedy
    steps (tokens/s, host clock), a warm ``decode_step`` (CUDA events)
    against its bound, one profiled step (device idle share, host aten
    calls), peak memory; then (c) decode against prefill at ``SEQ_CHECK``
    within ``LM_REL``, every row, and for xLSTM the reference's own decode
    from the zero cache: finite, its gap to prefill printed."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.decode import greedy_generate
    from repro_torch.train.step import build_steps

    cfg = get_config(arch)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    params = steps.bundle.init(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    shape = (f"enc_layers={cfg.enc_layers} n_layers={cfg.n_layers} d_ff={cfg.d_ff} "
             f"heads={cfg.n_heads} enc_frames_div={cfg.enc_frames_div}"
             if cfg.family == "encdec" else
             f"n_layers={cfg.n_layers} slstm_every={cfg.slstm_every} heads={cfg.n_heads} "
             f"d_inner={cfg.d_inner} ssm_chunk={cfg.ssm_chunk}")
    log(f"{arch} on {card}: {cfg.family} d_model={cfg.d_model} {shape} vocab={cfg.vocab} "
        f"{cfg.dtype}: {n_params} parameters, {lm_bytes(params)} B of weights "
        f"({time.perf_counter() - t:.3f} s)")

    # prefill on the pipeline's batch
    pb, ps = SEQ_PREFILL
    batch = TokenPipeline(cfg.vocab, ps, pb, seed=SEED).next_batch(cfg, dev)
    s_enc = batch["frames"].shape[1] if "frames" in batch else 0
    t = time.perf_counter()
    out = steps.prefill_step(params, batch)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    if out.shape != (pb, 1, cfg.vocab) or not torch.isfinite(out).all():
        raise AssertionError(f"{arch}: prefill logits {tuple(out.shape)}")
    del out
    pre_ms = time_ms(lambda: steps.prefill_step(params, batch), iters=2, warmup=0)
    p_ms, p_ops, p_bytes = lm_prefill_bound(cfg, params, pb, ps, s_enc)
    p_f32 = lm_forward_ops(cfg, pb, ps, s_enc)[1]
    log(f"prefill ({card}): B={pb} S={ps}"
        + (f" with {tuple(batch['frames'].shape)} f32 frames" if s_enc else "")
        + f": {pre_ms:.6f} ms (CUDA events) = {pb * ps / pre_ms * 1e3:.1f} tokens/s; bound "
        f"{p_ms:.6f} ms ({p_ops} bf16 operations / 989 TFLOP/s + {p_f32} f32 operations / "
        f"67 TFLOP/s; {p_bytes} B): {100 * p_ms / pre_ms:.3f} % of it; the first call "
        f"{t_first:.3f} s (host clock)")
    if arch in SEQ_PROFILE_PREFILL:
        profile_call(f"{arch} prefill_step (B={pb}, S={ps})",
                     lambda: steps.prefill_step(params, batch))
    del batch

    # decode at the serving shape, from a cache that starts where prefill does
    B, slots = SEQ_DECODE
    n_tf, n_new = SEQ_STEPS
    dbatch = TokenPipeline(cfg.vocab, slots, B, seed=SEED + 1).next_batch(cfg, dev)
    t = time.perf_counter()
    cache = start_cache(steps, params, B, slots, dbatch.get("frames"))
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t
    prompt = dbatch["tokens"][:, :n_tf].contiguous()
    del dbatch
    log(f"cache: {sum(c.numel() * c.element_size() for c in cache.values())} B ({B} rows, "
        f"{sorted((k, tuple(c.shape), str(c.dtype)[6:]) for k, c in cache.items())}); "
        + (f"the cross cache filled from the encoder over ({B}, {cache['xk'].shape[2]}, "
           f"{cfg.d_model}) f32 frames in {t_fill:.3f} s" if cfg.family == "encdec" else
           "the stabilizers at init_*_state's -1e30"))
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    t = time.perf_counter()
    for i in range(n_tf):
        logits, cache = steps.decode_step(params, cache, prompt[:, i:i + 1], pos)
        pos = pos + 1
    torch.cuda.synchronize()
    t_tf = time.perf_counter() - t
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t = time.perf_counter()
    gtoks, cache = greedy_generate(steps, params, cache, first, n_new=n_new, start_pos=n_tf)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    if gtoks.shape != (B, n_new) or int(gtoks.min()) < 0 or int(gtoks.max()) >= cfg.vocab:
        raise AssertionError(f"{arch}: greedy tokens {tuple(gtoks.shape)}")
    tpos = torch.tensor(n_tf + n_new, dtype=torch.int32, device=dev)
    logits = steps.decode_step(params, cache, first, tpos)[0]
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: non-finite decode logits")
    step_ms = time_ms(lambda: steps.decode_step(params, cache, first, tpos), iters=10, warmup=2)
    b_ms, b_bytes, b_ops = lm_decode_bound(cfg, params, B, slots)
    log(f"decode ({card}): {n_tf} teacher-forced steps {t_tf:.6f} s, greedy {n_new} steps "
        f"{t_gen:.6f} s = {B * n_new / t_gen:.3f} tokens/s (host clock); warm decode_step "
        f"{step_ms:.6f} ms (CUDA events) = {B / step_ms * 1e3:.3f} tokens/s; bound {b_ms:.6f} ms "
        f"({b_bytes} B / 3.35 TB/s; {b_ops} bf16 operations / 989 TFLOP/s): "
        f"{100 * b_ms / step_ms:.3f} % of it")
    log(f"  first row's tokens: {gtoks[0].tolist()}")
    profile_call(f"{arch} decode_step (B={B}, {slots} slots)",
                 lambda: steps.decode_step(params, cache, first, tpos))
    log(f"peak device memory ({arch}): {torch.cuda.max_memory_allocated() - base} B above the "
        f"start ({base} B)")
    del cache, logits

    # (c) decode against prefill, every row, from the cache prefill starts at,
    # the weights drawn anew in SEQ_CHECK_DTYPE where it is not the model's
    if SEQ_CHECK_DTYPE[arch] != cfg.dtype:
        del params, steps
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, dtype=SEQ_CHECK_DTYPE[arch])
        steps = build_steps(cfg, device=dev)
        params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    cb, cs = SEQ_CHECK
    cgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    ctoks = torch.randint(0, cfg.vocab, (cb, cs), generator=cgen, device=dev, dtype=torch.int32)
    frames = seq_frames(cfg, cb, cs, cgen, dev)
    t = time.perf_counter()
    err = decode_against_prefill(steps, params, ctoks, frames=frames)
    note = ""
    if cfg.family == "xlstm":  # the reference's own decode: the zero cache
        want = steps.prefill_step(params, dict(tokens=ctoks))
        zc, zpos = steps.init_cache(cb, cs), torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(cs):
            zl, zc = steps.decode_step(params, zc, ctoks[:, i:i + 1], zpos)
            zpos = zpos + 1
        if not torch.isfinite(zl).all():
            raise AssertionError(f"{arch}: the zero cache's decode is not finite")
        note = (f"; from the zero cache (the reference's own decode, stabilizers at 0) "
                f"finite, {rel_err(zl, want):.6f} from prefill")
        del zc, want
    log(f"check (c): {cs} decode steps at B={cb} against prefill_step, every row, "
        f"{cfg.n_layers} layers, {cfg.dtype} weights, from "
        + ("the cross cache filled from the encoder over " f"{tuple(frames.shape)} frames"
           if frames is not None else "init_mlstm_state / init_slstm_state")
        + f": max |err| / max |logit| {err:.6f} <= {LM_REL}{note} "
        f"({time.perf_counter() - t:.3f} s)")
    del params, steps


def seq_card_against_cpu(dev, card: str, arch: str) -> None:
    """(c): one set of weights on the card and on the CPU, at ``arch``'s
    ``reduced()`` config (f32, full f32 products: prefill and xLSTM's
    decode within ``SEQ_F32_REL``, whisper's decode through its bf16 cache
    within ``SEQ_CACHE_REL``) and at published width cut as
    ``SEQ_CPU_CUT`` says (bf16: ``LM_REL``): prefill at ``SEQ_CPU_SHAPE``,
    teacher-forced decode steps from ``start_cache`` on each device, then
    greedy tokens equal above the CPU's top-2 margin."""
    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_steps

    B, S, n = SEQ_CPU_SHAPE
    for label, cfg in (("reduced() f32", get_config(arch).reduced()),
                       (f"published width, {SEQ_CPU_CUT[arch]}",
                        dataclasses.replace(get_config(arch), **SEQ_CPU_CUT[arch]))):
        f32 = cfg.dtype == "float32"
        pre_rel = SEQ_F32_REL if f32 else LM_REL
        dec_rel = SEQ_CACHE_REL if f32 and cfg.family == "encdec" else pre_rel
        t = time.perf_counter()
        steps, csteps = build_steps(cfg, device=dev), build_steps(cfg, device="cpu")
        params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED + 3), dev)
        cpu = cpu_copy(csteps.bundle, params)
        gen = torch.Generator().manual_seed(SEED + 3)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)
        frames = seq_frames(cfg, B, 2 * n, gen, "cpu")
        batch = dict(tokens=toks) if frames is None else dict(tokens=toks, frames=frames)
        with full_f32_matmul() if f32 else contextlib.nullcontext():
            want = csteps.prefill_step(cpu, batch)
            got = steps.prefill_step(params, {k: v.to(dev) for k, v in batch.items()})
            pre_err = rel_err(got, want)
            if pre_err > pre_rel:
                raise AssertionError(f"{arch} {label}: the card's prefill differs: {pre_err}")
            caches = dict(card=start_cache(steps, params, B, 2 * n,
                                           None if frames is None else frames.to(dev)),
                          cpu=start_cache(csteps, cpu, B, 2 * n, frames))
            last, errs = {}, []
            for i in range(n):
                for name, st, p in (("cpu", csteps, cpu), ("card", steps, params)):
                    d = st.device
                    last[name], caches[name] = st.decode_step(
                        p, caches[name], toks[:, i:i + 1].to(d),
                        torch.tensor(i, dtype=torch.int32, device=d))
                errs.append(rel_err(last["card"], last["cpu"]))
            err = max(errs)
            if err > dec_rel:
                raise AssertionError(f"{arch} {label}: the card's decode differs: {errs}")
            compared = greedy_against_cpu(steps, params, csteps, cpu, caches, last, n, err)
        log(f"check (c) {arch} {label} ({cfg.dtype}), the card against the port's CPU run: "
            f"prefill B={B} S={S} max |err| / max |logit| {pre_err:.3e} <= {pre_rel}; {n} "
            f"decode steps at B={B} {[f'{e:.3e}' for e in errs]} <= {dec_rel}; greedy tokens "
            f"equal at {compared} of {B * (n + 1)} positions (compared up to each row's first "
            f"CPU top-2 margin within the error) ({time.perf_counter() - t:.3f} s)")
        del params, cpu, caches, steps, csteps


def seq_training(dev, card: str, arch: str) -> None:
    """(d): ``arch`` at its published config and depth (bf16, AdamW,
    ``remat="full"``): ``SEQ_TRAIN_STEPS`` warm-up then timed
    ``train_step``s at ``SEQ_TRAIN[arch]`` on the ``TokenPipeline`` (whisper: its
    f32 frames), each timed with CUDA events, their mean and spread against
    ``lm_train_bound``, tokens/s, peak device memory; then one step at the
    arch's ``reduced()`` config (f32, ``remat="full"``) from one fresh
    state on the card and on the CPU within ``SEQ_TRAIN_F32[arch]``."""
    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    B, S = SEQ_TRAIN[arch]
    n_warm, n_timed = SEQ_TRAIN_STEPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    steps = build_steps(cfg, device=dev)
    state = steps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    w_bytes = lm_bytes(state["params"])
    o_bytes = sum(x.numel() * x.element_size() for x in leaves(state["opt"]))
    pipe = TokenPipeline(cfg.vocab, S, B, seed=2)
    batches = [pipe.next_batch(cfg, dev) for _ in range(n_warm + n_timed)]
    s_enc = batches[0]["frames"].shape[1] if "frames" in batches[0] else 0
    log(f"(d) {arch} on {card}: {cfg.optimizer}, remat={cfg.remat}: {n_params} parameters, "
        f"{w_bytes} B of weights, {o_bytes} B of optimizer state ({time.perf_counter() - t:.3f} s)")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in batches]
    metrics = []
    t = time.perf_counter()
    for (start, end), batch in zip(events, batches):
        start.record()
        state, m = steps.train_step(state, batch)
        end.record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for i, m in enumerate(metrics):
        check_metrics(m, f"(d) {arch} step {i}")
    ms = [s.elapsed_time(e) for s, e in events]
    timed = ms[n_warm:]
    mean = float(np.mean(timed))
    b_ms, b_ops, b_bytes = lm_train_bound(cfg, n_params, B, S, s_enc)
    log(f"(d) {arch} train_step ({card}): B={B} S={S}"
        + (f" with ({B}, {s_enc}, {cfg.d_model}) f32 frames" if s_enc else "")
        + f": first {ms[0]:.6f} ms; timed steps mean {mean:.6f} ms, min {min(timed):.6f}, max "
        f"{max(timed):.6f}, std {float(np.std(timed)):.6f} over {len(timed)} (CUDA events) = "
        f"{B * S / mean * 1e3:.3f} tokens/s; host wall {wall:.3f} s for {len(batches)} steps; "
        f"losses {[round(float(m['loss']), 6) for m in metrics]}; bound {b_ms:.6f} ms ({b_ops} "
        f"bf16 operations / 989 TFLOP/s + {4 * lm_forward_ops(cfg, B, S, s_enc)[1]} f32 "
        f"operations / 67 TFLOP/s; {b_bytes} B / 3.35 TB/s): {100 * b_ms / mean:.3f} % of it; "
        f"peak device memory {torch.cuda.max_memory_allocated() - base} B above the start "
        f"({base} B), the state {w_bytes + o_bytes} B")
    del state, batches, steps, metrics
    gc.collect()
    torch.cuda.empty_cache()

    hb, hs = SEQ_TRAIN_CPU
    rcfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
    rsteps = build_steps(rcfg, device=dev)
    rstate = rsteps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
    with full_f32_matmul():
        _, line = train_step_against_cpu(dev, rcfg, rsteps, rstate, hb, hs,
                                         f"(d) {arch} reduced() ({rcfg.optimizer}, f32)",
                                         SEQ_TRAIN_F32[arch])
    log(line)


def seq_families(dev, card: str) -> None:
    """Phase 19: the enc-dec and xLSTM families on the card.

    (a) ``whisper-base`` (6 encoder and 6 decoder layers, d_model 512) and
    (b) ``xlstm-125m`` (two units of five mLSTM layers and one sLSTM layer,
    d_model 768), both at their published widths and depth:
    ``seq_serving``, with (c)'s decode against prefill. (c) the card
    against the port's CPU run on the same weights:
    ``seq_card_against_cpu``. (d) one warm ``train_step`` of each at full
    depth, and one against the CPU at ``reduced()``: ``seq_training``.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the promoted f32 products would be rounded")
    for arch in SEQ_ARCHS:
        with phase(f"{arch} serving"):
            seq_serving(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
        with phase(f"{arch} card against CPU"):
            seq_card_against_cpu(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
        with phase(f"{arch} train_step"):
            seq_training(dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------ the hybrid family
HYBRID_ARCH = "jamba-v0.1-52b"
# (a)-(c): the depth cut, two of the four superblocks: 16 of 32 layers, 26.06 B
# parameters, 52.1 GB in bf16 (all 32 layers, 51.6 B, are 103 GB: more than
# the card holds)
HYBRID_SERVE_LAYERS = 16
HYBRID_PREFILL = (8, 2048)  # (B, S)
# whether (a) profiles one prefill: its 82,781 host aten calls took about 13 s
# to summarize (NVIDIA H100 80GB HBM3, 700.00 W), so the smoke leaves it to
# tools/hybrid_phase.py --profile-prefill
HYBRID_PROFILE_PREFILL = False
# (B, slots): 4.3 GB of bf16 k/v in the two attention layers and 1.12 GB of
# f32 Mamba state in the 14 Mamba layers
HYBRID_DECODE = (128, 4096)
HYBRID_STEPS = (4, 8)  # teacher-forced steps, then greedy tokens, at the decode shape
HYBRID_LONG = "long_500k"  # (b): the reference's shape for subquadratic configs
# (c): decode against prefill: (B, teacher-forced steps), from the zero cache
# (the Mamba mixer's own start), each step replaying prefill's expert choices;
# the check's capacity factor makes every expert's capacity at least the
# prefill's tokens, so none binds there (decode, a token a row, drops
# nothing: as built the two paths compute different functions)
HYBRID_CHECK = (8, 256)
HYBRID_CHECK_CF = 100.0
# ... with the weights drawn anew in this dtype at this depth. bf16's
# roundings grow with depth: 5.13 % of the largest logit at 16 layers, 3.44 %
# at 8, and 4.0e-5 in f32 at 8 (tools/hybrid_phase.py --drift; NVIDIA H100
# 80GB HBM3, 700.00 W; the reference's own bf16 drift at reduced() is 3.88 %
# with no capacity binding, tools/reference_seq_drift.py hybrid). 16 layers
# in f32 (104 GB) do not fit: the check runs one superblock in f32
HYBRID_CHECK_DTYPE = "float32"
HYBRID_CHECK_LAYERS = 8
# (d): reduced() f32 on the card against the CPU: prefill (B, S), then as many
# decode steps as greedy tokens; then one Mamba layer at published width in
# bf16: mamba_mixer at (B, S), then decode steps from init_mamba_state
HYBRID_CPU_SHAPE = (4, 32, 4)
HYBRID_MIXER = (2, 256, 8)
HYBRID_F32_REL = 1e-5
# (e): one superblock (8 layers, 13.3 B parameters) at B, S; warm-up steps,
# then timed steps; then a reduced() f32 step against the CPU's
HYBRID_TRAIN_LAYERS = 8
HYBRID_TRAIN_SHAPE = (1, 2048)
HYBRID_TRAIN_STEPS = (1, 3)
HYBRID_TRAIN_CPU = (1, 32)
HYBRID_TRAIN_F32 = dict(loss=1e-5, grad_norm=1e-5, vr=1e-4, vc=1e-4)


def hybrid_serving(dev, card: str) -> None:
    """(a)-(c): ``jamba-v0.1-52b`` at its published widths cut to
    ``HYBRID_SERVE_LAYERS`` (recorded as a cut), bf16 weights from a seeded
    generator: (a) ``prefill_step`` at ``HYBRID_PREFILL`` against its bound
    and the choices it dropped at capacity (with
    ``HYBRID_PROFILE_PREFILL``, one profiled prefill); at
    ``HYBRID_DECODE``
    teacher-forced and greedy steps (tokens/s, host clock), a warm
    ``decode_step`` (CUDA events) against its bound with the experts its
    tokens chose, one profiled step, peak device memory; (b) a warm
    ``decode_step`` at the reference's ``long_500k`` shape over a seeded
    cache at its last position, against its bound; (c) decode against
    prefill at ``HYBRID_CHECK`` within ``LM_REL``, every row, the weights
    drawn anew in ``HYBRID_CHECK_DTYPE`` at ``HYBRID_CHECK_LAYERS``."""
    from repro_torch.configs import SHAPES, applicable_shapes, get_config
    from repro_torch.train.decode import greedy_generate
    from repro_torch.train.step import build_steps

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_SERVE_LAYERS)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    params = steps.bundle.init(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{HYBRID_ARCH} on {card}: n_layers={cfg.n_layers} (a depth cut: {cfg.n_layers} of "
        f"{full.n_layers}, {cfg.n_layers // cfg.attn_every} of {full.n_layers // cfg.attn_every} "
        f"superblocks) attn_every={cfg.attn_every} (attention at {params.attn_pos}) "
        f"moe_every={cfg.moe_every} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} experts={cfg.n_experts} top-{cfg.moe_topk} d_inner={cfg.d_inner} "
        f"d_state={cfg.d_state} d_conv={cfg.d_conv} dt_rank={cfg.dt_rank} ssm_chunk="
        f"{cfg.ssm_chunk} vocab={cfg.vocab} {cfg.dtype}: {n_params} parameters, "
        f"{lm_bytes(params)} B of weights ({time.perf_counter() - t:.3f} s)")

    # (a) prefill, and the choices it dropped at capacity
    pb, ps = HYBRID_PREFILL
    toks = torch.randint(0, cfg.vocab, (pb, ps), generator=gen, device=dev, dtype=torch.int32)
    t = time.perf_counter()
    with RoutingLog() as rl:
        out = steps.prefill_step(params, dict(tokens=toks))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    if out.shape != (pb, 1, cfg.vocab) or not torch.isfinite(out).all():
        raise AssertionError(f"{HYBRID_ARCH}: prefill logits {tuple(out.shape)}")
    drops, per = rl.dropped(), rl.calls[0]["choices"]
    del out
    pre_ms = time_ms(lambda: steps.prefill_step(params, dict(tokens=toks)), iters=2, warmup=0)
    p_ms, p_ops, p_bytes = lm_prefill_bound(cfg, params, pb, ps)
    log(f"(a) prefill ({card}): B={pb} S={ps}: {pre_ms:.6f} ms (CUDA events, 2 calls) = "
        f"{pb * ps / pre_ms * 1e3:.1f} tokens/s; bound {p_ms:.6f} ms ({p_ops} bf16 operations / "
        f"989 TFLOP/s + {lm_forward_ops(cfg, pb, ps)[1]} f32 router and Mamba operations / "
        f"67 TFLOP/s; {p_bytes} B): {100 * p_ms / pre_ms:.3f} % of it; the first call "
        f"{t_first:.3f} s (host clock); capacity {rl.calls[0]['cap']} an expert; dropped "
        f"(token, expert) choices per MoE layer {drops} of {per} "
        f"({100 * sum(drops) / (len(drops) * per):.3f} %)")
    if HYBRID_PROFILE_PREFILL:
        profile_call(f"{HYBRID_ARCH} prefill_step (B={pb}, S={ps})",
                     lambda: steps.prefill_step(params, dict(tokens=toks)))
    del toks

    # (a) decode at the serving shape, from the zero cache
    B, slots = HYBRID_DECODE
    n_tf, n_new = HYBRID_STEPS
    cache = steps.init_cache(B, slots)
    log(f"cache: {sum(c.numel() * c.element_size() for c in cache.values())} B ({B} rows, "
        f"{sorted((k, tuple(c.shape), str(c.dtype)[6:]) for k, c in cache.items())}): k/v "
        f"{cache['k'].nbytes + cache['v'].nbytes} B, Mamba state "
        f"{cache['h'].nbytes + cache['conv'].nbytes} B")
    prompt = torch.randint(0, cfg.vocab, (B, n_tf), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    t = time.perf_counter()
    for i in range(n_tf):
        logits, cache = steps.decode_step(params, cache, prompt[:, i:i + 1], pos)
        pos = pos + 1
    torch.cuda.synchronize()
    t_tf = time.perf_counter() - t
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t = time.perf_counter()
    gtoks, cache = greedy_generate(steps, params, cache, first, n_new=n_new, start_pos=n_tf)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    if gtoks.shape != (B, n_new) or int(gtoks.min()) < 0 or int(gtoks.max()) >= cfg.vocab:
        raise AssertionError(f"{HYBRID_ARCH}: greedy tokens {tuple(gtoks.shape)}")
    tpos = torch.tensor(n_tf + n_new, dtype=torch.int32, device=dev)
    with RoutingLog() as rl:
        logits = steps.decode_step(params, cache, first, tpos)[0]
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{HYBRID_ARCH}: non-finite decode logits")
    chosen = rl.chosen()
    step_ms = time_ms(lambda: steps.decode_step(params, cache, first, tpos), iters=10, warmup=2)
    b_ms, b_bytes, b_ops = lm_decode_bound(cfg, params, B, slots, chosen=chosen)
    log(f"(a) decode ({card}): {n_tf} teacher-forced steps {t_tf:.6f} s, greedy {n_new} steps "
        f"{t_gen:.6f} s = {B * n_new / t_gen:.3f} tokens/s (host clock); warm decode_step "
        f"{step_ms:.6f} ms (CUDA events) = {B / step_ms * 1e3:.3f} tokens/s; bound {b_ms:.6f} ms "
        f"({b_bytes} B / 3.35 TB/s, the weights of the {chosen} experts the step's tokens chose "
        f"over its {len(rl.calls)} MoE layers, the k/v read and the Mamba state read and "
        f"written; {b_ops} bf16 operations / 989 TFLOP/s): {100 * b_ms / step_ms:.3f} % of it; "
        f"dropped choices a step per MoE layer {rl.dropped()} of {rl.calls[0]['choices']} "
        f"(capacity {rl.calls[0]['cap']})")
    log(f"  first row's tokens: {gtoks[0].tolist()}")
    profile_call(f"{HYBRID_ARCH} decode_step (B={B}, {slots} slots)",
                 lambda: steps.decode_step(params, cache, first, tpos))
    log(f"peak device memory ({HYBRID_ARCH}, {cfg.n_layers} layers, (a)): "
        f"{torch.cuda.max_memory_allocated() - base} B above the start ({base} B)")
    del cache, logits

    # (b) the long_500k shape: one row into 524,288 slots, at the last one
    if HYBRID_LONG not in applicable_shapes(cfg):
        raise AssertionError(f"{HYBRID_ARCH}: {HYBRID_LONG} does not apply")
    ls, lb, _ = SHAPES[HYBRID_LONG]
    torch.cuda.reset_peak_memory_stats()
    lgen = torch.Generator(device=dev).manual_seed(SEED + 5)
    t = time.perf_counter()
    lcache = steps.init_cache(lb, ls)
    for c in lcache.values():  # seeded: k and v bf16, the Mamba states f32
        c.copy_(torch.randn(c.shape, generator=lgen, device=dev, dtype=c.dtype))
    torch.cuda.synchronize()
    t_seed = time.perf_counter() - t
    ltok = torch.randint(0, cfg.vocab, (lb, 1), generator=lgen, device=dev, dtype=torch.int32)
    lpos = torch.tensor(ls - 1, dtype=torch.int32, device=dev)
    with RoutingLog() as rl:
        logits = steps.decode_step(params, lcache, ltok, lpos)[0]
    if logits.shape != (lb, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{HYBRID_ARCH}: {HYBRID_LONG} decode logits {tuple(logits.shape)}")
    chosen = rl.chosen()
    long_ms = time_ms(lambda: steps.decode_step(params, lcache, ltok, lpos), iters=10, warmup=2)
    l_ms, l_bytes, l_ops = lm_decode_bound(cfg, params, lb, ls, chosen=chosen)
    log(f"(b) {HYBRID_LONG} decode_step ({card}): B={lb} into {ls} slots at position {ls - 1} "
        f"over a seeded cache ({sum(c.nbytes for c in lcache.values())} B, seeded in "
        f"{t_seed:.3f} s): {long_ms:.6f} ms (CUDA events) = {lb / long_ms * 1e3:.3f} tokens/s; "
        f"bound {l_ms:.6f} ms ({l_bytes} B / 3.35 TB/s, the weights of the {chosen} experts "
        f"chosen over {len(rl.calls)} MoE layers; {l_ops} bf16 operations): "
        f"{100 * l_ms / long_ms:.3f} % of it; peak device memory "
        f"{torch.cuda.max_memory_allocated() - base} B above the start")
    del lcache, logits

    del params, steps

    # (c) decode against prefill, no capacity binding, the weights drawn anew
    gc.collect()
    torch.cuda.empty_cache()
    cb, cs = HYBRID_CHECK
    ccfg = dataclasses.replace(cfg, n_layers=HYBRID_CHECK_LAYERS, dtype=HYBRID_CHECK_DTYPE,
                               capacity_factor=HYBRID_CHECK_CF)
    t = time.perf_counter()
    csteps = build_steps(ccfg, device=dev)
    cparams = csteps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    ctoks = torch.randint(0, cfg.vocab, (cb, cs), generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev, dtype=torch.int32)
    err = decode_against_prefill(csteps, cparams, ctoks, moe=True)
    log(f"check (c): {cs} decode steps at B={cb} from the zero cache against prefill_step, every "
        f"row, {ccfg.n_layers} layers (a depth cut), {ccfg.dtype} weights, the k/v cache bf16, "
        f"capacity_factor {HYBRID_CHECK_CF} (no capacity binds at the prefill's {ctoks.numel()} "
        f"tokens), each step replaying prefill's expert choices: max |err| / max |logit| "
        f"{err:.6f} <= {LM_REL} ({time.perf_counter() - t:.3f} s)")
    del cparams, csteps


def mamba_layer_against_cpu(dev, card: str) -> None:
    """(d), second half: one Mamba mixer at published width (bf16, seeded
    weights) on the card and on the CPU: ``mamba_mixer`` at
    ``HYBRID_MIXER``'s (B, S), then its decode steps from
    ``init_mamba_state``, the outputs and states within ``LM_REL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config(HYBRID_ARCH)
    B, S, n = HYBRID_MIXER
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    p = {k: v.value for k, v in ssm.init_mamba(gen, cfg, dev).items()}
    cp = {k: v.cpu() for k, v in p.items()}
    n_params = sum(v.numel() for v in p.values())
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        got = ssm.mamba_mixer(p, x, cfg)
        torch.cuda.synchronize()
        tc = time.perf_counter()
        want = ssm.mamba_mixer(cp, x.cpu(), cfg)
        t_cpu = time.perf_counter() - tc
        mix_err = rel_err(got, want)
        st, cst = ssm.init_mamba_state(cfg, B, dev), ssm.init_mamba_state(cfg, B)
        errs = []
        for i in range(n):
            y = ssm.mamba_decode(p, x[:, i:i + 1], st, cfg)[0]
            cy = ssm.mamba_decode(cp, x[:, i:i + 1].cpu(), cst, cfg)[0]
            errs.append(rel_err(y, cy))
        s_err = max(rel_err(st[k], cst[k]) for k in st)
    if max([mix_err, s_err] + errs) > LM_REL:
        raise AssertionError(f"(d) mamba layer: mixer {mix_err}, decode {errs}, states {s_err}")
    log(f"check (d) one Mamba layer at published width ({n_params} parameters, bf16), the card "
        f"against the port's CPU run: mamba_mixer at B={B} S={S} max |err| / max |y| "
        f"{mix_err:.6f} <= {LM_REL} (CPU {t_cpu:.3f} s); {n} mamba_decode steps from "
        f"init_mamba_state {[f'{e:.6f}' for e in errs]}, the states h and conv {s_err:.6f} <= "
        f"{LM_REL} ({time.perf_counter() - t:.3f} s)")


def hybrid_training(dev, card: str) -> None:
    """(e): ``jamba-v0.1-52b`` at published width cut to
    ``HYBRID_TRAIN_LAYERS`` (one superblock; a cut), Adafactor (the
    config's) and ``remat="full"`` (a checkpoint a block):
    ``HYBRID_TRAIN_STEPS`` warm-up then timed ``train_step``s at
    ``HYBRID_TRAIN_SHAPE`` on the ``TokenPipeline``, each timed with CUDA
    events, against ``lm_train_bound``, tokens/s, peak device memory; then
    one step at the ``reduced()`` config (f32, ``remat="full"``) from one
    fresh state on the card and on the CPU within ``HYBRID_TRAIN_F32``."""
    from repro_torch import full_f32_matmul
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_TRAIN_LAYERS)
    B, S = HYBRID_TRAIN_SHAPE
    n_warm, n_timed = HYBRID_TRAIN_STEPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    steps = build_steps(cfg, device=dev)
    state = steps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    w_bytes = lm_bytes(state["params"])
    o_bytes = sum(x.numel() * x.element_size() for x in leaves(state["opt"]))
    pipe = TokenPipeline(cfg.vocab, S, B, seed=2)
    batches = [pipe.next_batch(cfg, dev) for _ in range(n_warm + n_timed)]
    log(f"(e) {HYBRID_ARCH} on {card}: n_layers={cfg.n_layers} (a depth cut: {cfg.n_layers} of "
        f"{full.n_layers}, one superblock), {cfg.optimizer}, remat={cfg.remat}: {n_params} "
        f"parameters, {w_bytes} B of weights, {o_bytes} B of optimizer state "
        f"({time.perf_counter() - t:.3f} s)")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in batches]
    metrics = []
    t = time.perf_counter()
    for (start, end), batch in zip(events, batches):
        start.record()
        state, m = steps.train_step(state, batch)
        end.record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for i, m in enumerate(metrics):
        check_metrics(m, f"(e) {HYBRID_ARCH} step {i}")
    ms = [s.elapsed_time(e) for s, e in events]
    timed = ms[n_warm:]
    mean = float(np.mean(timed))
    b_ms, b_ops, b_bytes = lm_train_bound(cfg, n_params, B, S)
    log(f"(e) {HYBRID_ARCH} train_step ({card}): B={B} S={S}: first {ms[0]:.6f} ms; timed "
        f"steps mean {mean:.6f} ms, min {min(timed):.6f}, max {max(timed):.6f}, std "
        f"{float(np.std(timed)):.6f} over {len(timed)} (CUDA events) = {B * S / mean * 1e3:.3f} "
        f"tokens/s; host wall {wall:.3f} s for {len(batches)} steps; losses "
        f"{[round(float(m['loss']), 6) for m in metrics]}; bound {b_ms:.6f} ms ({b_ops} bf16 "
        f"operations / 989 TFLOP/s + {4 * lm_forward_ops(cfg, B, S)[1]} f32 operations / "
        f"67 TFLOP/s; {b_bytes} B / 3.35 TB/s): {100 * b_ms / mean:.3f} % of it; peak device "
        f"memory {torch.cuda.max_memory_allocated() - base} B above the start ({base} B), the "
        f"state {w_bytes + o_bytes} B")
    del state, batches, steps, metrics
    gc.collect()
    torch.cuda.empty_cache()

    hb, hs = HYBRID_TRAIN_CPU
    rcfg = dataclasses.replace(full.reduced(), remat="full")
    rsteps = build_steps(rcfg, device=dev)
    rstate = rsteps.init_state(torch.Generator(device=dev).manual_seed(SEED + 4))
    with full_f32_matmul():
        _, line = train_step_against_cpu(dev, rcfg, rsteps, rstate, hb, hs,
                                         f"(e) {HYBRID_ARCH} reduced() ({rcfg.optimizer}, f32)",
                                         HYBRID_TRAIN_F32)
    log(line)


def hybrid_family(dev, card: str) -> None:
    """Phase 20: the hybrid family (``jamba-v0.1-52b``) on the card.

    (a)-(c) ``hybrid_serving`` at 16 of its 32 layers: prefill, decode at
    B = 128, the ``long_500k`` decode, decode against prefill. (d) the card
    against the port's CPU run: the ``reduced()`` config in f32
    (``moe_card_against_cpu``) and one Mamba layer at published width in
    bf16 (``mamba_layer_against_cpu``). (e) ``hybrid_training`` at 8
    layers, and a ``reduced()`` step against the CPU's.
    """
    from repro_torch.configs import get_config

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 products would be rounded")
    with phase(f"{HYBRID_ARCH} serving (a)-(c)"):
        hybrid_serving(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"{HYBRID_ARCH} card against CPU (d)"):
        moe_card_against_cpu(dev, card, HYBRID_ARCH, cfg=get_config(HYBRID_ARCH).reduced(),
                             rel=HYBRID_F32_REL, shape=HYBRID_CPU_SHAPE, part="(d)")
        mamba_layer_against_cpu(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"{HYBRID_ARCH} train_step (e)"):
        hybrid_training(dev, card)
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------ LMs over ranks and the dry run (phase 21)
# (a) and (b): qwen2-moe at its published widths (60 experts padded to 64,
# d_expert 1408, 4 shared, vocab 151,936) cut to 4 layers; (c): deepseek-v3
# at its published widths cut to 4 layers (3 dense, one MoE layer of 256
# experts); (j): whisper-base and (k): xlstm-125m at their published widths
# and depth; (l): jamba-v0.1-52b at its published widths cut to one
# superblock of 8 layers (7 Mamba, 1 attention, 4 MoE layers of 16
# experts); bf16, seeded weights (recorded as cuts)
RANKS_DEPTH = {"qwen2-moe-a2.7b": 4, "deepseek-v3-671b": 4, "jamba-v0.1-52b": 8}
RANKS_PREFILL = {"qwen2-moe-a2.7b": (8, 2048), "deepseek-v3-671b": (1, 2048),
                 "whisper-base": (8, 2048), "xlstm-125m": (8, 2048),
                 "jamba-v0.1-52b": (2, 2048)}  # (B, S); whisper: 512 frames
# (a): decode steps at the prefill's B, into S slots; 4 since every step
# gathers the dense weights over data (ZeRO-3, 1.1-2.0 s a step on gloo)
RANKS_DECODE = 4
# (part, arch, (data, model), decode steps): the runs of the phase, in turn
# on one spawn of ranks (a run on fewer ranks than the spawn's takes the
# first ones, the rest wait). (l) on (1, 2): with one data rank there are
# no ZeRO-3 gathers; at (2, 2) a jamba superblock's forward would move about
# 6.65 GB a rank through gloo (its (2, 2) layout runs in (m) at reduced())
RANKS_RUNS = [("a", "qwen2-moe-a2.7b", (2, 2), RANKS_DECODE),
              ("b", "qwen2-moe-a2.7b", (1, 2), 0), ("c", "deepseek-v3-671b", (1, 2), 0),
              ("j", "whisper-base", (2, 2), 2), ("k", "xlstm-125m", (2, 2), 2),
              ("l", "jamba-v0.1-52b", (1, 2), 2)]
# (k) and (l): one long-context decode step at B = 1 after the decode steps,
# its cache's slots over every axis (kv_seq_all; xLSTM's state has no
# slots): jamba's at long_500k's 524,288 slots, written at the last one
RANKS_LONG = {"xlstm-125m": 2048, "jamba-v0.1-52b": 524_288}
# the weights' dtype where it is not the config's: an arch's served runs
# (RANKS_DTYPE) and (m)'s steps (RANKS_TRAIN_DTYPE). xLSTM's exponential
# gates amplify the bf16 roundings in which four ranks and one device
# differ (tools/seq_noise_floor.py; phase 19 holds its decode in f32 for
# the same reason): in bf16 (k)'s logits, (m)'s xLSTM step and whisper's
# step's AdamW m are past their bounds (PERF.md §6: the readings of
# tools/mesh_phase.py --readings on the H100); in f32 they hold
RANKS_DTYPE = {"xlstm-125m": "float32"}
RANKS_TRAIN_DTYPE = {"m1": "float32", "m2": "float32"}
# set (tools/mesh_phase.py --readings) to log a tolerance check that fails
# as a reading instead of raising (each rank takes it from its inputs)
RANKS_READINGS = False
# every rank's logits within this share of the single-device run's largest
# logit: the bf16 bound of tests/test_torch_moe_sharded.py (and LM_REL); the
# two runs differ by the order of the row-parallel sums in bf16 (a rank's
# share first, then the sum over model), the routing replayed
RANKS_REL = 5e-2
# (e): the dry run at full width on the 256-GPU mesh
DRYRUN_MESH = "data=32,model=8"
# ... in three host processes, a group each, balanced by the cells' trace
# seconds in a dry run --all on the GPU machine's host (deepseek-v3's
# prefill 40 s, jamba's cells 26 s, wisk's 16 s)
DRYRUN_GROUPS = ((("deepseek-v3-671b", "prefill_32k"), ("jamba-v0.1-52b", "long_500k"),
                  ("wisk", "serve")),
                 (("qwen2-moe-a2.7b", "prefill_32k"), ("jamba-v0.1-52b", "decode_32k"),
                  ("qwen2-moe-a2.7b", "decode_32k")),
                 (("qwen2-moe-a2.7b", "train_4k"), ("deepseek-v3-671b", "decode_32k")))
# (f): qwen2-moe at its published widths cut to 2 layers (bf16, AdamW,
# remat="full", seeded weights) trained on four ranks (data=2, model=2) at
# B = 4, S = 512 on the TokenPipeline of seed 0, two steps (a warm one
# after the first), step 1 held to a single
# device stepping each data shard's rows alone, gradients averaged, routing
# replayed, within phase 17(b)'s bounds (TRAIN_REL)
RANKS_TRAIN_ARCH = "qwen2-moe-a2.7b"
RANKS_TRAIN_DEPTH = 2
RANKS_TRAIN_SHAPE = (4, 512)
RANKS_TRAIN_STEPS = 2
RANKS_TRAIN_SEED = SEED + 31
# (g) and (h): deepseek-v3 at reduced() (f32, Adafactor, the MTP block) on
# (2, 2), one step against the same kind of single-device run; (h) its state
# checkpointed, restored on the first two ranks as plan_remesh(2)'s (1, 2)
# and stepped once more against one device's step from the same checkpoint
# (run by the last rank, one the plan drops); tests/test_torch_cuda_train.py's f32
# bounds
RANKS_ADAFACTOR_ARCH = "deepseek-v3-671b"
RANKS_ADAFACTOR_SHAPE = (4, 64)
RANKS_ADAFACTOR_REL = dict(loss=1e-5, grad_norm=1e-5, vr=1e-4, vc=1e-4)
RANKS_LAYOUT = (2, 2)
# (m): one train_step of each on (2, 2) against one device stepping each
# data shard: whisper-base and xlstm-125m at their published widths and
# depth (AdamW, remat="full", f32 weights by RANKS_TRAIN_DTYPE; B = 4,
# S = 512, whisper's frames bf16 as the batch spec's) within (f)'s bounds,
# jamba's reduced() cut to one superblock of 4 (f32, Adafactor) at (g)'s
# shape within (g)'s bounds
RANKS_FAMILY_TRAIN = (("m1", "whisper-base", (4, 512)), ("m2", "xlstm-125m", (4, 512)),
                      ("m3", "jamba-v0.1-52b", RANKS_ADAFACTOR_SHAPE))
RANKS_FAMILY_REL = {"m1": TRAIN_REL, "m2": TRAIN_REL, "m3": RANKS_ADAFACTOR_REL}


def ranks_bound(ok: bool, msg: str) -> None:
    """A tolerance check: raises ``msg`` where it failed, or with
    ``RANKS_READINGS`` logs it as a reading past the bound."""
    if ok:
        return
    if RANKS_READINGS:
        log(f"reading past the bound: {msg}")
        return
    raise AssertionError(msg)


def ranks_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=RANKS_DEPTH.get(arch, cfg.n_layers),
                               dtype=RANKS_DTYPE.get(arch, cfg.dtype))


def ranks_batch(cfg, B: int, S: int, gen, dev) -> dict:
    """A prefill batch of the batch spec's shapes and dtypes from ``gen``:
    the tokens, and enc-dec's frames (bf16, as the spec's)."""
    from repro_torch.train.step import build_steps

    sds, _ = build_steps(cfg, device="meta").batch_spec("prefill", S, B)
    out = {}
    for k, s in sds.items():
        if s.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, s.shape, generator=gen, device=gen.device,
                                   dtype=torch.int32).to(dev)
        else:
            out[k] = torch.randn(s.shape, generator=gen, device=gen.device).to(dev, s.dtype)
    return out


def _host_log(log_):
    """A ``RoutingLog``'s kept calls on the host (for a rank to replay)."""
    keep = ("probs", "top_idx", "top_val", "tok_idx")
    return types.SimpleNamespace(calls=[{k: c[k].cpu() for k in keep if k in c}
                                        for c in log_.calls])


def single_device_runs(dev, card: str, arch: str, layouts) -> dict:
    """The single-device runs the ranks are held to, on the card: prefill of
    each data shard's rows alone (the same ``t_loc``), the decode steps of
    the whole batch (enc-dec's cross cache filled from the encoder, kept on
    the host for the ranks) and, for ``RANKS_LONG``, one long-context step
    of one row, each with its routing kept for the ranks to replay; their
    times (CUDA events: each prefill the call checked, its routing kept; a
    decode step warm) and peak memory. Returns the outputs on the host."""
    from repro_torch.train.step import build_steps

    cfg = ranks_config(arch)
    B, S = RANKS_PREFILL[arch]
    n_dec = max(n for _, a, _, n in RANKS_RUNS if a == arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = build_steps(cfg, device=dev)
    t = time.perf_counter()
    params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    log(f"{arch} single device ({card}): n_layers={cfg.n_layers}"
        f"{' (a depth cut)' if arch in RANKS_DEPTH else ''} d_model={cfg.d_model} experts="
        f"{cfg.n_experts} d_expert={cfg.d_expert} vocab={cfg.vocab} {cfg.dtype}: "
        f"{lm_bytes(params)} B of weights ({time.perf_counter() - t:.3f} s)")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = ranks_batch(cfg, B, S, g, dev)
    dec = torch.randint(0, cfg.vocab, (B, max(n_dec, 1)), generator=g, device=dev,
                        dtype=torch.int32)
    out = dict(cfg=cfg, batch={k: v.cpu() for k, v in batch.items()}, dec_tokens=dec.cpu(),
               prefill={}, times={})
    row_sets = {(i * B // d, (i + 1) * B // d) for d, _ in layouts for i in range(d)}
    for lo, hi in sorted(row_sets):
        rows = {k: v[lo:hi] for k, v in batch.items()}
        box = []
        with RoutingLog(keep=True) as rl:
            ms = time_ms(lambda: box.append(steps.prefill_step(params, rows)), iters=1, warmup=0)
        logits = box.pop()
        out["prefill"][(lo, hi)] = (logits.cpu(), _host_log(rl))
        out["times"][f"prefill rows {lo}:{hi}"] = ms
    if n_dec:
        cache = steps.init_cache(B, S)
        if cfg.family == "encdec":
            fill_cross_cache(params, cache, params.encode(batch["frames"]))
            out["cross"] = {k: cache[k].cpu() for k in ("xk", "xv")}
        logs, step_logits = [], []
        for i in range(n_dec):
            with RoutingLog(keep=True) as rl:
                lo_, cache = steps.decode_step(params, cache, dec[:, i:i + 1],
                                               torch.tensor(i, dtype=torch.int32, device=dev))
            step_logits.append(lo_.cpu())
            logs.append(_host_log(rl))
        pos = torch.tensor(n_dec - 1, dtype=torch.int32, device=dev)
        out["times"]["decode step"] = time_ms(
            lambda: steps.decode_step(params, cache, dec[:, -1:], pos), iters=3, warmup=1)
        out["decode"] = (step_logits, logs)
        del cache
    if arch in RANKS_LONG:
        n_long = RANKS_LONG[arch]
        cache = steps.init_cache(1, n_long)
        tok = torch.randint(0, cfg.vocab, (1, 1), generator=g, device=dev, dtype=torch.int32)
        pos = torch.tensor(n_long - 1, dtype=torch.int32, device=dev)
        with RoutingLog(keep=True) as rl:
            lo_, cache = steps.decode_step(params, cache, tok, pos)
        out["long"] = (tok.cpu(), n_long - 1, lo_.cpu(), _host_log(rl))
        out["times"]["long step"] = time_ms(
            lambda: steps.decode_step(params, cache, tok, pos), iters=1, warmup=0)
        del cache
    out["peak"] = torch.cuda.max_memory_allocated() - base
    log(f"{arch} single device: " + ", ".join(f"{k} {v:.6f} ms" for k, v in out["times"].items())
        + f" (CUDA events); peak device memory {out['peak']} B above the start")
    del params, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def abstract_census(cfg, layout, kind: str, B: int, S: int, long_ctx: bool = False) -> tuple:
    """The collective census ``(bytes, counts)`` of one step of ``cfg`` on
    the abstract mesh of ``layout`` -- the dry run's trace (``run_cell``'s
    census, without its op count): ``kind`` "prefill" at (B, S), "decode"
    one step at B into S slots (``long_ctx``: one row, the slots over
    every axis, which ``run_cell`` takes only where the batch is smaller
    than the data ranks), "train" one ``train_step`` at (B, S)."""
    from repro_torch.launch.mesh import collective_census, make_abstract_mesh
    from repro_torch.train.step import build_steps

    steps = build_steps(cfg, mesh=make_abstract_mesh(data=layout[0], model=layout[1]))
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    if kind == "train":
        state = steps.init_state(torch.Generator())
        sds, _ = steps.batch_spec("train", S, B)
        with collective_census() as census:
            steps.train_step(state, {k: meta(v.shape, v.dtype) for k, v in sds.items()})
        return census.bytes, census.counts
    params = steps.bundle.init(torch.Generator(), "meta")
    with torch.no_grad(), collective_census() as census:
        if kind == "prefill":
            sds, _ = steps.batch_spec("prefill", S, B)
            steps.prefill_step(params, {k: meta(v.shape, v.dtype) for k, v in sds.items()})
        else:
            steps.decode_step(params, steps.init_cache(B, S, long_ctx),
                              meta((B, 1), torch.int32), meta((), torch.int32), long_ctx)
    return census.bytes, census.counts


def prediction_jobs(runs, train: bool) -> list:
    """``(key, abstract_census arguments)`` of every census the phase's
    runs are held to, in the order the parent hands the runs out: each
    served run's prefill, decode step and long-context step, then the
    training runs' steps."""
    jobs = []
    for part, arch, layout, n_dec in runs:
        cfg = ranks_config(arch)
        B, S = RANKS_PREFILL[arch]
        jobs.append((f"{part}/prefill", (cfg, layout, "prefill", B, S)))
        if n_dec:
            jobs.append((f"{part}/decode", (cfg, layout, "decode", B, S)))
        if arch in RANKS_LONG:
            jobs.append((f"{part}/long", (cfg, layout, "decode", 1, RANKS_LONG[arch], True)))
    if train:
        for which, _, (B, S) in ranks_train_runs():
            jobs.append((f"{which}/train", (ranks_train_config(which), RANKS_LAYOUT, "train",
                                            B, S)))
    return jobs


def write_predictions(out_dir: str) -> None:
    """The jobs of ``out_dir/jobs.pkl`` in turn, each census written to
    ``out_dir/<key>.pkl`` once it is whole (the predictions' process)."""
    import pickle

    with open(os.path.join(out_dir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    for key, args in jobs:
        t = time.perf_counter()
        census = abstract_census(*args)
        path = os.path.join(out_dir, key.replace("/", "_") + ".pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump((census, time.perf_counter() - t), f)
        os.replace(path + ".tmp", path)


# the predictions' process: ``write_predictions`` of the directory given
PREDICT_SCRIPT = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
chip_smoke.write_predictions(sys.argv[2])
"""


def start_predictions(out_dir: str, jobs: list):
    """The censuses of ``jobs`` traced in a host process of their own (no
    card visible), from the phase's start, while the parent makes the
    single-device references: the xLSTM traces take tens of seconds (its
    sLSTM's time loop on meta tensors)."""
    import pickle

    with open(os.path.join(out_dir, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", PREDICT_SCRIPT, str(ROOT), out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def prediction(out_dir: str, proc, key: str) -> tuple:
    """The census of job ``key``, once the predictions' process wrote it
    (raises if the process ended without it)."""
    import pickle

    path = os.path.join(out_dir, key.replace("/", "_") + ".pkl")
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            _, err = proc.communicate()
            raise AssertionError(f"the predictions' process ended without {key}:\n{err[-3000:]}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)[0]


def timed_step(fn, on_card: bool, sync):
    """One call of ``fn``: ``(device ms by CUDA events, or the host clock's
    off the card; host seconds; [host seconds inside collectives])``."""
    sync()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t = time.perf_counter()
    with timed_collectives() as box:
        fn()
        if on_card:
            end.record()
        sync()
    wall = time.perf_counter() - t
    return (start.elapsed_time(end) if on_card else wall * 1e3), wall, box


def leaf_shapes(params) -> str:
    """A few of a model's leaves and their shapes on this rank (one of each
    kind the rules split)."""
    from repro_torch.tree import module_tree

    flat = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = tuple(v.shape)

    walk(module_tree(params))
    want = ("embed.table", "moe.w_gate", "attn.wq", "attn.wq_b", "ffn.w_up", "mix.in_proj",
            "mix.A_log", "ffn.w_gate", "core.up", "core.wq", "core.w_rec")
    picked = {}
    for name, shape in flat.items():
        tail = next((w for w in want if name.endswith(w)), None)
        if tail is not None and tail not in picked:
            picked[tail] = f"{name} {shape}"
    return ", ".join(picked.values())


def rank_serve_run(rank: int, dev, run, ref: dict, pred: dict, on_card: bool, sync) -> None:
    """One of ``RANKS_RUNS`` on this rank, if it is one of the run's
    (``make_host_mesh(..., first=True)``; the others wait at the barrier):
    the rules' blocks of the seeded weights, the prefill of the whole batch
    (this rank's rows against the single-device prefill of them, routing
    replayed), the decode steps of the whole batch (enc-dec: the rank's
    blocks of the single-device cross cache) and the long-context step,
    each within ``RANKS_REL`` and its census equal to the dry run's; the
    prefill checked is the one timed (``mesh_rank`` warms the rank up)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import collective_census, make_host_mesh
    from repro_torch.train.step import build_steps

    part, arch, layout, n_dec = run
    cfg = ref["cfg"]
    B, S = ref["batch"]["tokens"].shape
    mesh = make_host_mesh(*layout, device=dev, first=True)
    if mesh is None:  # a run on the first ranks: wait for it
        dist.barrier()
        return
    say = lambda *a: log(f"({part}) rank {rank} {layout}:", *a)  # noqa: E731
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    steps = build_steps(cfg, mesh=mesh)
    t = time.perf_counter()
    params = steps.bundle.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    sync()
    i, n_rows = mesh.axis("data").index, B // layout[0]
    rows = (i * n_rows, (i + 1) * n_rows)
    say(f"{arch}: {lm_bytes(params)} B of weights on this rank, the rules' blocks "
        f"({leaf_shapes(params)}), drawn in {time.perf_counter() - t:.3f} s; its rows "
        f"{rows[0]}:{rows[1]} of {B}")
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    want, replay = ref["prefill"][rows]
    box_out = []
    with RoutingLog(replay=replay), collective_census() as census:
        ms, wall, box = timed_step(lambda: box_out.append(steps.prefill_step(params, batch)),
                                   on_card, sync)
    logits = box_out.pop()
    if logits.shape != want.shape:
        raise AssertionError(f"({part}) rank {rank}: prefill logits {tuple(logits.shape)}")
    err = rel_err(logits, want)
    ranks_bound(err <= RANKS_REL, f"({part}) rank {rank}: prefill logits off the single-device "
                f"run's by {err} > {RANKS_REL}")
    if (census.bytes, census.counts) != pred["prefill"]:
        raise AssertionError(f"({part}) rank {rank}: the prefill's census {census.bytes} "
                             f"{census.counts} is not the dry run's {pred['prefill']}")
    say(f"prefill B={B} S={S}: max |err| / max |logit| {err:.6f} <= {RANKS_REL} against "
        f"the single-device prefill of rows {rows[0]}:{rows[1]} (routing replayed); "
        f"census {census.bytes} calls {census.counts} = the dry run's; "
        f"{ms:.6f} ms (CUDA events; single device "
        f"{ref['times'][f'prefill rows {rows[0]}:{rows[1]}']:.6f} ms), collectives "
        f"{100 * box[0] / wall:.3f} % of a {wall * 1e3:.3f} ms prefill (host clock)")
    del logits
    if n_dec:
        dec_logits, dec_logs = ref["decode"]
        cache = steps.init_cache(B, S)
        if "cross" in ref:  # the rank's blocks of the single-device cross cache
            _, specs = steps.cache_spec(B, S)
            for k, whole in ref["cross"].items():
                cache[k].copy_(steps.local({k: whole}, specs)[k])
        dec = ref["dec_tokens"].to(dev)
        box_out = []
        worst, t = 0.0, time.perf_counter()
        for s in range(n_dec):
            pos = torch.tensor(s, dtype=torch.int32, device=dev)

            def step():
                return steps.decode_step(params, cache, dec[:, s:s + 1], pos)

            with RoutingLog(replay=dec_logs[s]), collective_census() as census:
                if s < n_dec - 1:
                    lo_, cache = step()
                else:  # the last step is the warm one timed
                    step_ms, _, _ = timed_step(lambda: box_out.append(step()), on_card, sync)
                    lo_, cache = box_out.pop()
            worst = max(worst, rel_err(lo_, dec_logits[s][rows[0]:rows[1]]))
            if (census.bytes, census.counts) != pred["decode"]:
                raise AssertionError(f"({part}) rank {rank}: decode census {census.bytes} "
                                     f"is not the dry run's {pred['decode']}")
        sync()
        t_dec = time.perf_counter() - t
        ranks_bound(worst <= RANKS_REL, f"({part}) rank {rank}: decode off by {worst} > "
                    f"{RANKS_REL}")
        filled = " (the cross cache filled)" if "cross" in ref else ""
        say(f"{n_dec} decode steps into {S} slots{filled}: "
            f"{t_dec:.3f} s (host clock), max |err| / max |logit| {worst:.6f} <= {RANKS_REL} "
            f"against the single-device decode of the whole batch (routing replayed); census a "
            f"step {census.bytes} = the dry run's; a warm step {step_ms:.6f} ms (CUDA events; "
            f"single device {ref['times']['decode step']:.6f} ms)")
        del cache
    if "long" in ref:  # one row, its slots over every axis
        tok, pos, want, replay = ref["long"]
        n_long = pos + 1
        cache = steps.init_cache(1, n_long, long_ctx=True)
        box_out = []
        with RoutingLog(replay=replay), collective_census() as census:
            ms, wall, box = timed_step(lambda: box_out.append(steps.decode_step(
                params, cache, tok.to(dev), torch.tensor(pos, dtype=torch.int32, device=dev),
                True)), on_card, sync)
        lo_, cache = box_out.pop()
        err = rel_err(lo_, want)
        ranks_bound(err <= RANKS_REL, f"({part}) rank {rank}: the long-context step off by "
                    f"{err} > {RANKS_REL}")
        if (census.bytes, census.counts) != pred["long"]:
            raise AssertionError(f"({part}) rank {rank}: long-context census {census.bytes} "
                                 f"is not the abstract mesh's {pred['long']}")
        cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
        say(f"one long-context step (B=1, {n_long} slots over every axis, at slot {pos}): "
            f"max |err| / max |logit| {err:.6f} <= {RANKS_REL}; {cache_bytes} B of cache on "
            f"this rank; census {census.bytes} = the abstract mesh's; {ms:.6f} ms (CUDA "
            f"events, its first call; single device {ref['times']['long step']:.6f} ms), "
            f"collectives {100 * box[0] / wall:.3f} % (host clock)")
        del cache
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else 0
    say(f"peak device memory {peak} B above the start ({base} B)")
    del params, steps
    if on_card:  # the card's memory back before the run is reported done
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()


def mesh_rank(rank: int, world: int, init: str, backend: str, head: dict, inbox,
              done) -> None:
    """One rank of phase 21 (spawned): it joins the group, then takes its
    work from ``inbox[rank]`` as the parent makes it (``ranks_runs``): a
    served run of ``RANKS_RUNS`` with its references (``rank_serve_run``;
    rank 0 puts the run's letter on ``done`` once every rank has finished
    it), then the training runs, until ``None``. Every check raises on
    failure, which ends the rank non-zero and the parent's phase with it;
    each rank logs its own lines."""
    import datetime

    import torch.distributed as dist

    on_card = head["device_type"] == "cuda"
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}" if on_card else "cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # warmed up while the parent makes the first run's references: the
    # products' and the collectives' first calls, so that every run's first
    # prefill is the one timed
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    dist.all_reduce(x @ x)
    sync()
    if rank == 0:
        log(f"ranks: rank 0 up, its group joined: {time.time() - head['spawned']:.3f} s after the "
            f"spawn")
    global RANKS_READINGS
    first = True
    while (p := inbox[rank].get()) is not None:
        RANKS_READINGS = p["readings"]
        if first and rank == 0:
            log(f"ranks: rank 0 has its first inputs: {time.time() - head['spawned']:.3f} s after "
                f"the spawn")
        if "run" in p:
            rank_serve_run(rank, dev, p["run"], p["ref"], p["pred"], on_card, sync)
            first = False
            if rank == 0:
                done.put(p["run"][0])
            continue
        # (f)-(i) and (m): training over the ranks
        rank_train_f(rank, dev, p["train"], on_card, sync)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        dist.barrier()
        rank_train_gh(rank, world, dev, p["train"], p["ckpt_dir"], on_card, sync)
        dist.barrier()
        for which, _, _ in RANKS_FAMILY_TRAIN:
            rank_train_m(rank, dev, which, p["train"][which], on_card, sync)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            dist.barrier()
    dist.destroy_process_group()


# ------------------------------------- (f)-(i) and (m): training over the ranks (phase 21)
def ranks_train_config(which: str):
    """(f)'s config (published widths, ``RANKS_TRAIN_DEPTH`` layers), (g)'s
    (``reduced()``) or one of (m)'s (``RANKS_FAMILY_TRAIN``)."""
    from repro_torch.configs import get_config

    if which == "f":
        return dataclasses.replace(get_config(RANKS_TRAIN_ARCH), n_layers=RANKS_TRAIN_DEPTH,
                                   remat="full")
    if which == "g":
        return get_config(RANKS_ADAFACTOR_ARCH).reduced()
    arch = dict((w, a) for w, a, _ in RANKS_FAMILY_TRAIN)[which]
    cfg = get_config(arch)
    if cfg.family == "hybrid":  # reduced(), one superblock
        return dataclasses.replace(cfg.reduced(), n_layers=cfg.reduced().attn_every)
    return dataclasses.replace(cfg, dtype=RANKS_TRAIN_DTYPE.get(which, cfg.dtype))


def ranks_train_batch(cfg, B: int, S: int, dev) -> dict:
    """The TokenPipeline's batch of seed 0 at (B, S); enc-dec's frames in
    the batch spec's bf16 (the dry run's census counts them so)."""
    from repro_torch.data.tokens import TokenPipeline

    batch = TokenPipeline(cfg.vocab, S, B, seed=0).next_batch(cfg, dev)
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(torch.bfloat16)
    return batch


def shard_step(steps, state, batch, n_dp: int, keep_logs: bool = True):
    """One step of a single device as the mesh computes it: each data
    shard's rows alone (their own MoE capacity), the loss over ``n_dp``
    backpropagated, the gradients summed, then ``clip_and_update`` with
    ``build_steps``' schedule, clip and optimizer. Returns the mean loss,
    the norm, the learning rate and each shard's routing (kept)."""
    from repro_torch.optim.optimizers import cosine_schedule, get_optimizer
    from repro_torch.train.step import clip_and_update, loss_and_grads
    from repro_torch.tree import leaves

    rows = batch["tokens"].shape[0] // n_dp
    loss, grads, logs = 0.0, None, []
    for i in range(n_dp):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        with RoutingLog(keep=keep_logs) as rl:
            li, g = loss_and_grads(steps.bundle, state["params"], part, 1.0 / n_dp)
        logs.append(_host_log(rl))
        loss += float(li) / n_dp
        g = leaves(g)
        if grads is None:
            grads = g
        else:
            for a, b in zip(grads, g):
                a.add_(b)
        del g
    lr = cosine_schedule(3e-4, 100, 10_000)(state["step"])
    gnorm = clip_and_update(state["params"], state["opt"], grads,
                            get_optimizer(steps.cfg.optimizer)[1], lr, state["step"], 1.0)
    state["step"] = state["step"] + 1
    return loss, float(gnorm), float(lr), logs


def ranks_train_runs() -> list:
    """``(which, arch, (B, S))`` of every training run: (f), (g), then (m)'s."""
    return [("f", RANKS_TRAIN_ARCH, RANKS_TRAIN_SHAPE),
            ("g", RANKS_ADAFACTOR_ARCH, RANKS_ADAFACTOR_SHAPE), *RANKS_FAMILY_TRAIN]


def ranks_train_refs(dev, card: str, census_of, whiches=None) -> dict:
    """What (f)-(i) and (m) hold the ranks to, computed on the card: each
    run's single-device step from the ranks' seeded weights
    (``shard_step``, the routing of each data shard kept for the ranks to
    replay), its optimizer state on the host (a bf16 model's AdamW moments
    in bf16: (f)'s 7.3 GB instead of 14.6; the rounding, 2^-9 of a value,
    is far inside TRAIN_REL), and (i)'s dry-run census of each step
    (``census_of(which)``); of the runs ``whiches`` (default: every one)."""
    from repro_torch import full_f32_matmul
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    out = {}
    n_dp = RANKS_LAYOUT[0]
    for which, arch, (B, S) in ranks_train_runs():
        if whiches is not None and which not in whiches:
            continue
        cfg = ranks_train_config(which)
        f32 = cfg.dtype == "float32"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        steps = build_steps(cfg, device=dev)
        state = steps.init_state(torch.Generator(device=dev).manual_seed(RANKS_TRAIN_SEED))
        n_params = sum(p.numel() for p in state["params"].parameters())
        batch = ranks_train_batch(cfg, B, S, dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with full_f32_matmul() if f32 else contextlib.nullcontext():
            start.record()
            loss, gnorm, lr, logs = shard_step(steps, state, batch, n_dp)
            end.record()
            end.synchronize()
        ref = dict(cfg=cfg, shape=(B, S), loss=loss, grad_norm=gnorm, lr=lr, logs=logs)
        keep = torch.float32 if f32 else torch.bfloat16
        for name in type(state["opt"])._fields:
            # rounded on the card, written once into the shared memory the ranks map
            ref[name] = [torch.empty(x.shape, dtype=keep).share_memory_().copy_(x.to(keep))
                         for x in leaves(getattr(state["opt"], name))]
        t = time.perf_counter()
        ref["census"] = census_of(which)
        log(f"({which}) {arch} single device ({card}): {cfg.n_layers} layers, {cfg.dtype}, "
            f"{cfg.optimizer}, remat={cfg.remat}, {n_params} parameters; one step at B={B} "
            f"S={S} as {n_dp} data shards: loss {loss:.6f}, grad_norm {gnorm:.6f}, "
            f"{start.elapsed_time(end):.3f} ms (CUDA events), peak device memory "
            f"{torch.cuda.max_memory_allocated() - base} B above the start; the dry run's "
            f"census of the step on {RANKS_LAYOUT} (waited {time.perf_counter() - t:.3f} s): "
            f"{ref['census'][0]}")
        out[which] = ref
        del state, steps, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def leaf_digest(x: torch.Tensor) -> torch.Tensor:
    """An int64 digest of ``x``'s bits (a weighted sum of its elements'
    bit patterns, blocks of 2^24 elements): equal tensors, equal digests."""
    bits = x.detach().reshape(-1).view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                                        8: torch.int64}[x.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, bits.numel(), 1 << 24):
        b = bits[i:i + (1 << 24)].to(torch.int64)
        w = torch.arange(i, i + b.numel(), dtype=torch.int64, device=x.device) % 65521 + 1
        total += (b * w).sum()
    return total


def whole_leaves_agree(steps, state) -> int:
    """Checks that every state leaf each rank holds whole is bit-identical
    on every rank of the mesh (their digests all-gathered); returns how
    many leaves."""
    from repro_torch.tree import leaves

    whole = [x for x, sh in zip(leaves(state), leaves(steps.state_shardings())) if not sh.split]
    mine = torch.stack([leaf_digest(x) for x in whole])
    got = steps.mesh.everyone.all_gather(mine)
    bad = (got != got[0]).any(0).nonzero().flatten().tolist()
    if bad:
        raise AssertionError(f"whole leaves {bad} of {len(whole)} differ between the ranks")
    return len(whole)


def compare_blocks(steps, state, ref: dict, names, rel: dict) -> dict:
    """Each optimizer-state field of ``names``: the largest error of the
    rank's blocks against ``ref``'s whole leaves, over each block's
    largest value; raises above ``rel``. A leaf every rank holds whole is
    compared on rank 0 alone (``whole_leaves_agree`` holds the others to
    its bits)."""
    from repro_torch.tree import leaves

    placed = steps.state_shardings()["opt"]
    errs = {}
    for name in names:
        worst = 0.0
        for x, want, sh in zip(leaves(getattr(state["opt"], name)), ref[name],
                               leaves(getattr(placed, name))):
            if not sh.split and steps.mesh.rank != 0:
                continue
            worst = max(worst, rel_err(x, want[sh.index(sh.global_shape(x.shape))]))
        errs[name] = worst
    for k, v in errs.items():
        ranks_bound(v <= rel[k], f"the ranks' {k} differs from one device's: {v} > {rel[k]}")
    return errs


def ranks_step(steps, state, batch, replay, on_card: bool, sync) -> tuple:
    """One ``train_step`` on the mesh, timed (CUDA events on the card; the
    host clock of the slowest rank), in a census, the routing replayed
    where ``replay`` is given. Returns the state, its metrics, the census,
    device ms, host ms, the slowest rank's host ms and the collectives'
    share of this rank's host time."""
    from repro_torch.launch.mesh import collective_census

    box_out = []
    routing = RoutingLog(replay=replay) if replay is not None else contextlib.nullcontext()
    with routing, collective_census() as census:
        ms, wall, box = timed_step(lambda: box_out.append(steps.train_step(state, batch)),
                                   on_card, sync)
    state, m = box_out.pop()
    slowest = float(steps.mesh.everyone.pmax(torch.tensor([wall], dtype=torch.float64,
                                                          device=steps.device))[0])
    return state, m, census, ms, wall * 1e3, slowest * 1e3, 100 * box[0] / wall


def _check_step(what: str, m, ref: dict, rel: dict) -> dict:
    check_metrics(m, what)
    errs = {k: abs(float(m[k]) - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
    for k, v in errs.items():
        ranks_bound(v <= rel[k], f"{what}: {k} {float(m[k])} off one device's {ref[k]} by {v} "
                    f"> {rel[k]}")
    return errs


def _check_census(what: str, census, pred) -> None:
    if (census.bytes, census.counts) != pred:
        raise AssertionError(f"{what}: the step's census {census.bytes} {census.counts} is not "
                             f"the dry run's {pred}")


def rank_train_f(rank: int, dev, p: dict, on_card: bool, sync) -> None:
    """(f) and (i) on this rank: ``RANKS_TRAIN_STEPS`` steps of qwen2-moe
    over ``RANKS_LAYOUT``, step 1 held to one device's (``ranks_train_refs``;
    the routing of this rank's data shard replayed), every step's census to
    the dry run's, the whole leaves bit-identical after every step."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    ref = p["f"]
    cfg, (B, S) = ref["cfg"], ref["shape"]
    say = lambda *a: log(f"(f) rank {rank} {RANKS_LAYOUT}:", *a)  # noqa: E731
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    t = time.perf_counter()
    steps = build_steps(cfg, mesh=make_host_mesh(*RANKS_LAYOUT, device=dev))
    state = steps.init_state(torch.Generator(device=dev).manual_seed(RANKS_TRAIN_SEED))
    sync()
    say(f"drawn in {time.perf_counter() - t:.3f} s: {lm_bytes(state['params'])} B of weights and "
        f"{sum(x.numel() * x.element_size() for x in leaves(state['opt']))} B of AdamW moments "
        f"on this rank (the experts' block {tuple(state['params'].moe_blocks.moe.w_gate.shape)})")
    pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
    d = steps.mesh.axis("data").index
    for s in range(RANKS_TRAIN_STEPS):
        batch = pipe.next_batch(cfg, dev)
        state, m, census, ms, host, slowest, share = ranks_step(
            steps, state, batch, ref["logs"][d] if s == 0 else None, on_card, sync)
        _check_census(f"(f) rank {rank} step {s + 1}", census, ref["census"])
        line = ""
        if s == 0:
            t = time.perf_counter()
            errs = _check_step("(f)", m, ref, TRAIN_REL)
            errs.update(compare_blocks(steps, state, ref, ("m", "v"), TRAIN_REL))
            line = ("; against one device's step (routing replayed): " + ", ".join(
                f"{k} {v:.3e} <= {TRAIN_REL[k]}" for k, v in errs.items())
                + f" (compared in {time.perf_counter() - t:.3f} s)")
        # a collective: the ranks also leave it together, so the next step's
        # clock starts on every rank at once
        n_whole = whole_leaves_agree(steps, state)
        say(f"step {s + 1} B={B} S={S}: loss {float(m['loss']):.6f}, grad_norm "
            f"{float(m['grad_norm']):.6f}; {ms:.3f} ms (CUDA events), {host:.3f} ms host "
            f"clock, the slowest rank's {slowest:.3f} ms, collectives {share:.3f} % of it; "
            f"census {census.bytes} calls {census.counts} = the dry run's (i); {n_whole} "
            f"whole leaves bit-identical on every rank" + line)
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else 0
    say(f"peak device memory {peak} B above the start ({base} B)")


def rank_train_gh(rank: int, world: int, dev, p: dict, ckpt_dir: str, on_card: bool,
                  sync) -> None:
    """(g), (h) and (i) on this rank: deepseek-v3 at ``reduced()`` over
    ``RANKS_LAYOUT`` one step against one device's; its state checkpointed
    (whole leaves, rank 0 writing); restored on ``plan_remesh(2)``'s mesh of
    the first two ranks and stepped once more against one device's step
    from the same checkpoint, which the last rank (one the plan drops) runs
    and broadcasts (its routing replayed by the first two)."""
    import torch.distributed as dist

    from repro_torch import full_f32_matmul
    from repro_torch.ckpt.checkpoint import AsyncCheckpointer, restore
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.resilience.elastic import plan_remesh
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    ref = p["g"]
    cfg, (B, S) = ref["cfg"], ref["shape"]
    rel = RANKS_ADAFACTOR_REL
    steps = build_steps(cfg, mesh=make_host_mesh(*RANKS_LAYOUT, device=dev))
    state = steps.init_state(torch.Generator(device=dev).manual_seed(RANKS_TRAIN_SEED))
    pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
    batch = pipe.next_batch(cfg, dev)
    with full_f32_matmul():
        state, m, census, ms, host, slowest, share = ranks_step(
            steps, state, batch, ref["logs"][steps.mesh.axis("data").index], on_card, sync)
    _check_census(f"(g) rank {rank}", census, ref["census"])
    errs = _check_step("(g)", m, ref, rel)
    errs.update(compare_blocks(steps, state, ref, ("vr", "vc"), rel))
    n_whole = whole_leaves_agree(steps, state)
    log(f"(g) rank {rank} {RANKS_LAYOUT}: {RANKS_ADAFACTOR_ARCH} reduced() f32 Adafactor step B={B} S={S}: "
        f"loss {float(m['loss']):.6f}; against one device's step (routing replayed): "
        + ", ".join(f"{k} {v:.3e} <= {rel[k]}" for k, v in errs.items())
        + f"; census = the dry run's (i); {n_whole} whole leaves bit-identical; {ms:.3f} ms "
        f"(CUDA events), the slowest rank's host {slowest:.3f} ms")
    ckpt = AsyncCheckpointer(ckpt_dir, shardings=steps.state_shardings())
    t = time.perf_counter()
    ckpt.submit(1, state)
    ckpt.close()
    t_save = time.perf_counter() - t
    del state, steps
    # (h): the plan's mesh over the first ranks; the last rank steps one
    # device from the same checkpoint and hands its step to the others
    plan = plan_remesh(2)
    mesh = plan.make_mesh(device=dev)
    batch = pipe.next_batch(cfg, dev)
    box = [None]
    if rank == world - 1:
        one = build_steps(cfg, device=dev)
        ostate, _ = restore(ckpt_dir, one.init_state(torch.Generator(device=dev)))
        with full_f32_matmul():
            loss, gnorm, lr, logs = shard_step(one, ostate, batch, 1)
        box[0] = dict(loss=loss, grad_norm=gnorm, logs=logs[0], **{
            k: [x.cpu() for x in leaves(getattr(ostate["opt"], k))] for k in ("vr", "vc")})
    dist.broadcast_object_list(box, src=world - 1)
    if mesh is None:
        return
    want = box[0]
    steps = build_steps(cfg, mesh=mesh)
    t = time.perf_counter()
    state, step = restore(ckpt_dir, steps.init_state(torch.Generator(device=dev)),
                          shardings=steps.state_shardings())
    t_restore = time.perf_counter() - t
    with full_f32_matmul():
        state, m, census, ms, host, slowest, share = ranks_step(steps, state, batch,
                                                                want["logs"], on_card, sync)
    errs = _check_step("(h)", m, want, rel)
    errs.update(compare_blocks(steps, state, want, ("vr", "vc"), rel))
    n_whole = whole_leaves_agree(steps, state)
    log(f"(h) rank {rank} {plan.shape} (plan_remesh(2).make_mesh(): the first 2 of {world} "
        f"ranks): the "
        f"checkpoint of (g) (saved in {t_save:.3f} s, whole leaves) restored at step {step} in "
        f"{t_restore:.3f} s; one more step: loss {float(m['loss']):.6f}; against one device's "
        f"step from the same checkpoint: " + ", ".join(
            f"{k} {v:.3e} <= {rel[k]}" for k, v in errs.items())
        + f"; {n_whole} whole leaves bit-identical; {ms:.3f} ms (CUDA events)")


def rank_train_m(rank: int, dev, which: str, ref: dict, on_card: bool, sync) -> None:
    """One of (m)'s runs on this rank: a ``train_step`` over
    ``RANKS_LAYOUT`` from the seeded weights against one device's step
    (``ranks_train_refs``; the routing of this rank's data shard replayed):
    loss, grad_norm and the optimizer state's blocks within
    ``RANKS_FAMILY_REL`` ((f)'s bounds, or (g)'s for jamba's f32
    Adafactor), the census the dry run's, the whole leaves bit-identical on
    every rank."""
    from repro_torch import full_f32_matmul
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import build_steps
    from repro_torch.tree import leaves

    cfg, (B, S) = ref["cfg"], ref["shape"]
    f32 = cfg.dtype == "float32"
    rel = RANKS_FAMILY_REL[which]
    names = ("vr", "vc") if cfg.optimizer == "adafactor" else ("m", "v")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    t = time.perf_counter()
    steps = build_steps(cfg, mesh=make_host_mesh(*RANKS_LAYOUT, device=dev))
    state = steps.init_state(torch.Generator(device=dev).manual_seed(RANKS_TRAIN_SEED))
    sync()
    drawn = time.perf_counter() - t
    batch = ranks_train_batch(cfg, B, S, dev)
    with full_f32_matmul() if f32 else contextlib.nullcontext():
        state, m, census, ms, host, slowest, share = ranks_step(
            steps, state, batch, ref["logs"][steps.mesh.axis("data").index], on_card, sync)
    _check_census(f"({which}) rank {rank}", census, ref["census"])
    errs = _check_step(f"({which})", m, ref, rel)
    errs.update(compare_blocks(steps, state, ref, names, rel))
    n_whole = whole_leaves_agree(steps, state)
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else 0
    log(f"({which}) rank {rank} {RANKS_LAYOUT}: {cfg.name} {cfg.n_layers} layers {cfg.dtype} "
        f"{cfg.optimizer}, {lm_bytes(state['params'])} B of weights and "
        f"{sum(x.numel() * x.element_size() for x in leaves(state['opt']))} B of optimizer "
        f"state on this rank (drawn in {drawn:.3f} s); one step B={B} S={S}: loss "
        f"{float(m['loss']):.6f}; against one device's step: "
        + ", ".join(f"{k} {v:.3e} <= {rel[k]}" for k, v in errs.items())
        + f"; census {census.bytes} calls {census.counts} = the dry run's; {n_whole} whole "
        f"leaves bit-identical; {ms:.3f} ms (CUDA events), the slowest rank's host "
        f"{slowest:.3f} ms, collectives {share:.3f} % of it; peak device memory {peak} B "
        f"above the start")
    del state, steps


# (e)'s process: ``run_cell`` of each "arch:shape" argument in turn
DRYRUN_SCRIPT = """
import sys
from repro_torch.launch.dryrun import run_cell
for cell in sys.argv[3:]:
    run_cell(*cell.split(":"), sys.argv[1], sys.argv[2])
"""


def start_dryrun(out_dir: str):
    """(e), started: the dry run of the cells of ``DRYRUN_GROUPS`` at full
    width on ``DRYRUN_MESH`` in a process of its own for each group, a cell
    after another (host work on meta tensors, no card visible), while the
    phase runs on."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + [
        v for v in [env.get("PYTHONPATH")] if v])
    return time.perf_counter(), [subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SCRIPT, DRYRUN_MESH, out_dir,
         *[f"{arch}:{shape}" for arch, shape in cells]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cells in DRYRUN_GROUPS]


def full_width_dryrun(started, out_dir: str) -> None:
    """(e), finished: each cell's record, its ``fits`` against one card's
    memory (the card's own here) and its three roofline terms."""
    from repro_torch.launch.dryrun import device_memory, mesh_name, parse_mesh
    from repro_torch.roofline.analysis import collective_seconds, roofline_from_record

    t, procs = started
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"(e) the dry run failed:\n{err[-3000:]}")
    log(f"(e) the dry run's processes: {time.perf_counter() - t:.3f} s from their start to the "
        f"end of their {sum(map(len, DRYRUN_GROUPS))} cells")
    mem = device_memory()
    log(f"(e) one card's memory: {mem['bytes']} B ({mem['source']})")
    for arch, shape in (c for g in DRYRUN_GROUPS for c in g):
        f = Path(out_dir) / f"{arch}_{shape}_{mesh_name(parse_mesh(DRYRUN_MESH))}.json"
        rec = json.loads(f.read_text())
        if "skipped" in rec:
            raise AssertionError(f"(e) {arch} {shape}: skipped: {rec['skipped']}")
        m, census = rec["memory"], rec["op_census"]
        row = roofline_from_record(rec) if arch != "wisk" else None
        terms = (row.compute_s, row.memory_s, row.collective_s) if row else (
            census["flops"] / 989e12, census["bytes"] / HBM_BYTES_PER_S,
            collective_seconds(rec["collective_bytes_by_axis"]))
        log(f"(e) {arch} {shape} on {rec['mesh']} ({rec['devices']} H100s): argument "
            f"{m['argument_bytes']} B (fits {rec['fits']['argument_bytes']}), by the rules "
            f"{m['rules_argument_bytes']} B (fits {rec['fits']['rules_argument_bytes']}), peak "
            f"live {m['peak_live_bytes']} B (argument plus peak fits "
            f"{rec['fits']['with_peak_live_bytes']}); compute {terms[0] * 1e3:.6f} ms, memory "
            f"{terms[1] * 1e3:.6f} ms, collective {terms[2] * 1e3:.6f} ms per step and rank "
            + (f"(bound: {row.bottleneck}; useful {row.useful_ratio:.3f})" if row else "")
            + f"; collectives {rec['collective_bytes_by_axis']}; traced in "
            f"{rec['trace_s']:.3f} s")
        if rec["fits"]["device_memory_bytes"] != mem["bytes"]:
            log(f"(e) the records' card memory {rec['fits']['device_memory_bytes']} B "
                f"({rec['fits']['source']}) is not this card's")


# the order the parent makes the references in (an arch's served runs', or
# a training run's by its letter), and the large ones: a large reference
# (tens of GB on the card) waits until the ranks have finished every large
# run handed out before it, so that no two large models share the card
# (deepseek-v3's two 16 GB ranks beside (f)'s 26.5 GB reference ran out of
# the card's 80 GB)
RANKS_REF_ORDER = ("qwen2-moe-a2.7b", "f", "deepseek-v3-671b", "whisper-base", "xlstm-125m",
                   "g", "m1", "m3", "jamba-v0.1-52b", "m2")
RANKS_LARGE_REFS = ("deepseek-v3-671b", "jamba-v0.1-52b", "f")
RANKS_LARGE_RUNS = ("c", "l")


def ranks_runs(dev, card: str) -> None:
    """(a)-(d), (j)-(l), (f)-(i) and (m) on one spawn of ranks
    (``mesh_rank``), spawned first. The parent makes the single-device
    references (``single_device_runs``, one model at a time, and
    ``ranks_train_refs``) in ``RANKS_REF_ORDER``, takes the dry run's census
    of each cell from the predictions' process (``start_predictions``,
    started first), and hands each run to every rank's queue as soon as it
    and the runs before it have theirs, the training last: the ranks run
    while the parent makes what the later runs need, so the single-device
    times and the ranks' share the card with each other's work (never two
    large models: ``RANKS_LARGE_REFS`` wait for ``RANKS_LARGE_RUNS``, which
    rank 0 reports done)."""
    runs = RANKS_RUNS
    cards = torch.cuda.device_count()
    world = max(lay[0] * lay[1] for _, _, lay, _ in runs)
    backend = "nccl" if dev.type == "cuda" and cards >= world else "gloo"
    log(f"ranks: {world} on {min(cards, world)} card(s) of {cards}, backend {backend}: "
        f"{[(p, a, lay) for p, a, lay, _ in runs]}")
    mp = torch.multiprocessing.get_context("spawn")
    inbox = [mp.SimpleQueue() for _ in range(world)]
    done = mp.Queue()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        head = dict(spawned=time.time(), device_type=dev.type)
        ranks = torch.multiprocessing.spawn(
            mesh_rank, args=(world, f"file://{d}/rendezvous", backend, head, inbox, done),
            nprocs=world, join=False)
        train = world == RANKS_LAYOUT[0] * RANKS_LAYOUT[1]
        predicting = start_predictions(d, prediction_jobs(runs, train))
        finished = set()

        def wait_large():
            """Until the ranks have finished every large run handed out."""
            want = {r[0] for r in runs[:sent] if r[0] in RANKS_LARGE_RUNS}
            t0 = time.perf_counter()
            while not want <= finished:
                try:
                    finished.add(done.get(timeout=5))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in ranks.processes):
                        ranks.join()  # raises with the failed rank's error
            if want:
                log(f"ranks: waited {time.perf_counter() - t0:.3f} s for runs {sorted(want)}")

        try:
            refs, sent, train_refs = {}, 0, {}
            whiches = [w for w, _, _ in ranks_train_runs()] if train else []
            order = [a for a in RANKS_REF_ORDER if a in whiches or any(a == r[1] for r in runs)]
            order += [a for a in dict.fromkeys(r[1] for r in runs) if a not in order]
            order += [w for w in whiches if w not in order]
            for arch in order:
                if arch in RANKS_LARGE_REFS:
                    wait_large()
                if arch in whiches:
                    train_refs.update(ranks_train_refs(
                        dev, card, lambda w: prediction(d, predicting, f"{w}/train"), [arch]))
                    continue
                layouts = [lay for _, a, lay, _ in runs if a == arch]
                refs[arch] = single_device_runs(dev, card, arch, layouts)
                while sent < len(runs) and runs[sent][1] in refs:
                    part, arch_, layout, n_dec = run = runs[sent]
                    pred = {kind: prediction(d, predicting, f"{part}/{kind}")
                            for kind in ("prefill", "decode", "long")
                            if (kind != "decode" or n_dec)
                            and (kind != "long" or arch_ in RANKS_LONG)}
                    log(f"({part}) {arch_} on {layout}: the dry run's census, prefill "
                        f"{pred['prefill'][0]}" + (f", a decode step {pred['decode'][0]}"
                                                   if n_dec else "")
                        + (f", the long-context step {pred['long'][0]}" if "long" in pred
                           else "") + f"; handed to the ranks {time.perf_counter() - t:.3f} s "
                        f"after the spawn")
                    for box in inbox:
                        box.put(dict(run=run, ref=refs[arch_], pred=pred,
                                     readings=RANKS_READINGS))
                    sent += 1
            if train:
                log(f"ranks: the training references made {time.perf_counter() - t:.3f} s "
                    f"after the spawn")
                for box in inbox:
                    box.put(dict(train=train_refs, ckpt_dir=os.path.join(d, "ckpt"),
                                 readings=RANKS_READINGS))
            for box in inbox:
                box.put(None)
            while not ranks.join():
                pass
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
            if predicting.poll() is None:
                predicting.kill()
            predicting.communicate()
    log(f"ranks: {time.perf_counter() - t:.3f} s from spawn to join")


def lms_over_ranks(dev, card: str) -> None:
    """Phase 21: LMs served and trained over a mesh of ranks, every family
    in the rules' layout, and the dry run: (a) qwen2-moe on four ranks
    ``(data=2, model=2)``, prefill and decode; then on the first two ranks
    ``(1, 2)`` (b) qwen2-moe's and (c) deepseek-v3's prefill; (j)
    whisper-base and (k) xlstm-125m on ``(2, 2)``, prefill, decode and
    (xLSTM) a long-context step; (l) jamba's superblock on ``(1, 2)``,
    prefill, decode and a ``long_500k`` step; (d) every rank's census equal
    to the dry run's; (f)-(i) and (m) training over the ranks
    (``ranks_runs``); (e) the full-width dry run, in processes of its own
    from the phase's start."""
    with tempfile.TemporaryDirectory() as out_dir:
        dry = start_dryrun(out_dir)
        try:
            ranks_runs(dev, card)
            full_width_dryrun(dry, out_dir)
        finally:
            for proc in dry[1]:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.core.query import SubscriptionOracle, execute_serial, knn_query
    from repro_torch.core.types import ids_to_bitmap
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
    from repro_torch.serve import subscribe as subscribe_mod
    from repro_torch.serve.delta import DeltaLog
    from repro_torch.serve.engine import retrieve, retrieve_knn
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot, to_device
    from repro_torch.serve.subscribe import SubscriptionIndex

    # the plain versions' matrix products in full f32 (TF32 would be what
    # the CDF comparison measured); cdf_mlp_ref also enforces it itself
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with phase("kernel build"):
        _build.build_all()
    for src, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ---------------------------------------------------- data and index
    with phase("data, index and snapshot"):
        t0 = time.perf_counter()
        ds = make_dataset(PROFILE, n=N_OBJECTS, seed=SEED)
        t1 = time.perf_counter()
        index = build_str_rtree(ds, leaf_size=LEAF_SIZE, fanout=FANOUT)
        t2 = time.perf_counter()
        snap = IndexSnapshot.build(index, ds, device=dev, dense=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    assert snap.has_narrow_planes, "a level overflowed NARROW_DICT_MAX"
    assert snap.has_compact_bank, "a leaf overflowed LEAF_DICT_MAX"
    log(f"dataset {PROFILE} n={ds.n} W={ds.words} vocab={ds.vocab_size}: {t1 - t0:.3f} s")
    log(f"str-rtree levels={[l.n for l in index.levels]}: {t2 - t1:.3f} s")
    log(f"snapshot (dense=True): {t3 - t2:.3f} s, {snap.nbytes()} B on the device, of which "
        f"{sum(m.numel() for m in snap.child_matrix)} B of dense child matrices; "
        f"OBJ={snap.obj_per_leaf} Wl={snap.n_compact_words} "
        f"dicts={[int(d.numel()) for d in snap.level_dict_x]}")
    wl = make_workload(ds, m=N_QUERIES, dist="MIX", seed=1)
    points = query_points(wl)
    bms = wl.kw_bitmap
    batches = [np.arange(i, i + BATCH) for i in range(0, N_QUERIES, BATCH)]
    n_leaf = index.levels[-1].n

    def cached(warm):
        cache = PlanCache()
        cache.widths = dict(warm.widths)
        return cache

    # ------------------------ warm-up passes, capturing kernel operands
    captured = {}

    def recorder(key, fn, size_arg, kw_keys=()):
        """Pass calls through to ``fn``, keeping the largest call's operands
        (the keyword arguments ``kw_keys`` appended to the positional ones;
        only calls that pass them all count)."""
        def rec(*args, **kw):
            prev = captured.get(key)
            given = all(kw.get(k) is not None for k in kw_keys)
            if given and (prev is None or args[size_arg].numel() > prev[size_arg].numel()):
                captured[key] = args + tuple(kw[k] for k in kw_keys)
            return fn(*args, **kw)
        return rec

    warm, warm_knn = PlanCache(), PlanCache()
    with phase("warm-up: SKR and kNN batches"), patched(
        ops,  # sized by the frontier (M, F) and top_leaf (M, T)
        frontier_level_narrow=recorder("frontier_level_narrow", ops.frontier_level_narrow, 4),
        fused_verify_leaf_words=recorder("fused", ops.fused_verify_leaf_words, 3),
        knn_level_dist_narrow=recorder("knn_level_dist_narrow", ops.knn_level_dist_narrow, 5),
    ):
        for b in batches:
            serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=warm)
        for b in batches:
            serve_knn_batch(snap, points[b], bms[b], K, plan_cache=warm_knn)
    log(f"learned widths: SKR {sorted(warm.widths.items())}, "
        f"kNN {sorted(warm_knn.widths.items())}")

    # ------------------------------------------------------ SKR main path
    def serve_all(variant=None):
        cache = cached(warm)
        outs, times = [], []
        for b in batches:
            t = time.perf_counter()
            if variant is None:
                out = serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache)
            else:
                out = retrieve(snap, wl.rects[b], bms[b], MAX_LEAVES,
                               plan_cache=cache, fused_variant=variant)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(out)
        return outs, times

    def refuse(what):
        def fail(*a, **kw):
            raise AssertionError(f"the run called {what}, which it no longer needs")
        return fail

    # no per-slot planes on any descent: the range filters' gathered-plane
    # wrappers (the TPU kernels' operands) must not run
    no_slot_planes = dict(filter_frontier=refuse("filter_frontier"),
                          filter_frontier_narrow=refuse("filter_frontier_narrow"))
    # no fused SKR batch builds the compact verify's per-slot query words:
    # the kernel remaps them itself
    no_remap = dict(remap_query_words=refuse("remap_query_words"))

    def check_descent(counts, name, what):
        """The descent ran ``name`` once per level of every batch, and the
        other frontier filter never."""
        other = "frontier_level" if name == "frontier_level_narrow" else "frontier_level_narrow"
        if counts[name] != snap.n_levels * len(batches) or counts[other]:
            raise AssertionError(f"{what} did not launch {name} once per level: {counts}")

    plain_fused = lambda *a: ref.fused_verify_compact_ref(*a)  # noqa: E731
    plain_leaf = lambda *a, variant="auto", words=False: (  # noqa: E731
        ref.fused_verify_leaf_words_ref(*a, words=words))

    def check_remap(counts, name, what):
        """The fused verify ran its remapping instance ``name`` once a batch
        and the given-words instances never."""
        given = counts["fused_verify_compact_slot"] + counts["fused_verify_compact_tile"]
        if counts[name] != len(batches) or given:
            raise AssertionError(f"{what} did not launch {name} once a batch: {counts}")

    launches = {}
    with phase("SKR main path, plain rerun"):
        _build.reset_launch_counts()
        with patched(ops, **no_slot_planes, **no_remap):
            main_out, main_t = serve_all()
            main_counts = _build.launch_counts()
            log(f"SKR main path serve_batch x{len(batches)} (auto): batch s {main_t}, "
                f"launches {main_counts}; no per-slot plane gathered, remap_query_words "
                f"refused")
            _build.reset_launch_counts()
            vmem_out, vmem_t = serve_all("vmem")
            vmem_counts = _build.launch_counts()
        log(f"SKR main path retrieve(fused_variant='vmem') x{len(batches)}: batch s {vmem_t}, "
            f"launches {vmem_counts}")
        check_descent(main_counts, "frontier_level_narrow", "the SKR main path")
        check_descent(vmem_counts, "frontier_level_narrow", "the SKR vmem run")
        check_remap(main_counts, "fused_verify_remap_slot", "the SKR main path")
        check_remap(vmem_counts, "fused_verify_remap_tile", "the SKR vmem run")
        for key, counts in (("frontier_level_narrow", main_counts),
                            ("fused_verify_remap_slot", main_counts),
                            ("fused_verify_remap_tile", vmem_counts)):
            if counts[key] <= 0:
                raise AssertionError(f"the SKR main path never launched {key}")
            launches[key] = counts[key]

        _build.reset_launch_counts()
        with patched(ops, frontier_level_narrow=ref.frontier_level_narrow_ref,
                     fused_verify_leaf_words=plain_leaf):
            plain_out, plain_t = serve_all()
        if any(_build.launch_counts().values()):
            raise AssertionError("the plain run launched a kernel")
        log(f"SKR plain-version run: batch s {plain_t}")
        for run, outs in (("auto", main_out), ("vmem", vmem_out)):
            for bi, (got, want) in enumerate(zip(outs, plain_out)):
                assert_outputs_equal(got, want, f"SKR {run} batch {bi} vs the plain run")
        log("SKR main path equals the plain-version run on every key, dtype and shape")

    # ---------------------------------------------------------- host oracle
    with phase("SKR execute_serial oracle"):
        cat = {k: np.concatenate([o[k] for o in main_out]) for k in
               ("ids", "nodes_checked", "verified", "overflow", "counts")}
        ok = np.flatnonzero(cat["overflow"] == 0)[:N_ORACLE]
        if ok.size < N_ORACLE:
            raise AssertionError(f"only {ok.size} queries without overflow")
        oracle_st = check_skr_oracle(execute_serial, index, ds, wl, cat, ok, "SKR main path")
        oracle_ok = ok
        log(f"execute_serial oracle on {ok.size} queries with overflow == 0: equal; "
            f"queries with overflow: {int((cat['overflow'] > 0).sum())} of {N_QUERIES}, "
            f"results {int(cat['counts'].sum())}")

    # ------------------------------------------------------ kNN main path
    def serve_knn_all(k=K, knn_dtype="f32"):
        cache = cached(warm_knn)
        outs, times = [], []
        for b in batches:
            t = time.perf_counter()
            outs.append(serve_knn_batch(snap, points[b], bms[b], k, plan_cache=cache,
                                        knn_dtype=knn_dtype))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, times

    with phase("kNN main path, plain rerun"):
        _build.reset_launch_counts()
        # no per-slot planes: the gathered-plane wrappers must not run
        with patched(ops, knn_frontier_dist_narrow=refuse("knn_frontier_dist_narrow"),
                     **no_slot_planes):
            knn_out, knn_t = serve_knn_all()
        knn_counts = _build.launch_counts()
        log(f"kNN main path serve_knn_batch(k={K}) x{len(batches)}: batch s {knn_t}, "
            f"launches {knn_counts}; no per-slot plane gathered")
        if knn_counts["knn_level_dist_narrow"] <= 0:
            raise AssertionError("the kNN main path never launched knn_level_dist_narrow")
        launches["knn_level_dist_narrow"] = knn_counts["knn_level_dist_narrow"]
        _build.reset_launch_counts()
        with patched(ops, knn_level_dist_narrow=ref.knn_level_dist_narrow_ref):
            knn_plain, knn_plain_t = serve_knn_all()
        if any(_build.launch_counts().values()):
            raise AssertionError("the kNN plain run launched a kernel")
        log(f"kNN plain-version run: batch s {knn_plain_t}")
        for bi, (got, want) in enumerate(zip(knn_out, knn_plain)):
            assert_outputs_equal(got, want, f"kNN batch {bi} vs the plain run")
        log("kNN main path equals the plain-version run on every key, dtype and shape")

    with phase("kNN knn_query oracle, k = 1 and 100, bf16"):
        kcat = {k: np.concatenate([o[k] for o in knn_out]) for k in
                ("ids", "dist2", "leaves_verified", "pruned", "verified")}
        check_knn_oracle(knn_query, index, ds, kcat, points, bms, range(N_ORACLE), K,
                         f"kNN k={K}")
        ratio = N_QUERIES * n_leaf / max(float(kcat["leaves_verified"].sum()), 1.0)
        if not ratio > 1.0:
            raise AssertionError(f"the bounded descent did not prune (ratio {ratio})")
        log(f"knn_query oracle on {N_ORACLE} queries at k={K}: ids and dist2 bit-equal; "
            f"pruning ratio {ratio:.3f} (m * n_leaf / leaves verified), mean leaves verified "
            f"{kcat['leaves_verified'].mean():.3f}, objects verified "
            f"{kcat['verified'].mean():.3f}, slots pruned {kcat['pruned'].mean():.3f}, "
            f"frontier widths {knn_out[0]['frontier_widths'].tolist()}")
        b0 = batches[0]
        for k in K_EDGES:
            t = time.perf_counter()
            out = serve_knn_batch(snap, points[b0], bms[b0], k, plan_cache=cached(warm_knn))
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            check_knn_oracle(knn_query, index, ds, out, points[b0], bms[b0], range(N_ORACLE), k,
                             f"kNN k={k}")
            log(f"k={k}: one batch {t:.6f} s, ids and dist2 bit-equal to knn_query on "
                f"{N_ORACLE} queries, frontier widths {out['frontier_widths'].tolist()}")
        t = time.perf_counter()
        bf = serve_knn_batch(snap, points[b0], bms[b0], K, plan_cache=cached(warm_knn),
                             knn_dtype="bf16")
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        for key in ("ids", "dist2"):
            if not np.array_equal(bf[key], knn_out[0][key]):
                raise AssertionError(f"knn_dtype='bf16' {key} differs from f32")
        log(f"knn_dtype='bf16' batch {t:.6f} s: ids and dist2 equal to f32 "
            f"(knn_dtype_retried={bf['knn_dtype_retried']})")

    # ------------------------------------------------------- f32 descent
    with phase("f32 descent: quantized=False and stripped snapshot"):
        _build.reset_launch_counts()
        with patched(ops, frontier_level=recorder("frontier_level/f32", ops.frontier_level, 4),
                     **no_slot_planes):
            cache = cached(warm)
            f32_t = []
            for bi, b in enumerate(batches):
                t = time.perf_counter()
                out = retrieve(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache,
                               quantized=False)
                torch.cuda.synchronize()
                f32_t.append(time.perf_counter() - t)
                assert_outputs_equal(out, main_out[bi], f"SKR quantized=False batch {bi}")
        counts = _build.launch_counts()
        log(f"SKR quantized=False x{len(batches)}: batch s {f32_t}, launches {counts}")
        check_descent(counts, "frontier_level", "the SKR f32 descent")
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with patched(ops, knn_level_dist=recorder("knn_level_dist", ops.knn_level_dist, 5)):
            t = time.perf_counter()
            out = retrieve_knn(snap, points[b0], bms[b0], K, plan_cache=cached(warm_knn),
                               quantized=False)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - mem0
        assert_outputs_equal(out, knn_out[0], "kNN quantized=False batch 0")
        counts = _build.launch_counts()
        fr = captured["knn_level_dist"][5]
        plane = fr.numel() * snap.level_bms[-1].shape[1] * 4
        log(f"kNN quantized=False: one batch {t:.6f} s, peak device memory above the start "
            f"{peak} B (an (M, F, W) word plane at the widest level would be {plane} B), "
            f"launches {counts}")
        if counts["knn_level_dist"] <= 0 or counts["knn_level_dist_narrow"] != 0:
            raise AssertionError("the kNN f32 descent did not run on knn_level_dist alone")
        if peak >= plane:
            raise AssertionError("the kNN f32 descent allocated an (M, F, W) word plane")
        launches["knn_level_dist"] = counts["knn_level_dist"]

        stripped = dataclasses.replace(snap, level_mbr_codes=[], level_dict_x=[],
                                       level_dict_y=[])
        assert not stripped.has_narrow_planes
        out = retrieve(stripped, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cached(warm))
        assert_outputs_equal(out, main_out[0], "SKR on the stripped snapshot")
        out = retrieve_knn(stripped, points[b0], bms[b0], K, plan_cache=cached(warm_knn))
        assert_outputs_equal(out, knn_out[0], "kNN on the stripped snapshot")
        log("quantized=False and stripped-snapshot runs equal the default runs on every key")

    # ------------------------------------------------------- verify knobs
    # one batch per knob, equal to the default run; each kernel's operands
    # captured at the shapes the knob gives it
    knob_launches = {}
    no_cbank = dataclasses.replace(snap, leaf_terms=None, leaf_obj_cbm=None, leaf_obj_sig=None)
    knobs = [  # (label, snapshot, retrieve knobs, kernels the run must launch)
        ("fused=False", snap, dict(fused=False), ("skr_verify_compact",)),
        ("compact=False", snap, dict(compact=False), ("fused_verify_slot",)),
        ("compact=False, fused_variant='vmem'", snap, dict(compact=False, fused_variant="vmem"),
         ("fused_verify_tile",)),
        ("fused=False, compact=False", snap, dict(fused=False, compact=False), ("skr_verify",)),
        ("no compact bank", no_cbank, {}, ("fused_verify_slot",)),
    ]
    with phase("verify knobs"), patched(
        ops,  # sized by top_leaf (M, T) and cand_x (M, C)
        fused_gather_verify=recorder("fused_wide", ops.fused_gather_verify, 2, ("q_words",)),
        verify_candidates_counted=recorder("skr_verify/knob", ops.verify_candidates_counted, 2),
        verify_candidates_compact_counted=recorder("skr_verify_compact/knob",
                                                   ops.verify_candidates_compact_counted, 3),
    ):
        for label, snap_k, kw, kernels in knobs:
            _build.reset_launch_counts()
            t = time.perf_counter()
            out = retrieve(snap_k, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cached(warm), **kw)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            counts = _build.launch_counts()
            assert_outputs_equal(out, main_out[0], f"SKR {label}")
            for name in kernels:
                if counts[name] <= 0:
                    raise AssertionError(f"SKR {label} never launched {name}")
                knob_launches.setdefault(name, counts[name])
            log(f"SKR {label}: one batch {t:.6f} s, equal to the default run on every key; "
                f"launches {counts}")
    del no_cbank

    # -------------------------------------------------------- live updates
    leaf_mbrs = index.levels[-1].mbrs
    leaf_terms = snap.leaf_terms.cpu().numpy()
    plain_ops = dict(
        frontier_level=ref.frontier_level_ref,
        fused_verify_leaf_words=plain_leaf,
        verify_slots=ref.skr_verify_slots_ref,
        verify_slots_compact=ref.skr_verify_slots_compact_ref,
        knn_level_dist=ref.knn_level_dist_ref,
    )
    slot_kernels = ("skr_verify_slots", "skr_verify_slots_compact")
    delta_launches = {}
    delta_bufs = {}
    delta_caches = {}  # label -> the SKR plan cache learned with the log's delta
    delta_skr = {}  # label -> the SKR batches served with the log's delta
    delta_knn = {}  # label -> the kNN batch served with the log's delta

    def live_updates(label, own_leaf_terms, jitter, seed, verify_kernel, capture):
        """One DeltaLog: N_INSERT inserts in batches, N_DELETE deletes, the
        SKR batches and one kNN batch against their plain reruns and the
        host oracles over a cold index of the merged data."""
        rng = np.random.default_rng(seed)
        leaf_vocab = (leaf_mbrs, leaf_terms) if own_leaf_terms else ()
        dlog = DeltaLog(index, ds, snap)
        t_ins, new_ids = [], []
        n_batches = N_INSERT // INSERT_BATCH
        probe = None
        for i in range(n_batches):
            locs, kw = make_update_stream(ds, INSERT_BATCH, rng, jitter, *leaf_vocab)
            if i == n_batches - 1:  # deletes, then a buffer handed out before the last insert
                dels = np.concatenate([
                    rng.choice(ds.n, N_DELETE - N_DELETE_BUFFERED, replace=False),
                    rng.choice(np.concatenate(new_ids), N_DELETE_BUFFERED, replace=False)])
                if dlog.delete(dels) != N_DELETE:
                    raise AssertionError(f"log {label}: not every delete took")
                old = dlog.buffer
                probe = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=PlanCache(),
                                    delta=old)
            t = time.perf_counter()
            new_ids.append(dlog.insert(locs, kw))
            torch.cuda.synchronize()
            t_ins.append(time.perf_counter() - t)
        buf = dlog.buffer
        again = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=PlanCache(),
                            delta=old)
        assert_outputs_equal(again, probe, f"log {label}: the buffer taken before the last insert")
        if dlog.compact_ok != own_leaf_terms:
            raise AssertionError(f"log {label}: compact_ok is {dlog.compact_ok}")
        if buf.n_buffered() != N_INSERT - N_DELETE_BUFFERED or buf.n_deleted() != \
                N_DELETE - N_DELETE_BUFFERED:
            raise AssertionError(f"log {label}: buffered/deleted counts are off")
        log(f"log {label}: {N_INSERT} inserts in batches of {INSERT_BATCH}, host s per batch "
            f"{t_ins} (mean {1e3 * np.mean(t_ins):.3f} ms per {INSERT_BATCH}); {N_DELETE} deletes "
            f"({N_DELETE_BUFFERED} buffered); slots_per_leaf={buf.slots_per_leaf} "
            f"compact_ok={dlog.compact_ok}; delta on the device {buf.nbytes()} B; the buffer "
            f"taken before the last insert still gives its earlier answer")

        skr_cache, knn_cache = PlanCache(), PlanCache()

        def serve_skr(cache):
            outs, times = [], []
            for b in batches:
                t = time.perf_counter()
                outs.append(serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache,
                                        delta=buf))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return outs, times

        def serve_knn(cache):
            t = time.perf_counter()
            out = serve_knn_batch(snap, points[b0], bms[b0], K, plan_cache=cache, delta=buf)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        serve_skr(skr_cache)  # warm-up: learns the widened descent's widths
        serve_knn(knn_cache)
        _build.reset_launch_counts()
        with patched(ops, frontier_level=recorder(f"frontier_level/log {label}",
                                                  ops.frontier_level, 4),
                     **{capture[0]: recorder(capture[1], getattr(ops, capture[0]), capture[2])},
                     **no_slot_planes, **no_remap):
            skr_out, skr_t = serve_skr(cached(skr_cache))
        skr_counts = _build.launch_counts()
        _build.reset_launch_counts()
        knn_d, knn_dt = serve_knn(cached(knn_cache))
        knn_counts = _build.launch_counts()
        log(f"log {label} SKR serve_batch(delta) x{len(batches)}: batch s {skr_t}, launches "
            f"{skr_counts}; remap_query_words refused")
        log(f"log {label} kNN serve_knn_batch(k={K}, delta): one batch {knn_dt:.6f} s, launches "
            f"{knn_counts}")
        check_descent(skr_counts, "frontier_level", f"log {label} SKR")
        check_remap(skr_counts, "fused_verify_remap_slot", f"log {label} SKR")
        # the insert slots: the slot entry once a batch, on the delta's own
        # buffers, and no gathered entry
        others = [n for n in (*slot_kernels, "skr_verify", "skr_verify_compact")
                  if n != verify_kernel and skr_counts[n]]
        if skr_counts[verify_kernel] != len(batches) or others:
            raise AssertionError(f"log {label}: SKR did not launch {verify_kernel} once a batch "
                                 f"and no other verify entry: {skr_counts}")
        if knn_counts["knn_level_dist_narrow"]:
            raise AssertionError(f"log {label}: a delta descent ran on the narrow planes")
        if knn_counts["knn_level_dist"] <= 0:
            raise AssertionError(f"log {label}: kNN never launched knn_level_dist")
        delta_launches[verify_kernel] = skr_counts[verify_kernel]
        delta_launches["frontier_level"] = skr_counts["frontier_level"]  # log B's is the row's
        _build.reset_launch_counts()
        with patched(ops, **plain_ops):
            plain_skr, _ = serve_skr(cached(skr_cache))
            plain_knn, _ = serve_knn(cached(knn_cache))
        if any(_build.launch_counts().values()):
            raise AssertionError(f"log {label}: the plain run launched a kernel")
        for bi, (got, want) in enumerate(zip(skr_out, plain_skr)):
            assert_outputs_equal(got, want, f"log {label} SKR batch {bi} vs the plain run")
        assert_outputs_equal(knn_d, plain_knn, f"log {label} kNN vs the plain run")

        merged = dlog.merged_dataset()
        cold = build_str_rtree(merged, leaf_size=LEAF_SIZE, fanout=FANOUT)
        cat = {k: np.concatenate([o[k] for o in skr_out]) for k in ("ids", "overflow")}
        ok = np.flatnonzero(cat["overflow"] == 0)[:N_ORACLE]
        if ok.size < N_ORACLE:
            raise AssertionError(f"log {label}: only {ok.size} queries without overflow")
        st = execute_serial(cold, merged, wl.subset(ok))
        for j, q in enumerate(ok):
            row = cat["ids"][q]
            if not np.array_equal(np.sort(row[row >= 0]), np.sort(st.results[j])):
                raise AssertionError(f"log {label} query {q}: ids differ from execute_serial")
        check_knn_oracle(knn_query, cold, merged, knn_d, points[b0], bms[b0], range(N_ORACLE), K,
                         f"log {label} kNN")
        log(f"log {label}: every key equals the plain-version run; SKR ids equal execute_serial "
            f"and kNN ids and dist2 equal knn_query on {N_ORACLE} queries each, over a cold "
            f"STR index of the {merged.n} merged objects")
        delta_bufs[label] = buf
        delta_caches[label] = skr_cache
        delta_skr[label] = skr_out
        delta_knn[label] = knn_d

    with phase("live updates"):
        live_updates("A", True, 1e-3, 21, "skr_verify_slots_compact",
                     ("verify_slots_compact", "skr_verify_slots_compact/delta", 3))
        live_updates("B", False, 0.05, 22, "skr_verify_slots",
                     ("verify_slots", "skr_verify_slots/delta", 2))

    with phase("delta SKR batch memory"):
        # log B's warm delta SKR batch, peak device memory above its start
        # against one (M, T*B, W) int32 plane of its insert slots: the plane
        # the engine gathered before row 10 read the delta's buffers
        slot_args = captured["skr_verify_slots/delta"]
        M, T = slot_args[2].shape
        _, B, W = slot_args[6].shape
        plane = M * T * B * W * 4
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES,
                          plan_cache=cached(delta_caches["B"]), delta=delta_bufs["B"])
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - mem0
        assert_outputs_equal(out, delta_skr["B"][0], "log B's delta SKR batch 0 again")
        log(f"log B's warm delta SKR batch: {t:.6f} s, peak device memory above its start "
            f"{peak} B; one (M, T*B, W) = ({M}, {T}*{B}, {W}) int32 insert-slot plane {plane} B")
        if peak >= plane:
            raise AssertionError("log B's delta SKR batch allocated an insert-slot plane's bytes")

    # ------------------------------------------------------ dense A/B scan
    def sorted_sets(out):
        return [np.sort(row[row >= 0]) for row in out["ids"]]

    def same_sets(got, want, what):
        if not np.array_equal(got["overflow"], want["overflow"]):
            raise AssertionError(f"{what}: overflow differs from the frontier run")
        for q, (a, b) in enumerate(zip(sorted_sets(got), sorted_sets(want))):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what} query {q}: result set differs from the frontier run")

    plain_dense_ops = dict(
        filter_pairs=ref.skr_filter_ref,
        fused_verify_leaf_words=plain_leaf,
        verify_slots=ref.skr_verify_slots_ref,
        verify_slots_compact=ref.skr_verify_slots_compact_ref,
    )
    dense_levels = []  # the first batch's filter_pairs operands, one per level
    record_filter = recorder("skr_filter", ops.filter_pairs, 2)

    def record_levels(*a, **kw):
        if len(dense_levels) < snap.n_levels:
            dense_levels.append(a)
        return record_filter(*a, **kw)

    with phase("dense A/B scan"):
        _build.reset_launch_counts()
        dense_out, dense_t = [], []
        with patched(ops, filter_pairs=record_levels, **no_remap):
            for b in batches:
                t = time.perf_counter()
                dense_out.append(serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, mode="dense"))
                torch.cuda.synchronize()
                dense_t.append(time.perf_counter() - t)
        counts = _build.launch_counts()
        if counts["skr_filter"] != snap.n_levels * len(batches) or counts["frontier_level_narrow"]:
            raise AssertionError(f"the dense scan did not run skr_filter once per level: {counts}")
        launches["skr_filter"] = counts["skr_filter"]
        log(f"dense serve_batch(mode='dense') x{len(batches)}: batch s {dense_t}, skr_filter "
            f"launches per batch {counts['skr_filter'] // len(batches)}, launches {counts}")
        # every level's launch of a batch, timed alone at its operands: the
        # kernel's device time and the wrapper's time per call back to back
        lvl = [kernel_ms(lambda a=a: ops.filter_pairs(*a)) for a in dense_levels]
        lvl_bound = [bound_ms(*filter_bound(a))[0] for a in dense_levels]
        log(f"skr_filter per level of dense batch 0 at K = "
            f"{[int(a[2].shape[0]) for a in dense_levels]}: kernel {[note for _, note in lvl]}; sum per batch {sum(t for t, _ in lvl):.6f} ms; "
            f"bound ms {[round(t, 6) for t in lvl_bound]}, sum {sum(lvl_bound):.6f} ms")
        _build.reset_launch_counts()
        with patched(ops, **plain_dense_ops):
            dense_plain = [serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, mode="dense")
                           for b in batches]
        if any(_build.launch_counts().values()):
            raise AssertionError("the dense plain run launched a kernel")
        for bi, (got, want) in enumerate(zip(dense_out, dense_plain)):
            assert_outputs_equal(got, want, f"dense batch {bi} vs the plain run")
            same_sets(got, main_out[bi], f"dense batch {bi}")
            if (got["nodes_scanned"] < main_out[bi]["nodes_scanned"]).any():
                raise AssertionError(f"dense batch {bi}: nodes_scanned below the frontier's")
        dcat = np.concatenate([o["ids"] for o in dense_out])
        for j, q in enumerate(oracle_ok):
            row = dcat[q]
            if not np.array_equal(np.sort(row[row >= 0]), np.sort(oracle_st.results[j])):
                raise AssertionError(f"dense query {q}: ids differ from execute_serial")
        t = time.perf_counter()
        dense_delta = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense",
                                  delta=delta_bufs["A"])
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        with patched(ops, **plain_dense_ops):
            want = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense",
                               delta=delta_bufs["A"])
        assert_outputs_equal(dense_delta, want, "dense batch with log A's delta vs the plain run")
        same_sets(dense_delta, delta_skr["A"][0], "dense batch with log A's delta")
        log(f"dense scan: every key equals the plain-version run; overflow and result sets equal "
            f"the frontier run's; nodes_scanned {int(dense_out[0]['nodes_scanned'][0])} vs the "
            f"frontier's {int(main_out[0]['nodes_scanned'].max())} at most; ids equal "
            f"execute_serial on {oracle_ok.size} queries; with log A's delta one batch {t:.6f} s, "
            f"equal to its plain rerun and to the frontier's result sets")

    # ------------------------------------------------ standing subscriptions
    class StepClock:
        """Host time of ``match_arrivals``' steps: while ``on``, each
        wrapped function's time (after a device sync) adds to its step; a
        wrapped call inside another counts only in the outer one."""

        def __init__(self):
            self.on, self.busy, self.acc = False, False, {}

        def wrap(self, step, fn):
            def timed(*a, **kw):
                if not self.on or self.busy:
                    return fn(*a, **kw)
                self.busy = True
                t = time.perf_counter()
                try:
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                finally:
                    self.busy = False
                self.acc[step] = self.acc.get(step, 0.0) + time.perf_counter() - t
                return out
            return timed

    def subscription_stream(arrivals=None, dlog=None, twin=None, clock=None):
        """One run of the subscription schedule. With ``dlog`` the arrivals
        are log A's insert batches, inserted into ``dlog`` and matched in
        the same step (``twin``, if given, pumps the log after each batch);
        else the recorded ``arrivals`` are replayed. Returns the index, the
        arrival batches, the unsubscribed ids and per batch of
        ``match_arrivals``: host seconds, peak device memory above its
        start, notifications queued and (with ``clock``) host seconds by
        step."""
        idx = SubscriptionIndex(ds.vocab_size, device=dev)
        indexes = [idx] + ([twin] if twin is not None else [])
        for i in indexes:
            for r, kw in zip(subs_wl.rects, subs_wl.kw_ids):
                i.subscribe(r, kw)
        rng = np.random.default_rng(21)
        leaf_vocab = (leaf_mbrs, leaf_terms)
        batches_in, gone = [], None
        per = dict(t=[], peak=[], queued=[], steps=[])
        for bi in range(N_INSERT // INSERT_BATCH):
            if dlog is not None:
                locs, kw = make_update_stream(ds, INSERT_BATCH, rng, 1e-3, *leaf_vocab)
                ids = dlog.insert(locs, kw)
                batches_in.append((ids, locs, kw))
            else:
                ids, locs, kw = arrivals[bi]
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if clock is not None:
                clock.on, clock.acc = True, {}
            t = time.perf_counter()
            per["queued"].append(idx.match_arrivals(ids, locs, kw_ids=kw))
            torch.cuda.synchronize()
            per["t"].append(time.perf_counter() - t)
            per["peak"].append(torch.cuda.max_memory_allocated() - mem0)
            if clock is not None:
                clock.on = False
                per["steps"].append(clock.acc)
            if twin is not None:
                twin.pump(dlog)
            if bi == 4:  # churn: 10,000 leave, 10,000 join into their slots
                gone = np.random.default_rng(23).choice(N_SUBS, N_SUB_CHURN, replace=False)
                for i in indexes:
                    for sid in gone:
                        i.unsubscribe(int(sid))
                    for r, kw in zip(churn_wl.rects, churn_wl.kw_ids):
                        i.subscribe(r, kw)
        return idx, batches_in, gone, per

    def canon(pairs, S):
        """Match pairs in (object, slot) order."""
        return pairs[torch.argsort(pairs[:, 0].long() * S + pairs[:, 1].long())]

    # the stream runs neither the matrix entries nor host packing
    no_matrix = dict(sub_match=refuse("sub_match"), match_subscriptions=refuse(
        "match_subscriptions"), pack_query_words=refuse("pack_query_words"))
    with phase("standing subscriptions"):
        t = time.perf_counter()
        subs_wl = make_workload(ds, m=N_SUBS, dist="MIX", seed=2)
        churn_wl = make_workload(ds, m=N_SUB_CHURN, dist="MIX", seed=3)
        log(f"subscription rectangles and keywords (MIX workloads of {N_SUBS} and "
            f"{N_SUB_CHURN}): {time.perf_counter() - t:.3f} s")
        dlog = DeltaLog(index, ds, snap)
        twin = SubscriptionIndex(ds.vocab_size, device=dev)
        clock = StepClock()
        compile_block = clock.wrap("block compile", SubscriptionIndex.block)
        pair_calls = []
        record_pairs = recorder("sub_match_pairs", clock.wrap(
            "kernel and count readback", ops.match_subscription_pairs), 1)
        _build.reset_launch_counts()
        with patched(ops, match_subscription_pairs=lambda *a: pair_calls.append(1) or record_pairs(*a),
                     **no_matrix), \
                patched(subscribe_mod, ids_to_bitmap=clock.wrap("bitmaps", subscribe_mod.ids_to_bitmap),
                        to_device=clock.wrap("upload", subscribe_mod.to_device),
                        canonical_pairs=clock.wrap("sort and copy", subscribe_mod.canonical_pairs)), \
                patched(SubscriptionIndex, block=lambda self: (
                    compile_block(self) if self._block is None else self._block)):
            sub_idx, arrivals, gone, per = subscription_stream(dlog=dlog, twin=twin, clock=clock)
        counts = _build.launch_counts()
        n_batches = N_INSERT // INSERT_BATCH
        # each batch: one match by match_arrivals, one by the twin's pump
        if counts["sub_match_pairs"] < 2 * n_batches or counts["sub_match"]:
            raise AssertionError(f"the stream did not launch sub_match_pairs for every match and "
                                 f"the matrix instance never: {counts}")
        launches["sub_match_pairs"] = counts["sub_match_pairs"]
        retries = counts["sub_match_pairs"] - len(pair_calls)
        # peak device memory a match took: above the batch's start, less the
        # block compiled in the batch (the first, and the first after the churn)
        plane = INSERT_BATCH * sub_idx.n_slots  # one (N, S) int8 match matrix
        match_peak = [p - sub_idx.block().nbytes() * ("block compile" in d)
                      for p, d in zip(per["peak"], per["steps"])]
        if max(match_peak) >= plane:
            raise AssertionError(f"a match_arrivals batch allocated an (N, S) matrix's bytes: "
                                 f"{per['peak']}")
        if sub_idx.n_live != N_SUBS or sub_idx.n_slots != twin.n_slots:
            raise AssertionError("the block's live or slot count is off after the churn")
        if sub_idx.pump(dlog) != 0:
            raise AssertionError("pump after match_arrivals queued notifications")
        stream = sub_idx.drain()
        if not np.array_equal(stream, twin.drain()):
            raise AssertionError("the pump-only twin drained another stream")
        if sub_idx.drain().shape != (0, 2):
            raise AssertionError("a second drain was not empty")
        blk = sub_idx.block()
        t_match = per["t"]
        log(f"subscriptions: {N_SUBS} in {sub_idx.n_slots} slots, block {blk.nbytes()} B on the "
            f"device; {N_INSERT} arrivals in batches of {INSERT_BATCH}: match_arrivals host ms per "
            f"batch {[round(1e3 * t, 3) for t in t_match]} (mean {1e3 * np.mean(t_match):.3f}); "
            f"{stream.shape[0]} notifications, per batch {per['queued']}; sub_match_pairs launches "
            f"{counts['sub_match_pairs']} for {len(pair_calls)} matches (both indexes), retries "
            f"{retries} at capacity {ops.SUB_PAIRS_CAPACITY}; sub_match (the matrix) 0, "
            f"pack_query_words and the matrix entries refused; peak device memory above the start "
            f"per batch {per['peak']} B, less a block compiled in the batch {match_peak} B, below "
            f"one (N, S) int8 matrix ({plane} B); pump afterwards "
            f"queued nothing; the pump-only twin drained the same stream")
        steps = sorted({k for d in per["steps"] for k in d})
        for bi, (d, t) in enumerate(zip(per["steps"], t_match)):
            rest = t - sum(d.values())
            log(f"  match_arrivals batch {bi} host ms by step (each after a device sync): "
                + ", ".join(f"{k} {1e3 * d.get(k, 0.0):.3f}" for k in steps)
                + f", queue and the rest {1e3 * rest:.3f}")
        steady = [bi for bi, d in enumerate(per["steps"]) if "block compile" not in d]
        mean = {k: 1e3 * np.mean([per["steps"][bi].get(k, 0.0) for bi in steady]) for k in steps}
        log(f"  mean over the {len(steady)} batches with no block compile: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in mean.items())
            + f", total {1e3 * np.mean([t_match[bi] for bi in steady]):.3f} ms")
        _build.reset_launch_counts()
        with patched(ops, match_subscription_pairs=plain_pairs):
            plain_idx, _, _, _ = subscription_stream(arrivals=arrivals)
        if any(_build.launch_counts().values()):
            raise AssertionError("the plain subscription run launched a kernel")
        if not np.array_equal(plain_idx.drain(), stream):
            raise AssertionError("the stream differs from the plain-version run")
        del plain_idx, twin
        # the oracle replay on a seeded sample: half of it among the
        # subscriptions that were notified, half uniform over all of them
        rng = np.random.default_rng(29)
        notified = np.unique(stream[:, 1])
        half = min(N_SUB_SAMPLE // 2, notified.size)
        sample = np.union1d(rng.choice(notified, half, replace=False),
                            rng.choice(N_SUBS + N_SUB_CHURN, N_SUB_SAMPLE - half, replace=False))
        rects = np.concatenate([subs_wl.rects, churn_wl.rects])
        kws = np.concatenate([subs_wl.kw_ids, churn_wl.kw_ids])
        oracle, to_oracle = SubscriptionOracle(), {}
        gone_set = set(int(g) for g in gone)
        for sid in sample[sample < N_SUBS]:
            to_oracle[int(sid)] = oracle.subscribe(rects[sid], kws[sid])
        for bi, (ids, locs, kw) in enumerate(arrivals):
            oracle.arrive(ids, locs, kw)
            if bi == 4:
                for sid in sorted(gone_set & set(to_oracle)):
                    oracle.unsubscribe(to_oracle[sid])
                for sid in sample[sample >= N_SUBS]:
                    to_oracle[int(sid)] = oracle.subscribe(rects[sid], kws[sid])
        keep = np.isin(stream[:, 1], sample)
        mapped = np.stack([stream[keep, 0], [to_oracle[int(s)] for s in stream[keep, 1]]], 1)
        want = oracle.drain()
        if not np.array_equal(mapped.reshape(-1, 2), want):
            raise AssertionError("the sampled stream differs from SubscriptionOracle's replay")
        log(f"subscriptions: every notification equals the plain-version run pair for pair; on "
            f"{sample.size} sampled subscriptions ({half} of them notified) the {want.shape[0]} "
            f"notifications equal SubscriptionOracle's replay")
        # the matrix entry (match_subscriptions, host-packed words) on the
        # first arrival batch against the final block: its launch is row
        # 11's matrix instance, and its nonzero entries equal the pairs
        ids0, locs0, kw0 = arrivals[0]
        obm0 = ids_to_bitmap(np.asarray(kw0, np.int32).reshape(len(ids0), -1), ds.vocab_size)
        _build.reset_launch_counts()
        with patched(ops, sub_match=recorder("sub_match", ops.sub_match, 5)):
            mat = ops.match_subscriptions(locs0, obm0, blk.rects, blk.bm, blk.sig[:, 0])
            torch.cuda.synchronize()
        launches["sub_match"] = _build.launch_counts()["sub_match"]
        if launches["sub_match"] != 1:
            raise AssertionError("match_subscriptions did not launch sub_match once")
        pairs0 = ops.match_subscription_pairs(
            to_device(np.asarray(locs0, np.float32), dev), to_device(obm0, dev), blk.rects, blk.bm,
            blk.sig[:, 0])
        if not torch.equal(canon(pairs0, blk.n_slots), torch.nonzero(mat).to(torch.int32)):
            raise AssertionError("the pairs differ from the match matrix's nonzero entries")
        log(f"match_subscriptions (the matrix instance) on arrival batch 0 against the final "
            f"block: one launch, {int(mat.sum())} matches, equal to the pairs instance's")
        del dlog, blk, mat, pairs0

    # -------------------------------------------------------- the CDF bank
    with phase("CDF bank"):
        kw_counts = np.bincount(ds.kw_ids[ds.kw_ids >= 0], minlength=ds.vocab_size)
        n_high = int(((kw_counts / ds.n >= CDF_HIGH_FRAC) & (kw_counts >= 4)).sum())
        gen = torch.Generator().manual_seed(SEED)
        x_all = torch.from_numpy(np.ascontiguousarray(ds.locs[:, 0])).to(dev)
        cdf_args = cdf_bank(dev, 2 * n_high, CDF_HIDDEN, gen, x=x_all)
        _build.reset_launch_counts()
        t = time.perf_counter()
        cdf_out = ops.cdf_bank_forward(*cdf_args)
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        launches["cdf_mlp_bank"] = _build.launch_counts()["cdf_mlp_bank"]
        if launches["cdf_mlp_bank"] != 1:
            raise AssertionError("cdf_bank_forward did not launch cdf_mlp_bank once")
        err = max_abs_err(cdf_out, ref.cdf_mlp_ref(*cdf_args))
        if not err <= CDF_ATOL or not torch.isfinite(cdf_out).all():
            raise AssertionError(f"the CDF bank is off its plain version by {err}")
        captured["cdf_mlp_bank"] = cdf_args
        log(f"CDF bank: {n_high} keywords on at least {100 * CDF_HIGH_FRAC} % of the objects, "
            f"B={2 * n_high} MLPs of H={CDF_HIDDEN} at N={ds.n} points: {t:.6f} s, output "
            f"{tuple(cdf_out.shape)}, max abs err vs the chunked plain version {err:.3e} "
            f"(atol {CDF_ATOL})")
        del cdf_out
        # the edges: CDF_EDGE_X over objects' x coordinates, banks of B off
        # the kernel's 8-model tile, H = 32 and H = 4; a NaN point is NaN in
        # every column, and no finite one anywhere
        for B, H, n in ((2 * n_high + 1, 32, 100_000), (13, 4, 4099)):
            edge_args = cdf_bank(dev, B, H, gen, x=x_all[:n], edges=True)
            got = ops.cdf_bank_forward(*edge_args)
            torch.cuda.synchronize()
            plain = ref.cdf_mlp_ref(*edge_args)
            x_e = edge_args[1]
            assert_same(got, plain, f"the CDF bank at edge points, B={B} H={H}", CDF_ATOL)
            if not torch.isnan(got[torch.isnan(x_e)]).all() or torch.isnan(
                    got[torch.isfinite(x_e)]).any():
                raise AssertionError(f"the CDF bank's NaNs at B={B} H={H} are not the points'")
            log(f"CDF bank at B={B} H={H}, N={n} objects' x with {len(CDF_EDGE_X)} edge points "
                f"(NaN, +-inf, +-0, far): within atol {CDF_ATOL} of the plain version, max abs "
                f"err {max_abs_err(got, plain):.3e}, NaN where it is NaN")
        del got, plain, edge_args

    # ------------------------------------------------------- kernel phases
    rows = []
    csrc = "src/repro_torch/kernels/csrc/"
    # rows 2 and 3: the remapping instances at the main path's operands,
    # checked with words=False (as the engine runs them; the row's time) and
    # words=True; ragged: Wl of 1, 2 and 8, W of 1 and 3, OBJ of 1 and 37,
    # dirty leaf ids, leaf_ok = 0 rows, a query that meets no dictionary,
    # entries past 32*W, all -1 dictionaries
    fu_args = captured["fused"]
    fu_cases = [fu_args + (False,), fu_args + (True,)]
    remap_ragged = [ragged_fused(dev, W=3), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, W=1,
                                                          seed=3),
                    ragged_fused(dev, M=9, T=4, K=6, OBJ=1, Wl=8, W=1, seed=4),
                    ragged_fused(dev, M=7, T=3, K=5, OBJ=37, Wl=8, W=3, seed=5),
                    ragged_fused(dev, M=6, T=6, K=4, OBJ=16, Wl=1, W=3, seed=6)]
    fused_ragged = [ragged_fused(dev), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, seed=3)]

    def remap_entry(variant):
        return lambda *a: ops.fused_verify_leaf_words(*a[:10], variant=variant, words=a[10])

    def remap_plain(*a):
        return ref.fused_verify_leaf_words_ref(*a[:10], words=a[10])

    remap_bound = lambda a: fused_remap_bound(a, ref.remap_query_words_ref)  # noqa: E731

    def slot_phase(name, replaces, cases, kernel, plain, narrow):
        # dirty ids, a padding row, a query with no nonzero word and one
        # whose rectangle meets nothing, sizes off every block; N = W = 1
        # (with one-entry dictionaries); W = 64 with sparse queries; W past
        # one compaction round with terms on both sides of its edge; an
        # all-padding frontier
        d = lambda n: n if narrow else None  # noqa: E731
        ragged = [ragged_frontier_level(dev, ops, D=d(61)),
                  ragged_frontier_level(dev, ops, M=1, F=1, N=1, W=1, D=d(1), seed=32),
                  ragged_frontier_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True,
                                        D=d(150), seed=33),
                  ragged_frontier_level(dev, ops, M=5, F=40, N=30, W=2100, D=d(40), seed=34)]
        pad = ragged[0]
        ragged.append(pad[:4] + (torch.full_like(pad[4], -1),) + pad[5:])
        return (name, csrc + "frontier.cu", replaces, cases, ragged, kernel, plain,
                lambda a: slot_bound(a, narrow))

    # the full-width fused verify's operands end with the packed query words
    wide_ragged = [ragged_fused_wide(dev, ops), ragged_fused_wide(dev, ops, W=1, seed=8),
                   ragged_fused_wide(dev, ops, M=9, T=7, K=13, OBJ=45, W=40, sparse=True,
                                     seed=9)]
    # rows 7 and 8 also at NaN and infinite query points (NONFINITE_POINTS),
    # and at one NaN point alone
    level_ragged = [ragged_level(dev, ops), ragged_level(dev, ops, M=1, F=1, N=1, W=1, seed=20),
                    ragged_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True, seed=21),
                    ragged_level(dev, ops, seed=25, nonfinite=True),
                    ragged_level(dev, ops, M=1, F=3, N=2, W=1, seed=29, nonfinite=True)]
    # the narrow level's: Wp = W with dirty ids, a padding row and a query
    # with no nonzero word; N = 1 with one-entry dictionaries; Wp below W;
    # non-finite points; an all-padding frontier
    narrow_ragged = [ragged_level(dev, ops, D=61, seed=22),
                     ragged_level(dev, ops, M=1, F=1, N=1, W=1, D=1, seed=23),
                     ragged_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True, D=150, seed=24),
                     ragged_level(dev, ops, D=61, seed=27, nonfinite=True),
                     ragged_level(dev, ops, M=1, F=3, N=2, W=1, D=2, seed=28, nonfinite=True)]
    pad = narrow_ragged[0]
    narrow_ragged.append(pad[:5] + (torch.full_like(pad[5], -1),) + pad[6:])

    def slot_verify_phase(name, replaces, kernel, plain, compact):
        # the insert slots of a delta SKR batch; ragged: dirty leaf ids,
        # leaf_ok = 0 rows, a query with no nonzero word and a NEVER_RECT
        # one, points on edges; B = 1; W = 1; W past one compaction round;
        # every slot empty
        ragged = [ragged_slot_bank(dev, ops, compact),
                  ragged_slot_bank(dev, ops, compact, M=7, T=3, K=5, B=1, W=2, seed=42),
                  ragged_slot_bank(dev, ops, compact, W=1, B=16, seed=43),
                  ragged_slot_bank(dev, ops, compact, M=5, T=3, K=9, B=16, W=2100, seed=44),
                  ragged_slot_bank(dev, ops, compact, seed=45, empty=True)]
        return (name, csrc + "skr_verify.cu", replaces, [captured[f"{name}/delta"]], ragged,
                kernel, plain, lambda a: slot_verify_bound(a, compact))

    phases = [
        slot_phase("frontier_level_narrow", "src/repro/kernels/frontier.py:113",
                   [captured["frontier_level_narrow"]], ops.frontier_level_narrow,
                   ref.frontier_level_narrow_ref, True),
        ("fused_verify_remap_tile", csrc + "fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:267", fu_cases, remap_ragged, remap_entry("vmem"),
         remap_plain, remap_bound),
        ("fused_verify_remap_slot", csrc + "fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:345", fu_cases, remap_ragged, remap_entry("prefetch"),
         remap_plain, remap_bound),
        slot_phase("frontier_level", "src/repro/kernels/frontier.py:60",
                   [captured["frontier_level/log B"], captured["frontier_level/f32"],
                    captured["frontier_level/log A"]],
                   ops.frontier_level, ref.frontier_level_ref, False),
        ("knn_level_dist_narrow", csrc + "knn_filter.cu", "src/repro/kernels/knn_filter.py:105",
         [captured["knn_level_dist_narrow"]], narrow_ragged, ops.knn_level_dist_narrow,
         ref.knn_level_dist_narrow_ref, lambda a: level_bound(a, narrow=True)),
        ("knn_level_dist", csrc + "knn_filter.cu", "src/repro/kernels/knn_filter.py:54",
         [captured["knn_level_dist"]], level_ragged, ops.knn_level_dist, ref.knn_level_dist_ref,
         level_bound),
        ("fused_verify_tile", csrc + "fused_verify.cu", "src/repro/kernels/fused_verify.py:107",
         [captured["fused_wide"]], wide_ragged,
         lambda *a: ops.fused_gather_verify(*a[:8], variant="vmem", q_words=a[8]),
         lambda *a: ref.fused_verify_packed_ref(a[0], *a[8], *a[2:8]),
         lambda a: fused_wide_bound(a[:8])),
        ("fused_verify_slot", csrc + "fused_verify.cu", "src/repro/kernels/fused_verify.py:176",
         [captured["fused_wide"]], wide_ragged,
         lambda *a: ops.fused_gather_verify(*a[:8], variant="prefetch"),
         lambda *a: ref.fused_verify_ref(*a[:8]), lambda a: fused_wide_bound(a[:8])),
        slot_verify_phase("skr_verify_slots_compact", "src/repro/kernels/skr_verify.py:94",
                          ops.verify_slots_compact, ref.skr_verify_slots_compact_ref, True),
        slot_verify_phase("skr_verify_slots", "src/repro/kernels/skr_verify.py:39",
                          ops.verify_slots, ref.skr_verify_slots_ref, False),
        # row 11: the stream's pairs instance (the row's time), then the
        # matrix instance; ragged: W of 1, 3 and 40, S = 1, matches decided
        # past the words the pairs instance stages, sizes off every block
        ("sub_match_pairs", csrc + "sub_match.cu", "src/repro/kernels/sub_match.py:67",
         [captured["sub_match_pairs"]],
         [ragged_sub(dev, ops, pairs=True), ragged_sub(dev, ops, N=1, S=1, W=1, seed=18, pairs=True),
          ragged_sub(dev, ops, N=70, S=300, W=40, seed=19, pairs=True, late=True),
          ragged_sub(dev, ops, N=1000, S=4099, W=256, seed=20, pairs=True)],
         lambda *a: canon(ops.match_subscription_pairs(*a), a[2].shape[0]),
         lambda *a: canon(plain_pairs(*a), a[2].shape[0]), sub_bound),
        ("sub_match", csrc + "sub_match.cu", "src/repro/kernels/sub_match.py:67",
         [captured["sub_match"]],
         [ragged_sub(dev, ops), ragged_sub(dev, ops, N=1, S=1, W=1, seed=18),
          ragged_sub(dev, ops, N=1000, S=4099, W=256, seed=20)],
         ops.sub_match, ref.sub_match_packed_ref, sub_bound),
        # row 12: the leaf level (the row's time), then the dense batch's
        # four upper levels; ragged: node runs and strips cut short, rows
        # not 16-byte aligned (K = 7833), W of 1, 3 and 2,100 (past a
        # compaction round, sparse and dense)
        ("skr_filter", csrc + "skr_filter.cu", "src/repro/kernels/skr_filter.py:44",
         [captured["skr_filter"], *dense_levels[:-1]],
         [ragged_filter(dev, ops.NEVER_RECT), ragged_filter(dev, ops.NEVER_RECT, M=1, K=1, W=1,
                                                             seed=14),
          ragged_filter(dev, ops.NEVER_RECT, M=17, K=15, seed=15),
          ragged_filter(dev, ops.NEVER_RECT, M=5, K=7833, seed=16),
          ragged_filter(dev, ops.NEVER_RECT, M=6, K=17, W=2100, seed=17, sparse=True),
          ragged_filter(dev, ops.NEVER_RECT, M=4, K=40, W=2100, seed=18)],
         ops.filter_pairs, ref.skr_filter_ref, filter_bound),
        ("cdf_mlp_bank", csrc + "cdf_mlp.cu", "src/repro/kernels/cdf_mlp.py:42",
         [captured["cdf_mlp_bank"]],
         [cdf_bank(dev, 5, CDF_HIDDEN, gen), cdf_bank(dev, 3, 8, gen, N=4099),
          cdf_bank(dev, 1, 4, gen, N=1), cdf_bank(dev, 9, 32, gen, N=2081, edges=True),
          cdf_bank(dev, 7, CDF_HIDDEN, gen, N=97, edges=True),
          cdf_bank(dev, 196, 8, gen, N=5000, edges=True)],
         ops.cdf_bank_forward, ref.cdf_mlp_ref, cdf_bound),
    ]
    atols = {"cdf_mlp_bank": CDF_ATOL}  # every other kernel is held bit for bit
    # timed as one launch at the default capacity, without the count
    # readback and the canonical sort the checked entry adds
    timed = {"sub_match_pairs": (
        lambda *a: ops._sub_pairs(*a, ops.SUB_PAIRS_CAPACITY),
        lambda *a: ref.sub_match_pairs_ref(*a, ops.SUB_PAIRS_CAPACITY))}
    launches.update(knob_launches)
    launches.update(delta_launches)
    with phase("kernel phases"):
        # the first captured case is the row's; later ones (more paths'
        # shapes) are checked and timed the same way and logged
        for name, source, replaces, cases, ragged, kernel, plain, bound in phases:
            atol = atols.get(name, 0.0)
            for case in [*cases, *ragged]:
                got = kernel(*case)
                torch.cuda.synchronize()
                assert_same(got, plain(*case), f"{name} at {shapes(case)[:5]}", atol)
            for ci, args in enumerate(cases):
                err = max_abs_err(kernel(*args), plain(*args))
                torch.cuda.synchronize()
                run, run_plain = timed.get(name, (kernel, plain))
                ms, note = kernel_ms(lambda: run(*args))
                plain_ms = time_ms(lambda: run_plain(*args), iters=10)
                nbytes, nops = bound(args)
                b_ms, b_by = bound_ms(nbytes, nops)
                agree = "bit-exact" if atol == 0 else f"within atol {atol} (max {err:.3e})"
                log(f"phase {name}: {agree} vs plain at main-path shapes {shapes(args)} and "
                    f"{len(ragged)} ragged cases; kernel {note}, plain {plain_ms:.6f} ms, bound "
                    f"{b_ms:.6f} ms ({b_by}: {nbytes} B, {nops} ops)")
                if ci == 0:
                    rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                                     launches=launches[name], max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=None))

    with phase("the other entries of the redesigned kernels"):
        # the gather the f32 kNN descent no longer makes: the (M, F, W) word
        # plane at the captured leaf frontier, as the one indexing op it was
        q_pts, wids, bits, mbrs, lbms, fr = captured["knn_level_dist"]
        safe = fr.clamp(0, lbms.shape[0] - 1).long()
        gather_ms = time_ms(lambda: lbms[safe], iters=10)
        log(f"the removed gather level_bms[safe] at {tuple(fr.shape)} x W={lbms.shape[1]} "
            f"({fr.numel() * lbms.shape[1] * 4} B): {gather_ms:.6f} ms")
        del safe
        # knn_frontier_dist's gathered operands run the same kernel: bit-exact
        # against knn_filter_ref at ragged shapes and at the first 64 captured
        # queries, where it also equals knn_level_dist's rows
        m = min(64, fr.shape[0])
        sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
        q_head = torch.zeros((m, lbms.shape[1]), dtype=torch.int32, device=dev).scatter_(
            1, wids[:m].long(), bits[:m])  # every word of the first m queries
        head = (q_pts[:m].contiguous(), q_head, mbrs[sl], lbms[sl], (fr[:m] >= 0).to(torch.int8))
        gathered = [ragged_slots(dev, False, True),
                    ragged_slots(dev, False, True, M=1, F=1, W=1, D=2, seed=9), head]
        for case in gathered:
            got = ops.knn_frontier_dist(*case)
            torch.cuda.synchronize()
            assert_same(got, ref.knn_filter_ref(*case), f"knn_frontier_dist at {shapes(case)}")
        assert_same(got, ops.knn_level_dist(q_pts[:m].contiguous(), wids[:m].contiguous(),
                                            bits[:m].contiguous(), mbrs, lbms,
                                            fr[:m].contiguous()), "knn_frontier_dist vs level")
        del head, gathered, sl, got
        # knn_frontier_dist_narrow's gathered planes run knn_level_dist_narrow's
        # kernel: bit-exact against knn_filter_narrow_ref at ragged shapes and
        # at the first 64 captured queries, where it also equals the level rows
        q_pts, wids, bits, codes, lbms, fr, dict_x, dict_y = captured["knn_level_dist_narrow"]
        m = min(64, fr.shape[0])
        sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
        head = (q_pts[:m].contiguous(), bits[:m].contiguous(), codes[sl],
                lbms[sl[:, :, None], wids[:m].long()[:, None, :]], (fr[:m] >= 0).to(torch.int8),
                dict_x, dict_y)
        gathered = [ragged_slots(dev, True, True),
                    ragged_slots(dev, True, True, M=1, F=1, W=1, D=2, seed=9), head]
        for case in gathered:
            got = ops.knn_frontier_dist_narrow(*case)
            torch.cuda.synchronize()
            assert_same(got, ref.knn_filter_narrow_ref(*case),
                        f"knn_frontier_dist_narrow at {shapes(case)}")
        assert_same(got, ops.knn_level_dist_narrow(
            q_pts[:m].contiguous(), wids[:m].contiguous(), bits[:m].contiguous(), codes, lbms,
            fr[:m].contiguous(), dict_x, dict_y), "knn_frontier_dist_narrow vs level")
        del head, gathered, sl, got
        # the tile launch without packed words takes all W words, ids arange(W)
        for case in [captured["fused_wide"], *wide_ragged]:
            got = ops.fused_gather_verify(*case[:8], variant="vmem")
            torch.cuda.synchronize()
            assert_same(got, ref.fused_verify_ref(*case[:8]),
                        f"fused_verify_tile on q_bm at {shapes(case[:8])}")
        # filter_frontier(_narrow)'s gathered planes run the frontier level
        # kernels: bit-exact against frontier_filter(_narrow)_ref at ragged
        # shapes and at the first 64 captured queries, where they also equal
        # the level rows
        for key, narrow in (("frontier_level/log B", False), ("frontier_level_narrow", True)):
            level = captured[key]
            q_rects, q_bm, mbr, lbms, fr = level[:5]
            m = min(64, fr.shape[0])
            sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
            valid = (fr[:m] >= 0).to(torch.int8)
            if narrow:
                wids, bits = ops.pack_query_words(ops.host_words(q_bm[:m]))
                wids, bits = torch.from_numpy(wids).to(dev), torch.from_numpy(bits.view(np.int32)).to(dev)
                head = (q_rects[:m].contiguous(), bits, mbr[sl],
                        lbms[sl[:, :, None], wids.long()[:, None, :]], valid, *level[5:])
                wrapper, plain = ops.filter_frontier_narrow, ref.frontier_filter_narrow_ref
            else:
                head = (q_rects[:m].contiguous(), q_bm[:m].contiguous(), mbr[sl], lbms[sl], valid)
                wrapper, plain = ops.filter_frontier, ref.frontier_filter_ref
            gathered = [ragged_slots(dev, narrow, False),
                        ragged_slots(dev, narrow, False, M=1, F=1, W=1, D=2, seed=9), head]
            for case in gathered:
                got = wrapper(*case)
                torch.cuda.synchronize()
                assert_same(got, plain(*case), f"{wrapper.__name__} at {shapes(case)}")
            rows_m = (q_rects[:m].contiguous(), q_bm[:m].contiguous(), mbr, lbms,
                      fr[:m].contiguous(), *level[5:])
            level_fn = ops.frontier_level_narrow if narrow else ops.frontier_level
            assert_same(got, level_fn(*rows_m), f"{wrapper.__name__} vs level")
            del head, gathered, sl, got
        # the given-words instances of rows 2 and 3 (fused_gather_verify_compact,
        # on the words remap_query_words gives) at the main path's remapped
        # words and at ragged ones: bit-exact, and timed beside fused_bound
        q_cbm, q_sig = ref.remap_query_words_ref(*fu_args[1:4])
        given = (fu_args[0], q_cbm, q_sig, *fu_args[3:])
        for variant, name in (("vmem", "fused_verify_compact_tile"),
                              ("prefetch", "fused_verify_compact_slot")):
            entry = lambda *a, variant=variant: ops.fused_gather_verify_compact(  # noqa: E731
                *a, variant=variant)
            for case in [given, *fused_ragged]:
                got = entry(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_fused(*case), f"{name} at {shapes(case)[:5]}")
            ms = time_ms(lambda: entry(*given))
            b_ms, b_by = bound_ms(*fused_bound(given))
            log(f"{name} (given words) at the main path's remapped words {shapes(given)[:5]}: "
                f"bit-exact vs plain, and at {len(fused_ragged)} ragged cases; kernel {ms:.6f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})")
        del given, q_cbm, q_sig, got
        log("knn_frontier_dist, knn_frontier_dist_narrow, filter_frontier and "
            "filter_frontier_narrow (gathered operands, through the level kernels) and the "
            "query-tile verify on q_bm: bit-exact against their plain versions at the captured "
            "and ragged shapes")
        # the gathered entries of rows 9 and 10 run the slot kernels over an
        # identity leaf map: the counted ones (the unfused knob's verify)
        # bit-exact in ids, n_match and n_kw against their plain versions at
        # the knob shapes and ragged ones, timed at the knob shapes; the int8
        # ones against skr_verify(_compact)_ref at ragged shapes
        for compact, counted, flags, plain_flags in (
                (True, ops.verify_candidates_compact_counted, ops.verify_candidates_compact,
                 ref.skr_verify_compact_ref),
                (False, ops.verify_candidates_counted, ops.verify_candidates,
                 ref.skr_verify_ref)):
            key = "skr_verify_compact" if compact else "skr_verify"

            def plain_counted(*a, compact=compact):
                M = a[0].shape[0]
                T = a[2].shape[1] if compact else 1
                leaves = ops.identity_leaves(M, T, dev)
                if not compact:
                    return ref.skr_verify_slots_ref(a[0], a[1], *leaves, *a[2:])
                bank = lambda t: t.reshape(M * T, -1, *t.shape[2:])  # noqa: E731
                return ref.skr_verify_slots_compact_ref(*a[:3], *leaves,
                                                        *(bank(t) for t in a[3:]))

            ragged = [ragged_verify(dev, compact), ragged_verify(dev, compact, W=1, seed=12)]
            as_ids = lambda a: a[:-1] + ((a[-1] > 0).to(torch.int32) * 7 - 1,)  # noqa: E731
            knob = captured[f"{key}/knob"]
            for case in [knob, *map(as_ids, ragged)]:
                got = counted(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_counted(*case), f"{key} counted at {shapes(case)[:5]}")
            for case in ragged:
                got = flags(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_flags(*case), f"{key} at {shapes(case)[:5]}")
            ms = time_ms(lambda: counted(*knob))
            plain_ms = time_ms(lambda: plain_counted(*knob), iters=10)
            b_ms, b_by = bound_ms(*verify_bound(knob, compact))
            log(f"{key} (gathered, counted) at the knob shapes {shapes(knob)[:6]}: bit-exact in "
                f"ids, n_match and n_kw vs plain, and at {len(ragged)} ragged cases; the int8 "
                f"entry bit-exact at them; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
                f"{b_ms:.6f} ms ({b_by})")

        # the pairs instance at capacity 0 and 1 at the stream's captured
        # operands: one more launch, at the exact count, and the same pairs
        pa = captured["sub_match_pairs"]
        want = canon(ops.match_subscription_pairs(*pa), pa[2].shape[0])
        for cap in (0, 1):
            before = _build.KERNELS["sub_match_pairs"].launches
            got = canon(ops.match_subscription_pairs(*pa, capacity=cap), pa[2].shape[0])
            torch.cuda.synchronize()
            extra = _build.KERNELS["sub_match_pairs"].launches - before - 1
            if extra != int(want.shape[0] > cap) or not torch.equal(got, want):
                raise AssertionError(f"sub_match_pairs at capacity {cap}: {extra} retries, or "
                                     f"other pairs")
        log(f"sub_match_pairs at capacity 0 and 1 at the stream's operands: one retry each at the "
            f"exact count ({want.shape[0]} pairs), the same pairs as at the default capacity")
        del pa, want, got

    with phase("operand gathers"):
        # the per-slot planes the engine gathered before rows 1, 4 and 7
        # read the level themselves, timed at the captured shapes as the
        # indexing ops that made them: row 1's codes and node words at the
        # packed word ids (the narrow SKR descent), row 4's f32 MBRs and all
        # W words (log B's delta SKR batch), row 7's codes and node words
        # (the narrow kNN descent); and the host packing the SKR batch no
        # longer makes
        def narrow_planes(codes, lbms, fr, wids):
            safe = fr.clamp(0, lbms.shape[0] - 1).long()
            return codes[safe], lbms[safe[:, :, None], wids.long()[:, None, :]]

        def wide_planes(mbrs, lbms, fr):
            safe = fr.clamp(0, lbms.shape[0] - 1).long()
            return mbrs[safe], lbms[safe]

        q_rects, q_bm, codes1, lbms1, fr1 = captured["frontier_level_narrow"][:5]
        host_bm = ops.host_words(q_bm)
        t = time.perf_counter()
        for _ in range(5):
            wids1, _ = ops.pack_query_words(host_bm)
        pack_ms = (time.perf_counter() - t) * 1e3 / 5
        wids1 = torch.from_numpy(wids1).to(dev)
        _, _, mbrs4, lbms4, fr4 = captured["frontier_level/log B"]
        _, wids7, _, codes7, lbms7, fr7 = captured["knn_level_dist_narrow"][:6]
        gathers = {
            "frontier_level_narrow (row 1)": lambda: narrow_planes(codes1, lbms1, fr1, wids1),
            "frontier_level (row 4)": lambda: wide_planes(mbrs4, lbms4, fr4),
            "knn_level_dist_narrow (row 7)": lambda: narrow_planes(codes7, lbms7, fr7, wids7),
        }
        # rows 9 and 10: the insert-slot planes _verify_delta_slots gathered
        # at logs A's and B's delta SKR batches (coordinates, ids, the int8
        # validity plane and the slot words), and the keyword recount over
        # them (_kw_compact, _kw_full) that gave Eq. 1's verified
        def slot_planes(args, compact):
            top_leaf, leaf_ok, x, y = args[3:7] if compact else args[2:6]
            M, B = top_leaf.shape[0], x.shape[1]
            tl = top_leaf.long()
            iid = args[-1][tl].reshape(M, -1)
            ival = ((iid >= 0) & (leaf_ok > 0).repeat_interleave(B, dim=1)).to(torch.int8)
            planes = [x[tl].reshape(M, -1), y[tl].reshape(M, -1), iid, ival]
            words = args[7] if compact else args[6]
            planes.append(words[tl].reshape(M, -1, words.shape[2]))
            if compact:
                planes.append(args[8][tl].reshape(M, -1))
            return planes

        def recount(args, planes, compact):
            B = args[-1].shape[1]
            if compact:
                q_cbm, q_sig = args[1], args[2]
                kw = (((planes[5] & q_sig.repeat_interleave(B, dim=1)) != 0)
                      & ((planes[4] & q_cbm.repeat_interleave(B, dim=1)) != 0).any(dim=-1))
            else:
                kw = ((planes[4] & args[1][:, None, :]) != 0).any(dim=-1)
            return (kw & (planes[3] > 0)).to(torch.int32).sum(dim=1, dtype=torch.int32)

        for row, key, compact in (("skr_verify_slots_compact (row 9)",
                                   "skr_verify_slots_compact/delta", True),
                                  ("skr_verify_slots (row 10)", "skr_verify_slots/delta", False)):
            args = captured[key]
            gathers[row] = lambda args=args, compact=compact: slot_planes(args, compact)
            planes = slot_planes(args, compact)
            r_ms = time_ms(lambda: recount(args, planes, compact), iters=10)
            log(f"keyword recount no longer made for {row}: over the planes "
                f"{[tuple(p.shape) for p in planes[3:]]}: {r_ms:.6f} ms")
            del planes
        for row, gather in gathers.items():
            planes = gather()
            nbytes = sum(p.numel() * p.element_size() for p in planes)
            g_ms = time_ms(gather, iters=10)
            log(f"operand gather no longer made for {row}: planes "
                f"{[tuple(p.shape) for p in planes]} ({nbytes} B): {g_ms:.6f} ms")
        log(f"host packing no longer made for the SKR batch: pack_query_words of "
            f"{tuple(host_bm.shape)} words, host clock, mean of 5: {pack_ms:.6f} ms")
        # the per-slot query words rows 2 and 3 took before their kernels
        # remapped them: remap_query_words at the main path's (M, T) slots
        remap = fu_args[1:4]
        remap_ms = time_ms(lambda: ops.remap_query_words(*remap), iters=10)
        log(f"operand build no longer made for rows 2-3: remap_query_words of q_bm "
            f"{tuple(remap[0].shape)} into the leaf dictionaries {tuple(remap[1].shape)} at "
            f"the (M, T) = {tuple(remap[2].shape)} slots: {remap_ms:.6f} ms")
        del planes, gathers
        # what the subscription stream no longer makes: the host packing of
        # an arrival batch's words (pack_query_words and the OR-fold) and
        # torch.nonzero over the (N, S) match matrix with the copy of its
        # indices, host clock, mean of 5
        host_obm = ops.host_words(captured["sub_match_pairs"][1])
        t = time.perf_counter()
        for _ in range(5):
            ops.pack_query_words(host_obm)
            np.bitwise_or.reduce(host_obm, axis=1)
        sub_pack_ms = (time.perf_counter() - t) * 1e3 / 5
        mat = ops.sub_match(*captured["sub_match"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            [x.cpu() for x in torch.nonzero(mat, as_tuple=True)]
        nonzero_ms = (time.perf_counter() - t) * 1e3 / 5
        log(f"subscription match steps no longer made: host packing of {tuple(host_obm.shape)} "
            f"arrival words {sub_pack_ms:.6f} ms; torch.nonzero over the {tuple(mat.shape)} match "
            f"matrix and the copy of its {int(mat.sum())} index pairs {nonzero_ms:.6f} ms")
        del mat
    captured.clear()

    with phase("profiles"):
        profile_batch("SKR", lambda cache: serve_batch(
            snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cache), warm, PlanCache)
        profile_batch("dense SKR", lambda cache: serve_batch(
            snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense"), warm, PlanCache)
        for label in ("B", "A"):
            serve = lambda cache, label=label: serve_batch(  # noqa: E731
                snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cache,
                delta=delta_bufs[label])
            profile_batch(f"SKR with log {label}'s delta", serve, delta_caches[label], PlanCache)

    # --------------------------------------------------------- construction
    with phase("construction"):
        art, train, twin = construction(dev, ds, wl, batches, main_out)
    gc.collect()  # the construction phase's snapshots and twin builds
    torch.cuda.empty_cache()

    with phase("live front door"):
        live_front_door(dev, ds, train, art)
    del art
    gc.collect()
    torch.cuda.empty_cache()

    with phase("multi-rank serving"):
        multi_rank_serving(dev, wl, points, batches, snap, warm, main_out, warm_knn, knn_out,
                           delta_bufs["B"], delta_skr["B"][0], delta_knn["B"], twin)

    with phase("LM serving"):
        lm_serving(dev, card, ds, index, snap, wl)

    with phase("LM training"):
        lm_training(dev, card)

    with phase("MoE and MLA families"):
        moe_families(dev, card)

    with phase("enc-dec and xLSTM families"):
        seq_families(dev, card)

    with phase("hybrid family"):
        hybrid_family(dev, card)

    with phase("LMs over ranks and the dry run"):
        lms_over_ranks(dev, card)

    log(f"card: {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
