"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. setup: the card's name and power limit, the torch and CUDA versions, the
   kernels' build times (one nvcc per source, all started together, from
   the sources in this checkout) and ptxas' registers and spills; then
   ``cuobjdump -sass`` of the flash_attention, flash_attention_bwd,
   bsr_spmm, ssd_chunk and ssd_chunk_bwd libraries, which fails unless
   each wgmma kernel holds HGMMA and UTMALDG and both attention libraries
   and the SSD backward's hold each of their wgmma kernels (ptxas'
   registers and spills of each printed, and any warning, C7512 among
   them);
2. segreduce vs plain: the segmented-reduce kernel against its plain
   PyTorch version on the card. The atomic route over tags, dtypes, id
   orders, sizes and vector values; the sorted route (``sorted_ids=True``)
   over every dtype x tag, one segment of 2^20 elements, runs of exactly
   one tile and runs straddling 2, 3 and many tiles, an all-padding and an
   all-negative stream, S >> N with large gaps, S below the largest id, the
   merge engine's padding tail, the declared identities (MAX_INT with
   values below it, MIN_INT, inf, bool) and int64 ids beyond int32 on both
   sides, each case's ``route()`` printed and checked; two sorted f32 sums
   of one input bitwise equal; a descending stream sets the descent flag;
   times at N = S = 2^24 (f32 sum, sorted ids) of both routes beside the
   bound, the plain version and ``scatter_reduce_``;
2b. semiring_matmul vs plain: the dense-tile kernels against their plain
   version over the four algebras and their types, ragged shapes (a 128 x
   128 tile's four edges), NaN/inf, ties of +0 and -0, or_and's partial
   packed words; the SASS instruction mix of the redesigned kernels; times
   at 2048^3 beside the bound and torch.matmul;
3. tricount: masked triangle counting of an R-MAT graph (Graph500
   parameters, scale 15, edge factor 16, seed 0) through
   ``DistSpMat.from_global_coo`` -> ``triangle_count`` -> planner ->
   ``spgemm_2d`` on a 1x1 grid, held against scipy; its segreduce
   launches by route (all sorted), and each of its calls again (N, S, live
   ids) held against the plain version and timed (device time,
   torch.profiler) beside the bound of what the sorted route must move;
4. dense local SpGEMM: ``plan_local_spgemm`` -> ``spgemm_auto`` ->
   ``spgemm_dense`` on R-MAT scale 11, edge factor 64 (a 2048 x 2048 tile,
   the dense accumulator's largest) under four semirings, held against
   scipy, the port's ESC path and the plain oracle;
5. local SpMV/SpMSpV on phase 3's tile: ``spmv_row``/``spmv_col`` and
   ``plan_local_spmspv`` -> ``spmspv_auto`` at three frontier densities,
   held against scipy, with their segreduce launches by route;
6. flash_attention vs plain: the attention kernel against its plain version
   over causal and not, f32 and bf16, ragged S (130 and 2080 leave a ragged
   128-row tile), head dims 16-128, GQA and Skv beside S, MLA's d = 192
   with dv = 128 and hubert's d = 80 (both bf16 on the wgmma kernel), with
   each case's ``route()`` printed and checked (wgmma for every main-path
   shape, fma for f32 and d = 16), and times at phase 7's (4, 2048, 16,
   128) bf16 causal and at phases 23-25's shapes (``FLASH_PATHS``) beside
   the bound and ``F.scaled_dot_product_attention``;
7. serve: qwen2-moe-a2.7b at full width and depth (24 layers, bf16
   parameters from ``init_params(seed=0)``) through ``greedy_generate``:
   batch 4, a 2,048-token prompt, 32 greedy tokens; cold and warm prefill,
   decode wall per token, peak memory, kernel launches per forward, a
   profile of one prefill and one decode step, and a teacher-forced forward
   against the decode-step logits, with the config's capacity and with one
   that drops no token;
6b. bsr_spmm vs plain (after phases 7 and 23, whose operands it takes):
   the blocked-ELL kernel against its plain version on layer 0's ``we_g``
   and ``we_2`` products of each one's prefill (C = 640 and 960 rows an
   expert) and ``we_g`` of its first decode step, and on random
   blocked-ELL operands (K up to 4, ids past the last block, rows of
   padding alone, bk = 48, C = 960), with times at the six shapes beside
   the bound and ``torch.bmm``;
6c. the flash_attention backward kernel (``csrc/flash_attention_bwd.cu``)
   against its plain backward on the same (q, k, v, o, lse, dO), and the
   forward kernel's lse against the plain version's: causal and not, f32
   and bf16, ragged S (130, 2080), Skv beside S (bottom right, rows that
   see no key), GQA groups of 1, 2, 4 and 8, d = dv in 16, 64, 128, d =
   80, d = 192 with dv = 128, each case's ``backward_route()`` printed and
   checked (wgmma for bf16 d == dv in 64..128, phase 26's shape included);
   at phase 26's (2, 4096, 16, 128) bf16 causal the backward's time beside
   its bound, the plain backward and SDPA's backward, and the forward with
   and without lse;
6d. bsr_spmm's gradients (two products on its kernel, through the
   autograd Function) against its plain backward at phase 26's ``we_g`` and
   ``we_2`` shapes (C = 640) and on random blocked-ELL operands (K up to 4,
   repeated ids, ids past the last block, padding rows, column blocks no
   block names); times at ``we_g``'s shape beside the bound and
   ``torch.bmm``'s two gradient products;
7b. kernels against plain versions end to end: qwen2-moe-a2.7b cut to 2
   layers (every width kept) in f32, ``greedy_generate`` on the CPU (plain
   versions) and on the card (kernels) from the same parameters (made on
   the card, copied to the host); then, on the card with a capacity that
   drops no token, the decode-step logits against a teacher-forced
   forward;
23. serve: deepseek-v2-lite-16b (MLA) at full width and depth (27 layers,
   16.2 B bf16 parameters) through ``greedy_generate`` with phase 7's
   traffic: cold and warm prefill, decode per token, peak memory, launches
   per forward by kernel (flash_attention at d = 192, dv = 128; bsr_spmm
   at C = 960), the cold run's first attention call held against the
   plain version, the MLA cache's bytes beside a cache of the same heads'
   k and v, a teacher-forced forward against the decode-step logits, a
   profile of one prefill and one decode step; 23b: the 2-layer f32 cut,
   as 7b;
24. serve: qwen2-vl-7b at full width and depth (28 layers) with an image:
   batch 4, a 2,048-token prompt whose first 512 positions are a 16 x 32
   grid of patches (``vision_embeds`` from ``default_rng(0)``), pos3 with
   t = 0 and (h, w) on the grid for the image and t = h = w = the position
   for the text; the prefill through ``Model.forward(batch, caches=...)``,
   then 32 text decode steps through ``make_serve_step``; the figures of
   phase 23. 24b: the 2-layer f32 cut with a 64-token prompt after the
   512 patches, card against CPU, then the decode logits against a
   teacher-forced forward;
25. encode: hubert-xlarge at full width and depth (48 layers) over 8 clips
   of 1,500 frames (30 s at 50 frames/s) through ``Model.forward``: cold
   and warm wall, peak, flash_attention launches (d = 80, non-causal),
   the first attention call held, logits finite over the padded 512
   units, a profile; 25b: the 2-layer f32 cut over 2 clips, card against
   CPU. Each model is freed before the next;
8. ssd_chunk vs plain: the SSD intra-chunk kernels against their plain
   version at phase 9's prefill shape (G, q, H, P, N) = (64, 128, 80, 64,
   128) in bf16 (the tensor-core route) and f32 (the FMA route), the smoke
   widths, 40-, 77- and 256-token chunks, N of 8, 40 and 200, P of 72,
   with the model's dt and A (exp overflows above the diagonal), each
   case's route printed and checked; times at the main shape beside both
   routes' bounds;
8b. ssd_chunk's backward kernels (``csrc/ssd_chunk_bwd.cu``) against
   ``ssd_chunk_backward_plain`` on the same inputs and cotangents: the main
   shape with bf16 x/B/C and f32 dt/A (as training passes them: the wgmma
   route) and in f32 (the FMA route), the smoke widths (q 16, P 8, N 16), a
   40-token and a 256-token chunk, (2, 1, 3, 4, 5), the model-like overflow
   chunk on both routes, and the wgmma route's edges (q = 1, 64, 77, 100;
   N = 8, 32, 40, 72; a last group of one head); each case's
   ``backward_route()`` printed and checked (wgmma for every case in the
   forward's tensor-core domain, fma for the rest), every gradient finite
   and within 2^-10 of the sum of its terms' magnitudes, two calls bitwise
   equal; times of both routes at the main shape (each route's four
   launches by profiled device time) beside their bounds (the wgmma
   route's bytes, with its bf16 wgmma GFLOP at 989 TFLOP/s; the FMA
   route's float32 operations) and the plain backward;
9. serve: mamba2-2.7b at full width and depth (64 layers, bf16 parameters
   from ``init_params(seed=0)``) through ``greedy_generate`` with phase 7's
   traffic: cold and warm prefill, decode wall per token, peak memory,
   ``ssd_chunk`` launches per prefill (64) and per decode step (0), a
   profile of one prefill and one decode step, and a teacher-forced forward
   against the decode-step logits;
9b. mamba2-2.7b cut to 2 layers (every width kept) in f32: a 300-token
   prompt (three chunks, the last padded) through ``greedy_generate`` on
   the CPU (plain versions) and on the card (the kernel) from the same
   parameters; then the card's decode-step logits against a teacher-forced
   forward;
10. BFS (run after phase 5, with the graph phases): R-MAT at Graph500's
   parameters (a,b,c,d = 0.57/0.19/0.19/0.05, edge factor 16) at scale 20,
   seed 0, symmetrized without self loops, ``random_permute=True`` on the
   1x1 grid (about 2^20 vertices and 30 M stored entries); ``bfs_levels``
   from 4 roots of degree >= 1 drawn with ``default_rng(0)``, each root's
   levels bitwise equal to ``scipy.sparse.csgraph.shortest_path(...,
   unweighted=True)`` (unreachable -1); cold and warm wall, depth, the
   planner's variant per level, TEPS (the reached component's undirected
   edges over the warm wall), segreduce launches by route, peak memory and
   one profiled warm search;
11. PageRank on the same graph (alpha 0.85, tol 1e-8, at most 100
   iterations) within L1 1e-4 of a float64 scipy power iteration of the
   same formula run to convergence; iterations, cold and warm wall, wall an
   iteration, segreduce launches by route (1 atomic for the out-degrees, 1
   sorted an iteration), peak memory and one profiled run;
12. FastSV on the same graph: labels equal to each component's smallest
   vertex id (scipy's ``connected_components``; min-hooking from arange
   ends there), hooking iterations and pointer-jumping sweeps, cold and
   warm wall, wall an iteration, segreduce launches by route (1 sorted and
   2 atomic an iteration), peak memory and one profiled run;
13. maximal matching on the same matrix read as a bipartite graph (rows
   and columns two vertex sets), run to its fixed point: consistent, every
   pair an edge, maximal (no stored entry joins two unmatched vertices),
   its size beside scipy's ``maximum_bipartite_matching``; iterations,
   wall, segreduce launches by route, peak memory, a profile;
15. SpMM on the same matrix (run before 14): ``spmm_15d`` with X of 16 f32
   columns from ``default_rng(0)`` within the f32 summation bound of a
   float64 ``csr @ X`` (per row, gamma_(deg-1) |A||X|), ``spmm_2d``
   within it too and bitwise equal to ``spmm_15d`` under MAX_PLUS (their
   f32 sums differ in the last bits: atomic adds in any order); the
   segreduce route (atomic: vector values) and launches, ms a call beside
   the bytes bound, a profile;
14. HipMCL on a planted protein-family network (32,768 proteins, families
   of 32-64, vectorized numpy from ``default_rng(0)``) written as a LABEL
   file under build/ and read with ``read_generalized_tuples``:
   ``hipmcl`` with its defaults, the partition equal to a float64 scipy
   MCL of the same steps, purity against the planted families; per
   iteration the planner's caps, the iterate's nnz and the host round
   trip's time; the reader's time, wall, peak memory, segreduce launches
   by route (against the count its iterations and FastSV's imply), one
   profiled iteration.

16-19. the 2x2 grid (run last): four ranks, one process a grid position,
   spawned after the parent prints its reserved memory and empties its
   cache; ``nccl`` when there is a card a rank, else ``gloo`` (one card:
   NCCL refuses two ranks on one GPU, so a gather crosses through the
   card's memory, ``comm.CardMailbox``, and every other exchange is staged
   through pinned host memory), the backend printed. 16: phase 3's graph
   (written under build/grid/) on 2x2, the planner's pick and rotate with
   overlap on and off, alltoall and bcast, each giving scipy's and phase 3's
   triangles; rotate's C bitwise equal with overlap on and off; (c)
   ``spgemm_2d_batched`` of the masked product in 4 column batches, their
   sums adding to the triangles and their entries together bitwise equal
   to the unbatched C; (d) ``compress='int8'`` on MCL's first expansion
   P.P (phase 3's graph with unit self-loops, column-normalized, f32; caps
   from scipy's counts of each rank's stage products and C tile) under
   rotate with overlap on and off (bitwise equal) and alltoall, and
   batched with compression: index structure as the uncompressed C's,
   max abs error > 0 and within the JAX package's bound 2 (vmax/254) vmax
   (k+1), each run's wire bytes beside the uncompressed run's and the
   ``dist.compress.bytes_in/out`` counters. 17: phase
   10's graph on 2x2, BFS from its 4 roots (levels bitwise equal to
   scipy's) and PageRank (L1 <= 1e-4 to phase 11's float64 reference).
   18: FastSV (phase 12's labels), maximal matching (consistent,
   maximal) and SpMM (``spmm_15d`` and ``spmm_2d`` within phase 15's f32
   bound, bitwise equal under MAX_PLUS). 19: HipMCL on 8,192 planted
   proteins (cut from phase 14's 32,768: the gloo path stages its
   all-to-alls and permutes through host memory) read from a LABEL file:
   the float64 MCL's partition and the 1x1 run's, purity 1. Each phase
   prints its wall beside the 1x1 phase's (four processes sharing one card: no
   scaling result), each rank's peak memory, segreduce launches by route
   and semiring_matmul's, descent flag (which must be clear) and
   exchanges (calls, bytes, host seconds, from ``core/comm.py``'s
   accounting). Each measured run records both kernels' calls by shape;
   after it, one rank at a time, each rank holds every recorded shape
   against the plain version and times it (as phases 12-15 do), and
   fails unless the held calls are all of its launches. Every host answer
   must be the same on every rank. A rank that fails, does not report within
   ``GRID_TIMEOUT_S`` or exits non-zero fails the script.
20. the 2x2x2 grid (after 16-19): eight ranks, one process a grid
   position (l, i, j), spawned the same way (``nccl`` with a card a rank,
   else ``gloo``). (a) phase 16's L (phase 3's graph permuted as
   ``random_permute`` permutes it, the strict lower triangle, ones) as
   'acol' A and 'brow' B, ``structural(L)`` as the 'csub' mask:
   ``spgemm_3d`` (merge 'deferred') with overlap on and off, caps sized
   from scipy's counts of each rank's work (``work_3d``) and every ``ok``
   required; the sum of C3 is phase 3's triangles and C3's global COO is
   phase 16's C bitwise; (b) phase 4's graph, A.A unmasked under
   ARITHMETIC with ones, nnz and max as phase 4's and scipy's C bitwise.
   Each rank prints its warm wall (beside phase 16's 2x2 and phase 3's
   1x1), peak memory, segreduce launches by route (the overlapped run's
   calls held against the plain version, one rank at a time),
   semiring_matmul's (0), the descent flag and its exchanges by axis (one
   layer's SUMMA on 'row', 'col' and 'plane'; the inter-layer all-to-all
   and the mask's gather on 'layer').
21. the robustness layer (after 20): (a) phase 3's graph on 1x1: the
   tricount walls with the audit ``off``, ``boundary`` and ``full``; each
   fault kind (nan, corrupt_val, corrupt_idx, drop, dup) at
   ``spgemm2d.comm_a`` under the boundary audit (at the caps the planner
   grew to in a clean run) detected once and retried from the pristine
   operand to 6,688,911 triangles (2 attempts, no rung);
   ``drop`` with the audit off giving another count (printed: the
   documented trade); ``plan.spgemm.ok:flip`` retried once; a persistent
   ``merge.kv_ok:flip`` on the masked product (merge 'deferred') walking
   the ladder to the sort merge with the right count; a persistent
   ``dist.compressed_exchange`` fault on phase 16 (d)'s int8 P.P shedding
   ``serial-schedule:overlap+compress=int8`` to the uncompressed C (phase
   16's nnz, column sums n). (b) one BFS root of phase 10 with a quarter
   of the frontier dropped at level 3 (``spmspv.comm_x:drop``; corrupt_val
   leaves a bool frontier unchanged): levels bitwise scipy's, that level
   retried once. (c) PageRank (phase 11) with a checkpoint directory,
   crashed by ``loop.crash`` at its 8th iteration with the newest
   checkpoint's leaf corrupted: the rerun falls back a step and returns r
   bitwise equal to an uninterrupted run; HipMCL (phase 14's network)
   crashed at its 10th iteration resumes to phase 14's labels; checkpoint
   bytes and seconds a save beside the iteration. (d) four ranks on 2x2
   with phase 16's masked product: ``spgemm2d.comm_b:drop`` under the
   boundary audit (every rank 2 attempts, C bitwise phase 16's); a delay
   at ``dist.exchange_deadline`` armed on rank 1 only (every rank backs
   off and retries once); the same with ``count=99`` (every rank sheds the
   schedule, then raises the same ``TopologyError``); C saved with
   ``save_spmat`` on 2x2 and restored onto 1x1 here, bitwise. The faulted
   runs' segreduce calls are recorded by shape and held against the plain
   version (on the ranks, one rank at a time).
22. the in-process elastic regrid (after 21): (a) four ranks on 2x2 with
   phase 10's graph and phase 19's network; ``loop.device_loss`` at the
   4th iteration of ``pagerank``, ``fastsv`` and ``hipmcl`` with
   ``elastic=True``: each regrids (PageRank its normalized matrix, FastSV
   ``a``; HipMCL moves its mesh) onto 1x1, ranks 1-3 retire and every rank
   returns rank 0's answer. PageRank's r bitwise equal to the same loss
   without ``elastic`` (it checkpoints every iteration and raises on 2x2)
   resumed on 1x1 here from that checkpoint, and within phase 11's L1 to
   the float64 reference; FastSV's labels phase 12's; HipMCL phase 19's
   float64 partition. Per rank: each ``regrid``'s seconds and the bytes
   it sent, the iterations before and after the shrink, the wall and
   peak. (b) eight ranks on 2x2x2: phase 20's L ('acol', 'brow') and mask
   ('csub') regridded to 1x2x2 (ranks 4-7 retire), each global COO
   bitwise before and after; the masked tricount product through
   ``spgemm_3d`` on 1x2x2 (cold), 6,688,911. (c) (a)'s ranks run under
   ``REPRO_TRACE``: each rank's ``chiprun_out/phase22_trace.rank<r>.json``
   loads as JSON with ``traceEvents``, holds ``pagerank.iter``,
   ``dist.regrid`` and ``loop.topology``, and names only spans and events
   the JAX package emits (read from its source text); each rank's
   ``coverage('pagerank.iter')`` printed. Every segreduce call of (a) and
   (b) is recorded on its rank and held against the plain version there.

26. train: qwen2-moe-a2.7b at full width, 4 of its 24 layers (every
   width kept; float32 parameters, gradients and AdamW's m and v, 48.7
   GB at 4 layers against 242 GB at 24): ``init_params(seed=0)`` on the
   card, ``SyntheticLM(seed=11)`` batches of 2 x 4096 through a
   ``Prefetcher``, 10 steps of ``make_train_step`` with the launcher's
   ``AdamWConfig(warmup_steps=20, decay_steps=100)``; each step's loss,
   grad_norm and lr (finite), cold and warm step wall, tokens/s, peak
   memory, the launches of every kernel a step (flash forward 8 with
   remat, its backward 4, bsr_spmm 24 forward and 24 backward products,
   the others 0), then one more step profiled by operator with the busy
   share. 26b: the same model cut to 2 layers in f32, batch 2 x 256: loss,
   aux and every gradient leaf on the card (kernels and their backward
   kernels) against the CPU (plain versions) from the same parameters, the
   CPU taking the card's routing choices (those that differ counted
   first). 26c: ``python -m repro_torch.launch.train --arch
   qwen2-moe-a2.7b --smoke --steps 30`` in its own process: the loss
   falls.
27. train: mamba2-2.7b at full width and depth (64 layers, 2.83 B float32
   parameters with AdamW's state, 45 GB), phase 26's batches, steps and
   optimizer; losses and grad_norms finite, launches a step checked
   (ssd_chunk forward 128 with remat, its backward 64, the others 0), cold
   and warm step, tokens/s, peak memory, one profiled step with the busy
   share. 27b: two mamba2 layers at full width in f32, batch 2 x 256, loss
   and every gradient leaf card against CPU, as 26b. 27c: the launcher,
   ``--smoke --steps 30``, for mamba2-2.7b and jamba-1.5-large-398b (its
   smoke runs ssd_chunk and its backward, attention forward and backward
   and bsr_spmm with its gradients): the loss falls.
28. the sharding layer: qwen2-moe-a2.7b under ``make_plan(mesh=(data=2,
   model=2), moe_ep=True)``, four ranks sharing the card (gloo; gathers
   cross through the card's memory, ``comm.CardMailbox``, as on phases
   16-22's grids), each rank holding its block of every leaf
   (``init_params(plan=)``, leaf by leaf). (a) the 2-layer f32 cut, batch 4
   x 64: each data shard's logits within E2E_LOGIT_TOL of the plan-less
   forward of its rows on the card, aux within 1e-6 of the mean of those
   forwards' (the reference's mean over the data axes), bitwise across each
   model group and across two runs, every bsr_spmm call held against the
   plain version; a 64 MiB gather timed through the mailbox and staged
   over gloo. (d) (a)'s parameters saved from (2, 2) and
   restored onto (4, 1) and (1, 4) (``reshard_restore``), every rank's
   block bitwise the saved leaf's. (b) full width and depth in bf16 (each
   rank 32 of the 64 padded experts): phase 7's prompt through
   ``greedy_generate``, 8 tokens, a cold run (every bsr_spmm call and the
   first flash_attention call held against the plain version) and a warm
   run (the main path alone); logits finite, tokens in range, every rank's
   the same, the last-position prefill logits and the tokens bitwise those
   of phase 7's model on each shard's rows alone; per rank the walls,
   peak, launches per forward and the exchanges split into leaf gathers
   and expert sums. (c) rank 0's layer-0 ``we_g`` and ``we_2`` launches of
   (b)'s prefill and first decode step (R = 32) held against the plain
   version and timed beside the bound and ``torch.bmm``.

In phases 12-15 every segreduce call of one run is recorded by shape
(route, dtype, tag, N, D, S); each shape's first call is run again, held
against the plain version on the same inputs (phase 2's tolerance) and
timed like phase 3's calls, and the calls by route must equal the launches
the phase counted.

Phases run in the order 1, 2, 2b, 3-5, 10-13, 15, 14, 6, 7, 23, 6b, 6c,
6d, 7b, 23b, 24, 24b, 25, 25b, 26, 26b, 26c, 8, 8b, 9, 9b, 27, 27b, 27c,
16-22, 28 (its parts a, d, b, c); the script prints its wall last before
the records.

Phases 2-5 and 10-15 fail if a sorted-route launch saw its ids descend (a
caller's broken ``sorted_ids`` promise: ``segreduce.descents()``). The two
lines before the last are a JSON object with one record per kernel
(segreduce's adds the atomic route's time, the main-path calls' summed time
and bound, phases 10-15's launches by route, each rank's launches on
the 2x2 and the 2x2x2 grids, phase 21's and phase 22's; flash_attention's
and bsr_spmm's a ``backward`` record of the same keys, its launches phase
26's run; ssd_chunk's likewise, its launches phase 27's run; phase 28's
launches by rank under ``launches_by_path``, bsr_spmm's EP shape under
``ep_shape``) and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
The script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (the bound is stated against these)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12                  # dense, tensor cores

RMAT_SCALE, RMAT_EDGE_FACTOR, RMAT_SEED = 15, 16, 0
EXPECTED_TRIANGLES = 6_688_911
# phase 4: the dense accumulator's full width (m * n = dense_tile_limit)
DENSE_SCALE, DENSE_EDGE_FACTOR = 11, 64
EXPECTED_DENSE = dict(nnz_a=130_560, nnz_c=2_893_522, max_c=1_310)

# phase 7: the serving cell
SERVE_ARCH = "qwen2-moe-a2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
# phase 7b: kernels against plain versions end to end, float32
E2E_LAYERS, E2E_BATCH, E2E_PROMPT, E2E_TOKENS = 2, 2, 64, 4
E2E_LOGIT_TOL = 1e-3      # logits of order 1; two summation orders in f32

# phases 23-25: the other three families at full width and depth, each
# freed before the next. 23: MLA with phase 7's traffic; 24: qwen2-vl with a
# 16 x 32 grid of image patches at the first 512 of 2,048 prompt positions,
# then text decode steps; 25: hubert over 8 clips of 1,500 frames (30 s at
# 50 frames/s). 23b-25b: each cut to E2E_LAYERS layers in f32, the card
# against the CPU
MLA_ARCH, VL_ARCH, AUDIO_ARCH = \
    "deepseek-v2-lite-16b", "qwen2-vl-7b", "hubert-xlarge"
VL_GRID = (16, 32)
AUDIO_BATCH, AUDIO_FRAMES = 8, 1500
AUDIO_E2E_BATCH = 2
# phase 26: training qwen2-moe-a2.7b at full width, 4 of 24 layers (float32
# parameters, gradients and AdamW's m and v: 16 B a parameter, 48.7 GB at
# 4 layers, 242 GB at 24), batch 2 x 4096 (the registry's train_4k
# sequence), 10 steps. 26b: E2E_LAYERS layers in f32 on card and CPU
TRAIN_ARCH = SERVE_ARCH
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 4096, 10
TRAIN_E2E_BATCH, TRAIN_E2E_SEQ = 2, 256
TRAIN_E2E_TOL = 1e-4
# phase 8: (G, q, H, P, N) of phase 9's prefill (batch 4 x 2048 / 128 chunks)
SSD_MAIN = (64, 128, 80, 64, 128)
# phase 9: the mamba2 serving cell (phase 7's traffic); phase 27 trains it
# at full width and depth with phase 26's batches and steps
MAMBA_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "jamba-1.5-large-398b"      # phase 27c, the launcher's smoke
# phase 9b: the kernel against plain versions end to end, float32
MAMBA_E2E_LAYERS, MAMBA_E2E_BATCH, MAMBA_E2E_PROMPT, MAMBA_E2E_TOKENS = \
    2, 2, 300, 4
# phases 10-11: Graph500's generator shape (a,b,c,d and edge factor 16) at
# scale 20, cut from its smallest class (toy, scale 26); BFS from 4 roots,
# PageRank against a float64 scipy power iteration
GRAPH_SCALE, GRAPH_EDGE_FACTOR, BFS_ROOTS = 20, 16, 4
PR_ALPHA, PR_TOL, PR_MAX_ITERS, PR_L1_TOL = 0.85, 1e-8, 100, 1e-4
# phase 13: a bound on the passes, far above what the fixed point takes
MATCH_MAX_ITERS = 10_000
# phase 14: the planted protein-family network (families of 32-64, pairs
# within a family linked with p = 0.5, ~2 cross-family links a protein).
# Halved from 65,536 proteins, whose expansions ran out of the card's 80 GB
# (the planner's caps reach 2^30 slots on the family-dense iterates)
HIPMCL_PROTEINS, HIPMCL_FAMILY, HIPMCL_P_IN, HIPMCL_CROSS = \
    32768, (32, 64), 0.5, 2
# phase 15: SpMM's dense operand, k f32 columns
SPMM_K = 16

KERNELS = ("segreduce", "semiring_matmul", "flash_attention", "bsr_spmm",
           "ssd_chunk", "flash_attention_bwd", "ssd_chunk_bwd")

# phases 16-19: the 2x2 grid, four ranks (one process a grid position).
# They read phase 3's and phase 10's graphs from GRID_DIR and are held
# against the 1x1 phases' answers and walls, kept in ONE_BY_ONE. HipMCL
# runs 8,192 proteins on the grid (a quarter of phase 14's 32,768): the
# gloo path stages its all-to-alls and permutes through host memory
GRID_Q = 2
GRID_DIR = ROOT / "build" / "grid"
GRID_HIPMCL_PROTEINS = 8192
GRID_TIMEOUT_S = 420           # a phase's limit on every rank
GRID_NBATCH = 4                # phase 16's column batches
# phase 20: the 2x2x2 grid (layers, q, q), eight ranks
GRID3 = (2, 2, 2)
# phase 21: the robustness layer on phases 3, 10, 11, 14 and 16's data.
# The comm-site fault kinds; the BFS level whose frontier is corrupted; the
# ``loop.crash`` activations (iterations, from 1) that crash PageRank and
# HipMCL; on 2x2, rank 1's delay inside the timed exchange region and the
# deadline it overruns
ROBUST_KINDS = ("nan", "corrupt_val", "corrupt_idx", "drop", "dup")
ROBUST_BFS_LEVEL = 3
ROBUST_CRASH_AT = {"pagerank": 8, "hipmcl": 10}
ROBUST_LAG_S, ROBUST_DEADLINE_S = 0.5, 0.25
ROBUST_DIR = ROOT / "build" / "robust"
ELASTIC_AT = 4                 # phase 22's device loss: the 4th iteration
ELASTIC_LOSS = f"loop.device_loss:crash:at={ELASTIC_AT}"
ELASTIC_DIR = ROOT / "build" / "elastic"
ELASTIC_TRACE = ROOT / "chiprun_out" / "phase22_trace.json"
ONE_BY_ONE: dict = {}
# phase 28: qwen2-moe-a2.7b under a ShardingPlan with expert-parallel MoE on
# a (data=2, model=2) mesh, four ranks sharing the card. (a) the E2E_LAYERS
# f32 cut, batch EP_BATCH x EP_E2E_PROMPT; (b) full width and depth in bf16,
# phase 7's prompt, EP_TOKENS greedy tokens; (c) bsr_spmm at the EP shape
# (R = 64 padded experts / 2); (d) (a)'s parameters restored onto EP_RESTORE
EP_MESH, EP_AXES = (2, 2), ("data", "model")
EP_GROUPS = ((0, 1), (2, 3))       # the ranks of each model group
EP_BATCH, EP_PROMPT, EP_TOKENS = SERVE_BATCH, SERVE_PROMPT, 8
EP_E2E_PROMPT = E2E_PROMPT
EP_PREFILL_TOL = 2.0 ** -4         # (b)'s printed scale of max |logit|
EP_R = 32
EP_TIMED = ("we_g", "we_2", "we_g decode", "we_2 decode")   # (c)'s launches
EP_RESTORE = ((4, 1), (1, 4))
EP_DIR = ROOT / "build" / "ep"
EP_TIMEOUT_S = 600             # a part's limit on every rank
EP_REFERENCE: dict = {}        # (b)'s, from phase 7


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, match, iters: int = 20) -> float:
    """Mean device time a launch of the kernels whose name holds ``match``
    (for a tuple of names, the sum of that over each) over ``iters`` calls
    of ``fn()``, from torch.profiler: for a call short enough that the
    host's enqueue, not the device, paces back-to-back calls. The trace
    may miss launches (the profiler has dropped every launch of a 1 µs
    kernel from one trace): the mean is over those it holds, and a trace
    that holds none of a kernel is taken again, up to three times. When
    all three hold none (a four-rank run on one card once lost every
    launch of a shape from a rank's three traces), the calls are timed by
    CUDA events instead: launch gaps included, so no less than the device
    time. The kernels' launches are counted by their wrappers, not here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        hits = [[e for e in events if name in e.key] for name in names]
        counts = [sum(e.count for e in h) for h in hits]
        if all(counts):
            return sum(sum(e.self_device_time_total for e in h) / c / 1e3
                       for h, c in zip(hits, counts))
    missing = [n for n, c in zip(names, counts) if not c]
    ms = cuda_time_ms(fn, iters)
    log(f"  no {missing} kernel in three profiler traces: {ms:.4f} ms a "
        "call by CUDA events instead (launch gaps included)")
    return ms


# --------------------------------------------------------------------------
# phase 1: setup
# --------------------------------------------------------------------------

def setup() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(_build.load, KERNELS))
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(KERNELS)} kernels")
    for name in KERNELS:
        info = _build.build_info[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "warning" in line or "(C75" in line \
                    or ("spill" in line and " 0 bytes spill" not in line):
                log("    ptxas:", line.strip())
        for fname, regs, spills in _ptxas_by_function(info["log"]):
            if "wgmma" in fname:
                log(f"    ptxas {fname[:64]}...: {regs}; {spills}")
    check_hopper_sass(_build)
    return smi.splitlines()[0]


def _ptxas_by_function(text: str) -> list:
    """(function, its "Used N registers" text, its spill stores and loads)
    of each entry function in ptxas' -v output."""
    out, name, spills = [], None, "spills not reported"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), "spills not reported"
        elif "spill stores" in line and name:
            spills = ", ".join(x.strip() for x in line.split(",")
                               if "spill" in x)
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used \d+ registers", line)
            out.append((name, regs.group(0) if regs else line.strip(),
                        spills))
            name = None
    return out


# the kernels redesigned on wgmma and TMA: each function whose name holds
# "wgmma" must contain both instructions in its SASS, and a library must
# hold each wgmma kernel named here
HOPPER_KERNELS = ("flash_attention", "bsr_spmm", "ssd_chunk",
                  "flash_attention_bwd", "ssd_chunk_bwd")
HOPPER_NAMES = {
    "flash_attention": ("flash_attention_wgmma_kernel",),
    "flash_attention_bwd": ("flash_attention_bwd_dkdv_wgmma_kernel",
                            "flash_attention_bwd_dq_wgmma_kernel"),
    "ssd_chunk_bwd": ("ssd_chunk_bwd_wgmma_kernel",),
}


def cuobjdump_path() -> str:
    """``$CUDA_HOME/bin/cuobjdump`` (else /usr/local/cuda's), else the copy in
    Triton's ``backends/nvidia/bin``; raises if there is neither."""
    import importlib.util
    import os
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    cands = [home / "bin" / "cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                     / "cuobjdump")
    for cand in cands:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(f"cuobjdump not found (tried {[str(c) for c in cands]})")


def check_hopper_sass(_build) -> None:
    """Phase 1: the redesigned kernels are Hopper's. Disassembles their
    libraries and fails unless every wgmma kernel holds HGMMA (wgmma) and
    UTMALDG (a TMA load)."""
    tool = cuobjdump_path()
    for name in HOPPER_KERNELS:
        sass = subprocess.run([tool, "-sass", _build.build_info[name]["path"]],
                              capture_output=True, text=True, check=True).stdout
        funcs = [f for f in sass.split("Function : ")[1:]
                 if "wgmma" in f.split(None, 1)[0]]
        if not funcs:
            raise AssertionError(f"{name}: no wgmma kernel in its library")
        for want in HOPPER_NAMES.get(name, ()):
            if not any(want in f.split(None, 1)[0] for f in funcs):
                raise AssertionError(f"{name}: no {want} in its library")
        for f in funcs:
            fname = f.split(None, 1)[0]
            counts = {op: f.count(op) for op in ("HGMMA", "UTMALDG",
                                                 "UTMASTG")}
            log(f"  {name} SASS: {fname[:72]}... {counts}")
            if not counts["HGMMA"] or not counts["UTMALDG"]:
                raise AssertionError(f"{name}: {fname} lacks HGMMA or UTMALDG")


# --------------------------------------------------------------------------
# phase 2: segreduce kernel vs plain
# --------------------------------------------------------------------------

def _segreduce_inputs(n, s, dtype, ids_kind, seed, vdims=()):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if ids_kind == "oor":               # ~10% ids outside [0, s), unsorted
        ids = torch.randint(-s // 8 - 1, s + s // 8 + 1, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
    else:
        ids = torch.randint(0, s, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
        if ids_kind == "sorted":
            ids = torch.sort(ids).values
    shape = (n,) + tuple(vdims)
    if dtype == torch.bool:
        vals = torch.rand(shape, generator=g, device="cuda") < 0.5
    elif dtype.is_floating_point:
        vals = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    else:
        vals = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device="cuda", dtype=torch.int64).to(dtype)
    return vals, ids


def _compare(got, want, vals, ids, s, tag):
    """Max abs error; raises unless exact (ints, bools, min/max) or, for a
    float sum, within the bound of any summation order: two orders of a
    segment with c values differ by at most 2(c-1)u*sum|v| (u = 2^-24 for
    f32, 2^-53 for f64), and a segment of one value is exact."""
    from repro_torch.kernels.segreduce import segment_reduce_plain
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if tag != "sum" or not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{bad} segments differ")
        return 0.0
    err = (got.double() - want.double()).abs()
    u = 2.0 ** -24 if got.dtype == torch.float32 else 2.0 ** -53
    count = segment_reduce_plain(torch.ones_like(ids), ids, s, "sum").double()
    count = count.reshape((-1,) + (1,) * (got.dim() - 1))
    abssum = segment_reduce_plain(vals.abs(), ids, s, "sum").double()
    tol = 2.0 * (count - 1).clamp(min=0) * u * abssum
    if not bool((err <= tol).all()):
        raise AssertionError(f"f32 sum beyond order bound: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _sorted_cases():
    """Phase 2's sorted-route cases: (name, ids, S, dtype, tag, identity),
    every id stream non-decreasing once clamped to [-1, S]."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand_sorted(lo, hi, n):
        return torch.sort(torch.randint(lo, hi, (n,), generator=g,
                                        device="cuda")).values.int()

    ar = lambda n: torch.arange(n, device="cuda", dtype=torch.int32)
    dtypes = (torch.float32, torch.int32, torch.bool, torch.float64,
              torch.int64)
    cases = []
    for dtype in dtypes:                 # every dtype x tag
        for tag in ("sum", "min", "max"):
            for n, s in ((8, 8), (1000, 300), (300, 1), (4096, 1 << 16),
                         (1 << 20, 1 << 20)):
                cases.append((f"{n}/{s}", rand_sorted(0, s, n), s, dtype,
                              tag, None))
            cases.append(("ids out of range on both sides",
                          rand_sorted(-400, 3400, 5000), 3000, dtype, tag,
                          None))
    for dtype, tag in ((torch.float32, "sum"), (torch.float32, "min"),
                       (torch.float32, "max"), (torch.int32, "sum"),
                       (torch.float64, "sum")):
        cases.append(("one segment of 2^20", torch.full(
            (1 << 20,), 7, dtype=torch.int32, device="cuda"), 10, dtype,
            tag, None))
    for name, ids, s in (
            ("runs of one tile", ar(1 << 16) // 2048, 32),
            ("runs straddling 2 tiles", (ar(1 << 16) + 1000) // 2048, 33),
            ("runs straddling 3 tiles", ar(1 << 16) // 5000, 14),
            ("runs over many tiles", ar(1 << 20) // 300_000, 4),
            ("all padding (ids >= S)", torch.full((1 << 16,), 1 << 14,
                                                   dtype=torch.int32,
                                                   device="cuda"), 1 << 14),
            ("all negative", torch.full((1 << 16,), -3, dtype=torch.int32,
                                        device="cuda"), 1 << 14),
            ("S >> N, large gaps", rand_sorted(0, 1 << 24, 5000), 1 << 24),
            ("S below the largest id", rand_sorted(0, 1 << 20, 1 << 20),
             1 << 19),
            ("the merge engine's tail", torch.cat([
                rand_sorted(0, 100_000, 1 << 20),
                torch.full((1 << 22,), 1 << 19, dtype=torch.int32,
                           device="cuda")]), 1 << 19)):
        for tag in ("sum", "min", "max"):
            cases.append((name, ids, s, torch.float32, tag, None))
    # declared identities: MAX_INT with values below it, MIN_INT, inf, bool
    for dtype, tag, ident in ((torch.int32, "max", -(2**31) + 1),
                              (torch.int32, "min", 2**31 - 1),
                              (torch.float32, "min", float("inf")),
                              (torch.bool, "max", False),
                              (torch.bool, "min", True)):
        cases.append((f"identity {ident}", rand_sorted(-50, 5050, 1000),
                      5000, dtype, tag, ident))
    # int64 ids with out-of-range values on both sides
    ids64 = torch.cat([torch.full((100,), -2**40, device="cuda"),
                       rand_sorted(-5, 70_000, 1 << 18).long(),
                       torch.full((100,), 2**40, device="cuda")])
    for tag in ("sum", "min", "max"):
        cases.append(("int64 ids beyond int32", ids64, 65_536,
                      torch.float32, tag, None))
    return cases


def _sorted_values(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(n, generator=g, device="cuda") < 0.5
    if dtype.is_floating_point:
        return torch.randn(n, generator=g, device="cuda", dtype=dtype)
    return torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                         device="cuda", dtype=torch.int64).to(dtype)


def check_descents(what: str) -> None:
    """Fail if a sorted-route launch saw its ids descend (a caller's
    broken ``sorted_ids`` promise)."""
    from repro_torch.kernels import segreduce
    if segreduce.descents():
        raise AssertionError(f"{what}: a sorted_ids promise was broken "
                             f"(the sorted route's descent flag is set)")


def check_segreduce() -> dict:
    from repro_torch.kernels import segreduce
    from repro_torch.kernels.segreduce import segment_reduce_plain

    max_err = 0.0
    cases = []
    # the atomic route (sorted_ids=False): any id order, vector values
    # (n, s, dtype, tag, ids kind, identity, value dims)
    for dtype in (torch.float32, torch.int32, torch.bool, torch.float64,
                  torch.int64):
        for tag in ("sum", "min", "max"):      # a bool sum is a logical or
            for ids_kind in ("sorted", "unsorted", "oor"):
                for n, s in ((8, 8), (1000, 300), (300, 1), (4096, 1 << 16),
                             (1 << 20, 1 << 20)):
                    cases.append((n, s, dtype, tag, ids_kind, None, ()))
    # the atomic route at N = S = 2^22 and 2^24, f32 sums of sorted ids
    for n in (1 << 22, 1 << 24):
        cases.append((n, n, torch.float32, "sum", "sorted", None, ()))
    # declared identities that differ from the dtype extreme: MAX_INT / MIN_INT
    # over untouched segments, and touched values below MAX_INT's identity
    cases.append((1000, 5000, torch.int32, "max", "unsorted", -(2**31) + 1, ()))
    cases.append((1000, 5000, torch.int32, "min", "unsorted", 2**31 - 1, ()))
    cases.append((1000, 5000, torch.float32, "min", "oor", float("inf"), ()))
    cases.append((1000, 5000, torch.bool, "max", "oor", False, ()))
    # vector values: rows of D elements, one touch per row
    for dtype, tag, ident in ((torch.float32, "sum", None),
                              (torch.float32, "max", -float("inf")),
                              (torch.int32, "min", 2**31 - 1),
                              (torch.bool, "sum", None)):
        for vdims in ((3,), (2, 5)):
            cases.append((1 << 16, 1 << 12, dtype, tag, "oor", ident, vdims))
    for i, (n, s, dtype, tag, ids_kind, ident, vdims) in enumerate(cases):
        vals, ids = _segreduce_inputs(n, s, dtype, ids_kind, seed=i,
                                      vdims=vdims)
        if ident == -(2**31) + 1:
            vals[:4] = -(2**31)              # below the declared identity
        if i % 7 == 0:
            ids = ids.long()                 # int64 ids (narrowed by the wrapper)
        before = segreduce.route_launches["atomic"]
        got = segreduce.segment_reduce(vals, ids, s, tag, identity=ident)
        want = segment_reduce_plain(vals, ids, s, tag, identity=ident)
        torch.cuda.synchronize()
        try:
            if segreduce.route_launches["atomic"] != before + 1:
                raise AssertionError("did not take the atomic route")
            err = _compare(got, want, vals, ids, s, tag)
        except AssertionError as e:
            raise AssertionError(f"segreduce n={n} s={s} {dtype} {tag} "
                                 f"{ids_kind} identity={ident} vdims={vdims}: "
                                 f"{e}") from e
        max_err = max(max_err, err)
    log(f"segreduce atomic route: {len(cases)} cases match the plain version "
        f"(max abs err of f32/f64 sums {max_err:.3g})")

    # the sorted route (sorted_ids=True, scalar values): each case's route
    # printed and checked, then held against the plain version (which
    # checks the promise)
    segreduce.reset_descents()
    sorted_cases = _sorted_cases()
    seen = {}
    for i, (name, ids, s, dtype, tag, ident) in enumerate(sorted_cases):
        vals = _sorted_values(ids.shape[0], dtype, seed=1000 + i)
        if ident == -(2**31) + 1:
            vals[::7] = -(2**31)             # below the declared identity
        which = segreduce.route(dtype, 1, True)
        before = segreduce.route_launches["sorted"]
        got = segreduce.segment_reduce(vals, ids, s, tag, identity=ident,
                                       sorted_ids=True)
        want = segment_reduce_plain(vals, ids, s, tag, identity=ident,
                                    sorted_ids=True)
        torch.cuda.synchronize()
        try:
            if which != "sorted" or \
                    segreduce.route_launches["sorted"] != before + 1:
                raise AssertionError(f"route {which}, not sorted")
            err = _compare(got, want, vals, ids, s, tag)
        except AssertionError as e:
            raise AssertionError(f"segreduce sorted route, {name}, N="
                                 f"{ids.shape[0]} S={s} {dtype} {tag} "
                                 f"identity={ident}: {e}") from e
        max_err = max(max_err, err)
        seen[name] = seen.get(name, 0) + 1
    check_descents("phase 2's sorted cases")
    log(f"segreduce sorted route: {len(sorted_cases)} cases, route sorted, "
        f"match the plain version (max abs err of f32/f64 sums "
        f"{max_err:.3g}); descent flag clear")
    for name, count in seen.items():
        log(f"  {name}: {count}")
    # a broken promise sets the flag (and is then cleared)
    bad = torch.cat([torch.arange(5000, device="cuda"),
                     torch.arange(5000, device="cuda")]).int()
    segreduce.segment_reduce(torch.ones(10_000, device="cuda"), bad, 6000,
                             "sum", sorted_ids=True)
    if segreduce.descents() != 1:
        raise AssertionError("a descending stream left the flag clear")
    segreduce.reset_descents()
    log("segreduce sorted route: a descending stream sets the descent flag")

    # times at N = S = 2^24, f32 sum, random sorted ids: the sorted route
    # twice (bitwise equal), the atomic route (the first design) on the same
    # input, the plain version, scatter_reduce_
    n = s = 1 << 24
    vals, ids = _segreduce_inputs(n, s, torch.float32, "sorted", seed=99)
    got = segreduce.segment_reduce(vals, ids, s, "sum", sorted_ids=True)
    again = segreduce.segment_reduce(vals, ids, s, "sum", sorted_ids=True)
    want = segment_reduce_plain(vals, ids, s, "sum", sorted_ids=True)
    err_main = _compare(got, want, vals, ids, s, "sum")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("two sorted f32 sums of one input differ")
    atomic = segreduce.segment_reduce(vals, ids, s, "sum")
    _compare(atomic, want, vals, ids, s, "sum")
    log(f"segreduce N=S=2^24 f32 sum: two sorted-route launches bitwise "
        f"equal; max abs err {err_main:.3g} (atomic route "
        f"{float((atomic - want).abs().max()):.3g})")
    ms = cuda_time_ms(lambda: segreduce.segment_reduce(
        vals, ids, s, "sum", sorted_ids=True), iters=50)
    atomic_ms = cuda_time_ms(lambda: segreduce.segment_reduce(
        vals, ids, s, "sum"), iters=50)
    plain_ms = cuda_time_ms(lambda: segment_reduce_plain(vals, ids, s, "sum"),
                            iters=20)
    ids64 = ids.long()
    out = torch.zeros(s, dtype=torch.float32, device="cuda")
    library_ms = cuda_time_ms(
        lambda: out.scatter_reduce_(0, ids64, vals, "sum", include_self=False),
        iters=50)
    check_descents("phase 2's timings")
    # least time: each input read once (value + id), each output written
    # once; one add per input at the f32 peak
    nbytes = n * (4 + 4) + s * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n / F32_FLOPS * 1e3
    log(f"segreduce N=S=2^24 f32 sum sorted ids: sorted route {ms:.4f} ms, "
        f"atomic route {atomic_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scatter_reduce_ {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.3f} GB)")
    return {"name": "segreduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segreduce.cu",
            "replaces": "src/repro/kernels/segreduce.py:88",
            "launches": None, "max_abs_err": max(max_err, err_main),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "atomic_route_ms": atomic_ms}


def _hold_call(vals, ids, s, tag, kw) -> dict:
    """One recorded segreduce call (values, ids, S, tag, kwargs) run again,
    held against the plain version (phase 2's ``_compare``), and timed by
    its route's two kernels' device time (torch.profiler: the host's
    enqueue would pace CUDA events) beside its bound: the bytes its route
    must move, for a sorted call its in-range ids and values, one id pair a
    2048-element tile (its two ends) and the S outputs, for an atomic call
    every id (any may be in range), the in-range rows of D values and the S
    output rows. A sorted call with S = 0 launches nothing: it is held, not
    timed."""
    from repro_torch.kernels import segreduce
    from repro_torch.kernels.segreduce import segment_reduce_plain
    d = math.prod(vals.shape[1:])
    route = segreduce.route(vals.dtype, d, kw.get("sorted_ids", False))
    call = lambda: segreduce.segment_reduce(vals, ids, s, tag, **kw)
    try:
        err = _compare(call(), segment_reduce_plain(vals, ids, s, tag, **kw),
                       vals, ids, s, tag)
    except AssertionError as e:
        raise AssertionError(f"segreduce {route} {vals.dtype} {tag} N "
                             f"{ids.shape[0]} D {d} S {s}: {e}") from e
    n, isz = ids.shape[0], vals.element_size()
    live = int(((ids >= 0) & (ids < s)).sum())
    ms = bound = 0.0
    if route == "atomic" or s > 0:
        ms = kernel_device_ms(call, ("segreduce_sorted_tiles",
                                     "segreduce_sorted_carry")
                              if route == "sorted" else
                              ("segreduce_init", "segreduce_accum"))
        nbytes = (live * (4 + isz) + s * isz + -(-n // 2048) * 8
                  if route == "sorted" else n * 4 + (live + s) * d * isz)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"route": route, "dtype": str(vals.dtype)[6:], "tag": tag,
            "n": n, "d": d, "s": s, "live": live, "ms": ms, "bound": bound,
            "err": err}


def _shape_line(k, h) -> str:
    return (f"{k}x {h['route']} {h['dtype']} {h['tag']} N {h['n']} D "
            f"{h['d']} S {h['s']}, live ids {h['live']}: {h['ms']:.4f} ms "
            f"of device time, bound {h['bound']:.4f} ms (bytes); the plain "
            f"version's answer (max abs err {h['err']:.3g})")


def time_main_path_calls(calls, counts=None) -> tuple[float, float, float]:
    """Segreduce at the shapes a main path gives it: each recorded call
    (values, ids, S, tag, kwargs) held and timed by ``_hold_call``.
    Returns the sums of time and bound, each call weighted by its count in
    ``counts`` (1 without), and the max abs err."""
    total = bound_total = max_err = 0.0
    for i, (vals, ids, s, tag, kw) in enumerate(calls):
        k = counts[i] if counts else 1
        h = _hold_call(vals, ids, s, tag, kw)
        total += k * h["ms"]
        bound_total += k * h["bound"]
        max_err = max(max_err, h["err"])
        log(f"  {_shape_line(k, h)}")
    return total, bound_total, max_err


# --------------------------------------------------------------------------
# phase 2b: semiring_matmul kernel vs plain
# --------------------------------------------------------------------------

SMM_MAIN = (2048, 2048, 2048)        # (M, K, N) of phase 4's dense tile


def _smm_operands(kind, m, k, n, dtype, seed, integers=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "or_and":
        return (torch.rand(m, k, generator=g, device="cuda") < 0.2,
                torch.rand(k, n, generator=g, device="cuda") < 0.2)
    if integers or not dtype.is_floating_point:
        return (torch.randint(-4, 5, (m, k), generator=g, device="cuda")
                .to(dtype),
                torch.randint(-4, 5, (k, n), generator=g, device="cuda")
                .to(dtype))
    return (torch.randn(m, k, generator=g, device="cuda", dtype=dtype),
            torch.randn(k, n, generator=g, device="cuda", dtype=dtype))


def _smm_signed_zeros(kind, m, k, n, dtype, seed):
    """Operands of 0, -0, 1 and 2 (min_plus) or 0, -0, -1 and -2 (max_min):
    most results are a tie of +0 and -0 terms ((-0) + (-0) is the only -0
    sum; min(+0, -0) is -0), whose sign the kernel must not take from the
    order of k."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.tensor([0.0, -0.0, 1.0, 2.0], device="cuda", dtype=dtype)
    if kind == "max_min":
        vals = -vals
    return (vals[torch.randint(0, 4, (m, k), generator=g, device="cuda")],
            vals[torch.randint(0, 4, (k, n), generator=g, device="cuda")])


def smm_sass_counts(_build) -> None:
    """Phase 2b: the instruction mix of the redesigned semiring_matmul
    kernels, from ``cuobjdump -sass``: FFMA (plus_times), FMNMX (one a
    min or max), LDS.128 (the float4 fragment loads), LDGSTS (cp.async),
    LOP3 (or_and's packed step). Fails unless every f32 and or_and kernel
    holds LDS.128, and the f32 ones LDGSTS."""
    lib = _build.build_info["semiring_matmul"]["path"]
    sass = subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    ops = ("FFMA", "FMNMX", "LDS.128", "LDGSTS", "LOP3")
    found = 0
    for f in sass.split("Function : ")[1:]:
        fname = f.split(None, 1)[0]
        if "f32_kernel" not in fname and "or_and_kernel" not in fname:
            continue
        found += 1
        counts = {op: f.count(op) for op in ops}
        # from the kernel's name on, its template arguments (ILi<kind>E
        # Lb<vec>E) included
        short = fname[fname.rfind("semiring_matmul_"):][:48]
        log(f"  semiring_matmul SASS: {short} {counts}")
        if not counts["LDS.128"] or ("f32_kernel" in fname
                                     and not counts["LDGSTS"]):
            raise AssertionError(f"semiring_matmul: {fname} lacks LDS.128 "
                                 f"or LDGSTS")
    if found != 8:            # 3 algebras x 2 copy widths + or_and x 2
        raise AssertionError(f"semiring_matmul: {found} redesigned kernels "
                             f"in its library, not 8")


def _smm_compare(got, want, a, b, exact):
    """Max abs error; raises unless bitwise equal (up to NaN payloads) where
    ``exact``, else within the bound of any summation order,
    2 K u (|A| @ |B|) (u = 2^-24 for the f32 accumulator), plus one bf16
    rounding (2^-8 |want|) for a bf16 output; u = 2^-53 for f64."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if exact:
        if got.dtype.is_floating_point:
            same = ((got == want) & (got.signbit() == want.signbit())) | \
                (got.isnan() & want.isnan())
        else:
            same = got == want
        if not bool(same.all()):
            raise AssertionError(f"{int((~same).sum())} entries differ")
        return 0.0
    k = a.shape[1]
    u = 2.0 ** -53 if got.dtype == torch.float64 else 2.0 ** -24
    bound = 2 * k * u * (a.double().abs() @ b.double().abs())
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.double().abs()
    err = (got.double() - want.double()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"beyond the summation-order bound: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _smm_bound(kind, m, k, n, itemsize, sm_count, clock_hz):
    """Least time of C = A (+).(x) B at (m, k, n): operations at the card's
    rate for them (SM count x lanes x clock: plus_times one FMA a step on
    128 FP32 lanes, min_plus/max_min two non-fused operations a step on
    the same lanes, or_and one 32-bit logic op (LOP3: acc | a & b) per 32
    steps on 64 integer lanes, as a bit-packed K axis needs), or bytes
    (A and B read once, C written once) at 3.35 TB/s."""
    steps = m * k * n
    ops, lanes = {"plus_times": (1, 128), "min_plus": (2, 128),
                  "max_min": (2, 128), "or_and": (1 / 32, 64)}[kind]
    t_ops = steps * ops / (sm_count * lanes * clock_hz) * 1e3
    out_size = 1 if kind == "or_and" else itemsize
    nbytes = (m * k + k * n) * itemsize + m * n * out_size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def check_semiring_matmul() -> dict:
    from repro_torch.kernels import semiring_matmul as smm

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    # (129, 17, 257): a 128 x 128 tile's edges on all four sides
    shapes = (SMM_MAIN, (1000, 777, 1531), (1, 1, 1), (130, 17, 65),
              (5, 0, 7), (129, 17, 257))
    # (kind, dtype, shape, integer-valued float operands)
    cases = []
    for shape in shapes:
        cases += [("plus_times", f32, shape, True),
                  ("plus_times", f32, shape, False),
                  ("min_plus", f32, shape, False),
                  ("max_min", f32, shape, False),
                  ("or_and", b8, shape, False)]
    # or_and's packed words: K of 31, 32, 33 and 777 leave a partial last
    # word (unaligned rows: byte loads), 48 and 256 aligned rows (16-byte
    # loads), 48 a partial word among them
    for k_ in (31, 32, 33, 777):
        cases.append(("or_and", b8, (129, k_, 257), False))
    for k_ in (48, 256):
        cases.append(("or_and", b8, (256, k_, 128), False))
    for shape in shapes[:2]:
        cases += [("plus_times", bf16, shape, False),
                  ("plus_times", i32, shape, False),
                  ("plus_times", i64, shape, False),
                  ("plus_times", f64, shape, False),
                  ("min_plus", f64, shape, False),
                  ("max_min", f64, shape, False)]
    max_err = 0.0
    for i, (kind, dtype, (m, k, n), integers) in enumerate(cases):
        a, b = _smm_operands(kind, m, k, n, dtype, seed=100 + i,
                             integers=integers)
        got = smm.semiring_matmul(a, b, kind)
        want = smm.semiring_matmul_plain(a, b, kind)
        torch.cuda.synchronize()
        exact = kind != "plus_times" or integers or not dtype.is_floating_point
        try:
            err = _smm_compare(got, want, a, b, exact)
        except AssertionError as e:
            raise AssertionError(f"semiring_matmul {kind} {dtype} "
                                 f"{(m, k, n)}: {e}") from e
        max_err = max(max_err, err)
    # NaN and inf: min/max must propagate NaN as torch.minimum/maximum do,
    # and inf + (-inf) is NaN under min_plus
    for kind in ("min_plus", "max_min"):
        for dtype in (f32, f64):
            a, b = _smm_operands(kind, 1000, 777, 1531, dtype, seed=7)
            a[3, 5] = float("nan")
            a[7, :] = float("inf")
            b[:, 2] = -float("inf")
            b[4, 9] = float("nan")
            got = smm.semiring_matmul(a, b, kind)
            want = smm.semiring_matmul_plain(a, b, kind)
            if not bool(want.isnan().any()):
                raise AssertionError("the NaN case holds no NaN")
            _smm_compare(got, want, a, b, exact=True)
            cases.append((kind, dtype, (1000, 777, 1531), "nan/inf"))
    # ties of +0 and -0, compared with their signs
    for kind in ("min_plus", "max_min"):
        for dtype in (f32, f64):
            for m, k, n in ((129, 17, 257), (256, 64, 256)):
                a, b = _smm_signed_zeros(kind, m, k, n, dtype, seed=11)
                got = smm.semiring_matmul(a, b, kind)
                want = smm.semiring_matmul_plain(a, b, kind)
                zeros = want == 0
                if not (bool((zeros & want.signbit()).any())
                        and bool((zeros & ~want.signbit()).any())):
                    raise AssertionError("the signed-zero case holds not "
                                         "both zeros")
                try:
                    _smm_compare(got, want, a, b, exact=True)
                except AssertionError as e:
                    raise AssertionError(f"semiring_matmul {kind} {dtype} "
                                         f"{(m, k, n)} +-0 ties: {e}") from e
                cases.append((kind, dtype, (m, k, n), "+-0"))
    log(f"semiring_matmul: {len(cases)} cases match the plain version "
        f"(min_plus/max_min/or_and/integer sums bitwise, +-0 ties with "
        f"their signs; max abs err of random f32/bf16/f64 sums "
        f"{max_err:.3g}, within 2 K u |A||B|)")
    from repro_torch.kernels import _build
    smm_sass_counts(_build)

    # times at phase 4's shape, 2048^3, by kind, beside the bound
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    clock_hz = clock_mhz * 1e6
    log(f"bound: {sm_count} SMs at a max SM clock of {clock_mhz:.0f} MHz "
        f"(nvidia-smi); FP32 lanes 128/SM/clock -> "
        f"{sm_count * 128 * 2 * clock_hz / 1e12:.1f} TFLOP/s FMA (data-sheet "
        f"{F32_FLOPS / 1e12:.0f}); HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (torch.matmul in full f32)")
    m, k, n = SMM_MAIN
    times = {}
    for kind in ("plus_times", "min_plus", "max_min", "or_and"):
        dtype = b8 if kind == "or_and" else f32
        a, b = _smm_operands(kind, m, k, n, dtype, seed=1)
        ms = cuda_time_ms(lambda: smm.semiring_matmul(a, b, kind), iters=20)
        plain_ms = cuda_time_ms(
            lambda: smm.semiring_matmul_plain(a, b, kind), iters=5, warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(a, b), iters=20) \
            if kind == "plus_times" else None
        bound, by, t_ops, t_bytes = _smm_bound(kind, m, k, n, a.element_size(),
                                               sm_count, clock_hz)
        times[kind] = (ms, plain_ms, library_ms, bound, by)
        lib = f", torch.matmul {library_ms:.4f} ms" if library_ms else ""
        log(f"semiring_matmul {kind} {m}x{k}x{n} {dtype}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms{lib}; bound {bound:.4f} ms by {by} "
            f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), "
            f"{100 * bound / ms:.1f}% of it")
    ms, plain_ms, library_ms, bound, by = times["plus_times"]
    return {"name": "semiring_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/semiring_matmul.cu",
            "replaces": "src/repro/kernels/semiring_matmul.py:58",
            "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


# --------------------------------------------------------------------------
# phase 3: main path (masked triangle counting, R-MAT scale 15, 1x1 grid)
# --------------------------------------------------------------------------

def scipy_reference(shape, rows, cols):
    """Independent answer: the permutation of from_global_coo(seed=0)
    applied by hand, L = strict lower triangle, C = (L @ L) .* L."""
    import scipy.sparse as sp
    n = shape[0]
    rp = np.random.default_rng(0).permutation(n).astype(np.int64)
    r, c = rp[rows], rp[cols]
    a = sp.csr_matrix((np.ones(len(r), np.float32), (r, c)), shape=shape)
    low = sp.tril(a, k=-1).tocsr()
    cm = (low @ low).multiply(low).tocoo()
    cm.eliminate_zeros()
    return cm


def main_path():
    from repro_torch.apps.tricount import triangle_count
    from repro_torch.core.dist import DistSpMat, make_grid
    from repro_torch.core.mask import structural
    from repro_torch.core.matops import mat_apply_local, mat_select_lower
    from repro_torch.core.plan import spgemm
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.io.rmat import rmat_coo
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    t0 = time.perf_counter()
    shape, rows, cols, vals = rmat_coo(RMAT_SCALE, RMAT_EDGE_FACTOR,
                                       seed=RMAT_SEED, symmetrize=True,
                                       drop_self_loops=True)
    mesh = make_grid(1, 1, device="cuda")
    a = DistSpMat.from_global_coo(shape, rows, cols, vals, (1, 1), mesh=mesh,
                                  random_permute=True)
    log(f"R-MAT scale {RMAT_SCALE} ef {RMAT_EDGE_FACTOR}: {shape[0]} vertices, "
        f"nnz(A) {len(rows)}, cap {a.cap}; assembly "
        f"{time.perf_counter() - t0:.2f} s")
    GRID_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(GRID_DIR / "rmat15.npz", shape=np.asarray(shape), rows=rows,
             cols=cols, vals=vals)
    t0 = time.perf_counter()
    ref = scipy_reference(shape, rows, cols)
    ref_count = int(ref.sum())
    log(f"scipy: {ref_count} triangles, nnz(C) {ref.nnz}, max entry "
        f"{ref.data.max():.0f} ({time.perf_counter() - t0:.2f} s)")
    if ref_count != EXPECTED_TRIANGLES:
        raise AssertionError(f"scipy count {ref_count} != {EXPECTED_TRIANGLES}")

    t0 = time.perf_counter()
    cold = triangle_count(a, mesh=mesh)
    torch.cuda.synchronize()
    log(f"tricount cold: {cold} ({time.perf_counter() - t0:.3f} s)")

    # the main path: one warm call with the recorder off, timed on the
    # host clock, its launches counted from 0, by route
    torch.cuda.reset_peak_memory_stats()
    segreduce.launches = 0
    segreduce.route_launches.update(sorted=0, atomic=0)
    t0 = time.perf_counter()
    count = triangle_count(a, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segreduce.launches
    by_route = dict(segreduce.route_launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"tricount warm: {count} triangles, {wall:.4f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB, segreduce launches {launches} {by_route}")
    check_descents("phase 3's tricount")
    ONE_BY_ONE["tricount"] = (count, wall)
    if by_route["atomic"] or by_route["sorted"] != launches:
        raise AssertionError(f"tricount's segreduce launches by route "
                             f"{by_route}: not all sorted")
    # plan and spans from a separate recorded call (recording synchronizes
    # at each spgemm2d.execute span, so its times are not the wall above)
    with recorder.capture() as rec:
        recorded = triangle_count(a, mesh=mesh)
        plans = rec.events("plan.spgemm") + rec.events("plan.spgemm.done")
        snap = rec.snapshot()
    for p in plans:
        log(f"  {p['name']}: prod_cap {p['prod_cap']} out_cap {p['out_cap']} "
            f"variant {p['variant']} merge {p['merge']} "
            f"attempts {p['attempts']}")
    for site in ("tricount", "plan.spgemm", "spgemm2d", "spgemm2d.execute",
                 "merge.dedup", "merge.sort"):
        st = snap["spans"].get(site)
        if st:
            log(f"  span {site} (recorded call): n={st['count']} total "
                f"{st['total_us'] / 1e3:.3f} ms")
    if recorded != count:
        raise AssertionError(f"recorded call counted {recorded}, not {count}")
    if count != ref_count:
        raise AssertionError(f"triangle_count {count} != scipy {ref_count}")
    if launches <= 0:
        raise AssertionError("the main path launched no segreduce kernel")

    # C itself, entry by entry, against scipy under the same permutation
    ones = lambda t: t.apply(lambda v: torch.ones_like(v))
    low = mat_select_lower(mat_apply_local(a, ones, mesh=mesh), mesh=mesh)
    c, plan = spgemm(low, low, ARITHMETIC, mesh=mesh, mask=structural(low))
    cr, cc, cv = c.to_global_coo()
    got = np.lexsort((cc, cr))
    want = np.lexsort((ref.col, ref.row))
    if not (np.array_equal(cr[got], ref.row[want].astype(np.int64))
            and np.array_equal(cc[got], ref.col[want].astype(np.int64))
            and np.array_equal(cv[got].view(np.uint32),
                               ref.data[want].astype(np.float32)
                               .view(np.uint32))):
        raise AssertionError("C differs from scipy's (L @ L) .* L")
    log(f"C: {len(cr)} entries bitwise equal to scipy's, max {cv.max():.0f}; "
        f"plan attempts {plan.attempts}")
    profile_breakdown(lambda: triangle_count(a, mesh=mesh))
    # the segreduce calls of one more tricount, their inputs kept, then
    # timed one by one at those shapes
    calls = []
    inner = segreduce.segment_reduce

    def keep(values, seg_ids, num_segments, tag, **kw):
        calls.append((values.clone(), seg_ids.clone(), int(num_segments),
                      tag, kw))
        return inner(values, seg_ids, num_segments, tag, **kw)

    segreduce.segment_reduce = keep
    try:
        triangle_count(a, mesh=mesh)
    finally:
        segreduce.segment_reduce = inner
    if len(calls) != launches:
        raise AssertionError(f"recorded {len(calls)} segreduce calls, the "
                             f"warm call launched {launches}")
    log(f"segreduce at phase 3's {len(calls)} shapes (sorted route, device "
        f"time from torch.profiler):")
    total, bound, _ = time_main_path_calls(calls)
    log(f"segreduce a tricount: {total:.4f} ms of device time in "
        f"{len(calls)} launches, bound {bound:.4f} ms")
    check_descents("phase 3's recorded calls")
    return (launches, total, bound), a


def profile_breakdown(fn, top: int = 10) -> None:
    """Device time of one call by PyTorch operator (torch.profiler), the
    port's own kernels, and the share of the call's wall time the device
    was busy (kernels of one stream do not overlap, so their summed time is
    the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = prof.key_averages()
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    log(f"profile (one profiled call): wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)")
    ops = sorted(((e.self_device_time_total, e.count, e.key) for e in evs
                  if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    own = [(e.self_device_time_total, e.count, e.key) for e in kernels
           if any(name in e.key for name in KERNELS)]
    for us, n, name in ops[:top] + own:
        log(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:80]}")


# --------------------------------------------------------------------------
# phase 4: dense-accumulator local SpGEMM (R-MAT scale 11, ef 64)
# --------------------------------------------------------------------------

def _wall(fn):
    """Host-clock seconds of a warm ``fn()`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_tile(x, y) -> bool:
    """Two COO tiles equal bitwise: nnz, coordinates and values."""
    k = int(x.nnz)
    if k != int(y.nnz):
        return False
    return (torch.equal(x.row[:k], y.row[:k])
            and torch.equal(x.col[:k], y.col[:k])
            and torch.equal(x.val[:k].view(torch.uint8),
                            y.val[:k].view(torch.uint8)))


def dense_path() -> int:
    """Phase 4; returns the semiring_matmul launches of the four measured
    ``spgemm_auto`` calls (each must launch it exactly once)."""
    import scipy.sparse as sp
    from repro_torch.core import semiring as S
    from repro_torch.core.dist import DistSpMat
    from repro_torch.core.local_spgemm import spgemm_auto, spgemm_esc
    from repro_torch.core.plan import plan_local_spgemm
    from repro_torch.io.rmat import rmat_coo
    from repro_torch.kernels import segreduce
    from repro_torch.kernels import semiring_matmul as smm

    shape, rows, cols, vals = rmat_coo(DENSE_SCALE, DENSE_EDGE_FACTOR,
                                       seed=RMAT_SEED, symmetrize=True,
                                       drop_self_loops=True)
    a = DistSpMat.from_global_coo(shape, rows, cols, vals, (1, 1),
                                  device="cuda").tile()     # row-sorted
    nnz = int(a.nnz)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    ref2 = (ref @ ref).tocoo()
    log(f"R-MAT scale {DENSE_SCALE} ef {DENSE_EDGE_FACTOR}: {shape[0]} "
        f"vertices, nnz(A) {nnz} (tile cap {a.cap}, order {a.order}); "
        f"scipy A@A nnz {ref2.nnz}, max {ref2.data.max():.0f}")
    if (nnz, ref2.nnz, int(ref2.data.max())) != tuple(EXPECTED_DENSE.values()):
        raise AssertionError(f"graph differs from {EXPECTED_DENSE}")
    plan = plan_local_spgemm(a, a)
    log(f"plan_local_spgemm: {plan}")
    if plan.algo != "dense":
        raise AssertionError(f"planner took {plan.algo}, not dense")
    caps = dict(prod_cap=plan.prod_cap, out_cap=plan.out_cap)
    auto = dict(caps, algo=plan.algo)     # the plan's pick: no ratio read

    # the weighted semirings get integer weights 1..64 in entry order
    w = torch.zeros(a.cap, dtype=torch.float32, device="cuda")
    w[:nnz] = torch.as_tensor(np.random.default_rng(1).integers(
        1, 65, nnz).astype(np.float32), device="cuda")
    tiles = {"ARITHMETIC": a,
             "BOOLEAN": dataclasses.replace(a, val=a.val != 0),
             "MIN_PLUS": dataclasses.replace(a, val=w),
             "MAX_MIN": dataclasses.replace(a, val=w)}
    total = 0
    for name, t in tiles.items():
        sr = getattr(S, name)
        spgemm_auto(t, t, sr, **auto)                 # warm-up
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        before = smm.launches
        (c, ok), wall = _wall(lambda: spgemm_auto(t, t, sr, **auto))
        launched = smm.launches - before
        peak = torch.cuda.max_memory_allocated() - live
        total += launched
        if launched != 1:
            raise AssertionError(f"{name}: spgemm_auto launched "
                                 f"semiring_matmul {launched} times")
        if not bool(ok):
            raise AssertionError(f"{name}: spgemm_auto overflowed")
        seg_before = segreduce.launches
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        (e, eok), esc_wall = _wall(lambda: spgemm_esc(t, t, sr, **caps))
        esc_peak = torch.cuda.max_memory_allocated() - live
        if not bool(eok):
            raise AssertionError(f"{name}: spgemm_esc overflowed")
        if not _same_tile(c, e):
            raise AssertionError(f"{name}: dense and ESC results differ")
        k = int(c.nnz)
        r, cc, v = (x[:k].cpu().numpy() for x in (c.row, c.col, c.val))
        want = np.lexsort((ref2.col, ref2.row))
        if not (np.array_equal(r, ref2.row[want])
                and np.array_equal(cc, ref2.col[want])):
            raise AssertionError(f"{name}: pattern differs from scipy's")
        if name == "ARITHMETIC" and not np.array_equal(
                v.view(np.uint32), ref2.data[want].astype(np.float32)
                .view(np.uint32)):
            raise AssertionError("ARITHMETIC: values differ from scipy's")
        if name == "BOOLEAN" and not bool(v.all()):
            raise AssertionError("BOOLEAN: a stored entry is False")
        if name in ("MIN_PLUS", "MAX_MIN"):
            # the entries both paths visited, against the plain oracle on
            # the densified tiles
            kind = S._kernel_kind(sr)
            zero = sr.add.identity
            dense = smm.semiring_matmul_plain(t.to_dense(zero),
                                              t.to_dense(zero), kind)
            if not torch.equal(dense[c.row[:k].long(), c.col[:k].long()],
                               c.val[:k]):
                raise AssertionError(f"{name}: values differ from the "
                                     f"plain oracle")
            if int((dense != zero).sum()) != k:
                raise AssertionError(f"{name}: pattern differs from the "
                                     f"plain oracle")
        log(f"{name}: nnz(C) {k} bitwise equal to "
            f"{'scipy and ' if name == 'ARITHMETIC' else ''}the ESC path"
            f"{' and the plain oracle' if name in ('MIN_PLUS', 'MAX_MIN') else ''}"
            f"; spgemm_auto (dense) {wall * 1e3:.3f} ms warm, "
            f"1 semiring_matmul launch, {peak / 2**30:.3f} GiB above live "
            f"memory; spgemm_esc {esc_wall * 1e3:.3f} ms warm, "
            f"{segreduce.launches - seg_before} segreduce launches, "
            f"{esc_peak / 2**30:.3f} GiB above live memory")
    profile_breakdown(lambda: spgemm_auto(a, a, S.ARITHMETIC, **auto))
    check_descents("phase 4's ESC cross-check")
    return total


# --------------------------------------------------------------------------
# phase 5: local SpMV / SpMSpV on phase 3's tile
# --------------------------------------------------------------------------

def spmv_path(dist_a) -> int:
    """Phase 5; returns the segreduce launches of its measured calls."""
    import scipy.sparse as sp
    from repro_torch.core import semiring as S
    from repro_torch.core.plan import plan_local_spmspv
    from repro_torch.core.spmv_local import (spmspv_auto, spmv_col, spmv_row,
                                             spvec_to_dense)
    from repro_torch.kernels import segreduce

    a = dist_a.tile()
    m, n = a.shape
    k = int(a.nnz)
    r, c, v = (x[:k].cpu().numpy() for x in (a.row, a.col, a.val))
    ref = sp.csr_matrix((v, (r, c)), shape=(m, n))
    rng = np.random.default_rng(2)
    x = rng.integers(1, 9, n).astype(np.float32)
    want = ref @ x
    total = 0
    for fn in (spmv_row, spmv_col):
        xt = torch.as_tensor(x, device="cuda")
        fn(a, xt, S.ARITHMETIC)
        before = segreduce.launches
        routes = dict(segreduce.route_launches)
        y, wall = _wall(lambda: fn(a, xt, S.ARITHMETIC))
        launched = segreduce.launches - before
        total += launched
        if launched < 1:
            raise AssertionError(f"{fn.__name__} launched no segreduce")
        if not np.array_equal(y.cpu().numpy().view(np.uint32),
                              want.astype(np.float32).view(np.uint32)):
            raise AssertionError(f"{fn.__name__} differs from scipy's A @ x")
        log(f"{fn.__name__}: y bitwise equal to scipy's A @ x, "
            f"{wall * 1e3:.3f} ms warm, {launched} segreduce launches "
            f"{_route_delta(routes)}")
    ab = dataclasses.replace(a, val=a.val != 0)
    for density, expect in ((0.001, "sort"), (0.02, "bucket"),
                            (0.2, "spa")):
        f = round(density * n)
        idx = np.sort(rng.choice(n, f, replace=False)).astype(np.int32)
        xv = rng.integers(1, 9, f).astype(np.float32)
        xd = np.zeros(n, np.float32)
        xd[idx] = xv
        for name, tile, vals in (("ARITHMETIC", a, xv),
                                 ("BOOLEAN", ab, xv != 0)):
            sr = getattr(S, name)
            plan = plan_local_spmspv(tile, f)
            if plan.variant != expect:
                raise AssertionError(f"density {density}: planner took "
                                     f"{plan.variant}, not {expect}")
            xi_t = torch.as_tensor(idx, device="cuda")
            xv_t = torch.as_tensor(vals, device="cuda")
            caps = dict(prod_cap=plan.prod_cap, out_cap=plan.out_cap)
            spmspv_auto(tile, xi_t, xv_t, f, sr, **caps)
            before = segreduce.launches
            routes = dict(segreduce.route_launches)
            ((yi, yv, ynnz), ok), wall = _wall(
                lambda: spmspv_auto(tile, xi_t, xv_t, f, sr, **caps))
            if not bool(ok):
                raise AssertionError(f"spmspv {name} density {density} "
                                     f"overflows the planner's caps {caps}")
            launched = segreduce.launches - before
            total += launched
            y = spvec_to_dense(yi, yv, m, zero=sr.add.identity).cpu().numpy()
            ref_y = ref @ xd
            if name == "ARITHMETIC":
                same = np.array_equal(y.view(np.uint32),
                                      ref_y.astype(np.float32)
                                      .view(np.uint32))
            else:
                same = np.array_equal(y, ref_y > 0)
            if not same or launched < 1:
                raise AssertionError(f"spmspv {name} density {density}: "
                                     f"differs from scipy or no launch")
            log(f"spmspv_auto {name} density {density} (f={f}): variant "
                f"{plan.variant}, nnz(y) {int(ynnz)} bitwise equal to scipy, "
                f"{wall * 1e3:.3f} ms warm, {launched} segreduce launches "
                f"{_route_delta(routes)}, caps {caps}")
    check_descents("phase 5")
    return total


def _route_delta(before: dict) -> dict:
    """segreduce launches by route since ``before`` was taken."""
    from repro_torch.kernels import segreduce
    return {r: segreduce.route_launches[r] - before[r] for r in before}


# --------------------------------------------------------------------------
# phases 10-11: BFS and PageRank on R-MAT scale 20 (Graph500's shape)
# --------------------------------------------------------------------------

def graph500_graph():
    """R-MAT at GRAPH_SCALE (Graph500 a,b,c,d, edge factor 16, seed 0),
    symmetrized, no self loops, assembled with ``random_permute=True`` on
    the card's 1x1 grid. Returns (tile, mesh, scipy CSR of the permuted
    graph, seconds of host assembly)."""
    import scipy.sparse as sp
    from repro_torch.core.dist import DistSpMat, make_grid
    from repro_torch.io.rmat import rmat_coo

    t0 = time.perf_counter()
    shape, rows, cols, vals = rmat_coo(GRAPH_SCALE, GRAPH_EDGE_FACTOR,
                                       seed=RMAT_SEED, symmetrize=True,
                                       drop_self_loops=True)
    t_gen = time.perf_counter() - t0
    mesh = make_grid(1, 1, device="cuda")
    t0 = time.perf_counter()
    a = DistSpMat.from_global_coo(shape, rows, cols, vals, (1, 1), mesh=mesh,
                                  random_permute=True)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    # the permutation from_global_coo(seed=0) applies, by hand
    rp = np.random.default_rng(0).permutation(shape[0]).astype(np.int64)
    csr = sp.csr_matrix((vals.astype(np.float64), (rp[rows], rp[cols])),
                        shape=shape)
    # phase 17's ranks read the permuted graph
    GRID_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(GRID_DIR / "rmat20.npz", shape=np.asarray(shape),
             rows=rp[rows], cols=rp[cols], vals=vals)
    tile_bytes = sum(t.numel() * t.element_size()
                     for t in (a.row, a.col, a.val))
    log(f"R-MAT scale {GRAPH_SCALE} ef {GRAPH_EDGE_FACTOR}: {shape[0]} "
        f"vertices ({int((csr.getnnz(axis=1) == 0).sum())} isolated), "
        f"{len(rows)} stored entries, tile cap {a.cap} "
        f"({tile_bytes / 1e9:.3f} GB on the card); host assembly "
        f"{t_gen + t_asm:.2f} s (generator {t_gen:.2f} s, "
        f"from_global_coo {t_asm:.2f} s)")
    return a, mesh, csr, t_gen + t_asm


def _routes_zero():
    from repro_torch.kernels import segreduce
    segreduce.launches = 0
    segreduce.route_launches.update(sorted=0, atomic=0)


def bfs_phase(a, mesh, csr) -> dict:
    """Phase 10; returns the segreduce launches of the warm searches by
    route."""
    import scipy.sparse.csgraph as csgraph
    from repro_torch.apps import bfs_levels
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    deg = csr.getnnz(axis=1)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0),
                                            BFS_ROOTS, replace=False)
    total = {"sorted": 0, "atomic": 0}
    peak = 0
    ONE_BY_ONE["bfs"] = {"roots": roots.tolist(), "refs": [], "walls": []}
    for root in roots.tolist():
        t0 = time.perf_counter()
        ref = csgraph.shortest_path(csr, unweighted=True, indices=root)
        ref = np.where(np.isinf(ref), -1, ref).astype(np.int32)
        t_ref = time.perf_counter() - t0
        cold, cold_s = _wall(lambda: bfs_levels(a, root, mesh=mesh))
        torch.cuda.reset_peak_memory_stats()
        _routes_zero()
        warm, warm_s = _wall(lambda: bfs_levels(a, root, mesh=mesh))
        routes = dict(segreduce.route_launches)
        peak = max(peak, torch.cuda.max_memory_allocated())
        for k in total:
            total[k] += routes[k]
        with recorder.capture() as rec:
            recorded = bfs_levels(a, root, mesh=mesh)
            plans = rec.events("plan.spmspv")
            retried = rec.events("plan.spmspv.done")
        check_descents(f"phase 10, root {root}")
        for name, got in (("cold", cold), ("warm", warm),
                          ("recorded", recorded)):
            if got.shape != ref.shape or not np.array_equal(got, ref):
                bad = np.flatnonzero(got != ref)
                raise AssertionError(
                    f"BFS from {root} ({name}): {len(bad)} levels differ "
                    f"from scipy's, first at {bad[:5].tolist()}")
        ONE_BY_ONE["bfs"]["refs"].append(ref)
        ONE_BY_ONE["bfs"]["walls"].append(warm_s)
        reached = ref >= 0
        edges = int(deg[reached].sum()) // 2
        nlev = int(ref.max())
        variants = [p["variant"] for p in plans]
        if len(plans) != nlev + 1 or routes["sorted"] + routes["atomic"] < 1:
            raise AssertionError(f"BFS from {root}: {len(plans)} planned "
                                 f"levels for depth {nlev}, launches "
                                 f"{routes}")
        log(f"bfs root {root} (degree {deg[root]}): {int(reached.sum())} "
            f"vertices reached, depth {nlev}, levels bitwise equal to scipy "
            f"({t_ref:.2f} s); cold {cold_s * 1e3:.1f} ms, warm "
            f"{warm_s * 1e3:.1f} ms, {edges} undirected edges in the "
            f"component: {edges / warm_s:.6g} TEPS; variant per "
            f"level {variants}, caps "
            f"{[(p['prod_cap'], p['out_cap']) for p in plans]}, "
            f"levels retried {len(retried)}; segreduce launches {routes}")
    log(f"bfs: peak device memory {peak / 2**30:.3f} GiB; segreduce "
        f"launches of the {BFS_ROOTS} warm searches {total}")
    log(f"profile of one warm search (root {roots[0]}):")
    profile_breakdown(lambda: bfs_levels(a, int(roots[0]), mesh=mesh))
    check_descents("phase 10's profiled search")
    return total


def pagerank_reference(csr, alpha, tol=1e-12, max_iters=1000):
    """The same formula in float64 with scipy, to convergence: A[dst, src]
    (the graph is symmetric), columns scaled by 1/out-degree, the dangling
    vertices' mass spread evenly, teleport (1-alpha)/n, L1-normalized."""
    import scipy.sparse as sp
    n = csr.shape[0]
    out_deg = np.asarray(csr.sum(axis=0)).ravel()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1e-300), 0.0)
    p = (csr.T @ sp.diags(inv)).tocsr()
    dangling = out_deg == 0
    r = np.full(n, 1.0 / n)
    for it in range(1, max_iters + 1):
        r_new = alpha * (p @ r + r[dangling].sum() / n) + (1 - alpha) / n
        delta = np.abs(r_new - r).sum()
        r = r_new
        if delta < tol:
            break
    return r / r.sum(), it


def pagerank_phase(a, mesh, csr) -> dict:
    """Phase 11; returns the segreduce launches of the warm run by route."""
    from repro_torch.apps import pagerank
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    t0 = time.perf_counter()
    ref, ref_iters = pagerank_reference(csr, PR_ALPHA)
    log(f"pagerank reference (scipy, float64): {ref_iters} iterations to "
        f"L1 change < 1e-12 ({time.perf_counter() - t0:.2f} s)")
    kw = dict(mesh=mesh, alpha=PR_ALPHA, tol=PR_TOL, max_iters=PR_MAX_ITERS)
    cold, cold_s = _wall(lambda: pagerank(a, **kw))
    torch.cuda.reset_peak_memory_stats()
    _routes_zero()
    warm, warm_s = _wall(lambda: pagerank(a, **kw))
    routes = dict(segreduce.route_launches)
    peak = torch.cuda.max_memory_allocated()
    with recorder.capture() as rec:
        recorded = pagerank(a, **kw)
        it_span = rec.snapshot()["spans"]["pagerank.iter"]
    check_descents("phase 11")
    iters = it_span["count"]
    ONE_BY_ONE["pagerank"] = (ref, warm_s, iters)
    errs = [float(np.abs(r.astype(np.float64) - ref).sum())
            for r in (cold, warm, recorded)]
    log(f"pagerank alpha {PR_ALPHA} tol {PR_TOL} max_iters {PR_MAX_ITERS}: "
        f"{iters} iterations; L1 to the float64 reference {errs[1]:.3g} "
        f"(cold {errs[0]:.3g}, recorded {errs[2]:.3g}; limit {PR_L1_TOL}); "
        f"cold {cold_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms "
        f"({warm_s / iters * 1e3:.3f} ms an iteration, set-up included; the "
        f"recorded run's pagerank.iter span median "
        f"{it_span['p50_us'] / 1e3:.3f} ms); peak device memory "
        f"{peak / 2**30:.3f} GiB; segreduce launches {routes}")
    if not all(np.isfinite(r).all() and r.shape == ref.shape
               for r in (cold, warm, recorded)):
        raise AssertionError("pagerank: non-finite ranks or a wrong shape")
    if max(errs) > PR_L1_TOL:
        raise AssertionError(f"pagerank: L1 {max(errs)} to the reference "
                             f"exceeds {PR_L1_TOL}")
    # the out-degrees on the atomic route, one spmv_row an iteration on
    # the sorted one
    if routes != {"sorted": iters, "atomic": 1}:
        raise AssertionError(f"pagerank: segreduce launches {routes}, not "
                             f"{iters} sorted and 1 atomic")
    log("profile of one warm pagerank:")
    profile_breakdown(lambda: pagerank(a, **kw))
    check_descents("phase 11's profiled run")
    return routes


# --------------------------------------------------------------------------
# phases 12-15: FastSV, maximal matching and SpMM on phase 10's graph;
# HipMCL on a planted protein-family network read through the LABEL reader
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _calls(owner, name, keep=lambda out: None, static=False):
    """Time each call of ``owner.<name>`` (synchronized on both sides) while
    the block runs; yields the list of (seconds, keep(result))."""
    orig = getattr(owner, name)
    seen = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        seen.append((time.perf_counter() - t0, keep(out)))
        return out

    setattr(owner, name, staticmethod(timed) if static else timed)
    try:
        yield seen
    finally:
        setattr(owner, name, staticmethod(orig) if static else orig)


@contextlib.contextmanager
def _segreduce_calls():
    """Record segreduce's calls while the block runs, by shape (route,
    dtype, tag, N, D, S): the first call's inputs (cloned) and the number
    of calls. Yields the record, a dict."""
    from repro_torch.kernels import segreduce
    inner = segreduce.segment_reduce
    shapes = {}

    def keep(values, seg_ids, num_segments, tag, **kw):
        d = math.prod(values.shape[1:])
        key = (segreduce.route(values.dtype, d, kw.get("sorted_ids", False)),
               values.dtype, tag, seg_ids.shape[0], d, int(num_segments))
        if key not in shapes:
            shapes[key] = [(values.clone(), seg_ids.clone(),
                            int(num_segments), tag, kw), 0]
        shapes[key][1] += 1
        return inner(values, seg_ids, num_segments, tag, **kw)

    segreduce.segment_reduce = keep
    try:
        yield shapes
    finally:
        segreduce.segment_reduce = inner


def check_segreduce_calls(shapes, what: str) -> dict:
    """Hold segreduce at each shape ``_segreduce_calls`` recorded against
    the plain version and time it (``time_main_path_calls``, the first
    call's inputs standing for its shape's calls), then free the inputs;
    returns the recorded calls by route."""
    calls = [rec[0] for rec in shapes.values()]
    counts = [rec[1] for rec in shapes.values()]
    log(f"{what}: {sum(counts)} segreduce calls at {len(calls)} shapes; each "
        f"shape's first call again, against the plain version, timed:")
    ms, bound, err = time_main_path_calls(calls, counts)
    log(f"{what}: segreduce {ms:.4f} ms of device time, bound {bound:.4f} "
        f"ms (each shape's first call times its calls); max abs err {err:.3g}")
    routes = {"sorted": 0, "atomic": 0}
    for (route, *_), (_, k) in shapes.items():
        routes[route] += k
    shapes.clear()
    return routes


def _per_iter(routes: dict, iters: int) -> dict:
    return {k: round(v / max(iters, 1), 3) for k, v in routes.items()}


def fastsv_phase(a, mesh, csr) -> dict:
    """Phase 12; returns the segreduce launches of the warm run by route."""
    import scipy.sparse.csgraph as csgraph
    from repro_torch.apps import fastsv
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    n = csr.shape[0]
    t0 = time.perf_counter()
    ncc, comp = csgraph.connected_components(csr, directed=False)
    smallest = np.full(ncc, n, np.int64)
    np.minimum.at(smallest, comp, np.arange(n))
    ref = smallest[comp]           # min-hooking from arange ends here
    t_ref = time.perf_counter() - t0
    cold, cold_s = _wall(lambda: fastsv(a, mesh=mesh))
    torch.cuda.reset_peak_memory_stats()
    _routes_zero()
    warm, warm_s = _wall(lambda: fastsv(a, mesh=mesh))
    routes = dict(segreduce.route_launches)
    peak = torch.cuda.max_memory_allocated()
    with recorder.capture() as rec, _segreduce_calls() as seg, \
            _calls(sys.modules["repro_torch.apps.fastsv"], "extract") as ext:
        recorded = fastsv(a, mesh=mesh)
        it_span = rec.snapshot()["spans"]["fastsv.iter"]
    check_descents("phase 12")
    iters = it_span["count"]
    ONE_BY_ONE["fastsv"] = (ref, warm_s, iters)
    sweeps = len(ext) - iters     # one extract a hooking iteration
    for name, got in (("cold", cold), ("warm", warm), ("recorded", recorded)):
        if got.shape != ref.shape or not np.array_equal(got, ref):
            bad = np.flatnonzero(got != ref)
            raise AssertionError(
                f"fastsv ({name}): {len(bad)} labels differ from each "
                f"component's smallest vertex (scipy), first at "
                f"{bad[:5].tolist()}")
    log(f"fastsv: {ncc} components (scipy {t_ref:.2f} s), labels equal to "
        f"each component's smallest vertex id in the cold, warm and "
        f"recorded runs; {iters} hooking iterations, {sweeps} "
        f"pointer-jumping sweeps; cold {cold_s * 1e3:.1f} ms, warm "
        f"{warm_s * 1e3:.1f} ms ({warm_s / iters * 1e3:.3f} ms an "
        f"iteration, sweeps and set-up included; the recorded run's "
        f"fastsv.iter span median {it_span['p50_us'] / 1e3:.3f} ms); peak "
        f"device memory {peak / 2**30:.3f} GiB; segreduce launches {routes}, "
        f"{_per_iter(routes, iters)} an iteration")
    # an iteration: spmv_row (sorted), assign's min merge and touch count
    # (atomic); the sweeps run extract alone
    if routes != {"sorted": iters, "atomic": 2 * iters}:
        raise AssertionError(f"fastsv: segreduce launches {routes}, not "
                             f"{iters} sorted and {2 * iters} atomic")
    seen = check_segreduce_calls(seg, "fastsv, the recorded run")
    if seen != routes:
        raise AssertionError(f"fastsv: the recorded run called segreduce "
                             f"{seen}, the warm run launched {routes}")
    log("profile of one warm fastsv:")
    profile_breakdown(lambda: fastsv(a, mesh=mesh))
    check_descents("phase 12's profiled run")
    return routes


def check_matching(mr, mc, csr) -> int:
    """Raise unless (mate_row, mate_col) is a consistent matching on the
    stored entries of ``csr`` and maximal; returns its cardinality."""
    rows = np.flatnonzero(mr >= 0)
    cols = np.flatnonzero(mc >= 0)
    if len(rows) != len(cols) or not np.array_equal(mc[mr[rows]], rows) \
            or not np.array_equal(mr[mc[cols]], cols):
        raise AssertionError("matching: mate_row and mate_col disagree")
    if len(rows) and not (np.asarray(csr[rows, mr[rows]]).ravel() != 0).all():
        raise AssertionError("matching: a matched pair is not an edge")
    coo = csr.tocoo()
    free = (mr[coo.row] < 0) & (mc[coo.col] < 0)
    if free.any():
        k = int(np.flatnonzero(free)[0])
        raise AssertionError(f"matching: not maximal, edge ({coo.row[k]}, "
                             f"{coo.col[k]}) joins two unmatched vertices")
    return len(rows)


def matching_phase(a, mesh, csr) -> dict:
    """Phase 13: phase 10's matrix read as a bipartite graph (rows and
    columns two vertex sets); returns the warm run's segreduce launches."""
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from repro_torch.apps import maximal_matching
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    run = lambda: maximal_matching(a, mesh=mesh,                # noqa: E731
                                   max_iters=MATCH_MAX_ITERS)
    (cold_r, cold_c), cold_s = _wall(run)
    torch.cuda.reset_peak_memory_stats()
    _routes_zero()
    (mr, mc), warm_s = _wall(run)
    routes = dict(segreduce.route_launches)
    peak = torch.cuda.max_memory_allocated()
    with recorder.capture() as rec, _segreduce_calls() as seg:
        rec_r, rec_c = run()
        passes = rec.snapshot()["spans"]["spmv"]["count"]
    check_descents("phase 13")
    if passes >= MATCH_MAX_ITERS:
        raise AssertionError(f"matching: no fixed point in {passes} passes")
    iters = passes - 1           # the last pass finds no proposal
    for got in (cold_r, rec_r):
        if not np.array_equal(got, mr):
            raise AssertionError("matching: runs of one input differ")
    if not (np.array_equal(cold_c, mc) and np.array_equal(rec_c, mc)):
        raise AssertionError("matching: runs of one input differ")
    t0 = time.perf_counter()
    card = check_matching(mr, mc, csr)
    t_check = time.perf_counter() - t0
    ONE_BY_ONE["matching"] = (card, warm_s, passes)
    t0 = time.perf_counter()
    best = int((maximum_bipartite_matching(csr, perm_type="column")
                >= 0).sum())
    t_max = time.perf_counter() - t0
    log(f"matching (max_iters {MATCH_MAX_ITERS}): {iters} iterations to the "
        f"fixed point ({passes} SpMV passes); {card} pairs, consistent and "
        f"maximal ({t_check:.2f} s to check); maximum matching (scipy "
        f"maximum_bipartite_matching, {t_max:.2f} s) {best}: ratio "
        f"{card / best:.4f}; cold {cold_s * 1e3:.1f} ms, warm "
        f"{warm_s * 1e3:.1f} ms ({warm_s / passes * 1e3:.3f} ms a pass); "
        f"peak device memory {peak / 2**30:.3f} GiB; segreduce launches "
        f"{routes}, {_per_iter(routes, passes)} a pass")
    if 2 * card < best:
        raise AssertionError("matching: below half the maximum, so not "
                             "maximal")
    # a pass: spmv_col's scatter (atomic); a matching iteration adds
    # assign's max merge and touch count (atomic)
    if routes != {"sorted": 0, "atomic": passes + 2 * iters}:
        raise AssertionError(f"matching: segreduce launches {routes}, not "
                             f"{passes + 2 * iters} atomic")
    seen = check_segreduce_calls(seg, "matching, the recorded run")
    if seen != routes:
        raise AssertionError(f"matching: the recorded run called segreduce "
                             f"{seen}, the warm run launched {routes}")
    log("profile of one warm matching:")
    profile_breakdown(run)
    return routes


def spmm_phase(a, mesh, csr) -> dict:
    """Phase 15: ``spmm_15d`` and ``spmm_2d`` with X of SPMM_K f32 columns;
    returns the segreduce launches of one call by route."""
    from repro_torch.core import spmm_15d, spmm_2d
    from repro_torch.core.dist import DistVec
    from repro_torch.core.semiring import MAX_PLUS
    from repro_torch.kernels import segreduce

    n = csr.shape[0]
    x_np = np.random.default_rng(0).standard_normal((n, SPMM_K)) \
        .astype(np.float32)
    x = DistVec.from_global(x_np, (1, 1), layout="col", mesh=mesh)
    xt = x.data.reshape(n, SPMM_K)
    _routes_zero()
    y = spmm_15d(a, x, mesh=mesh)
    torch.cuda.synchronize()
    routes = dict(segreduce.route_launches)
    check_descents("phase 15")
    y_np = y.to_global().astype(np.float64)
    x64 = x_np.astype(np.float64)
    ref = csr @ x64
    scale = abs(csr) @ np.abs(x64)
    # recursive f32 summation in any order (the atomic route's): |error|
    # <= gamma_(terms - 1) sum|terms|, gamma_k = k u / (1 - k u), u = 2^-24
    # (Higham, Accuracy and Stability, Thm 4.4); unit values make the
    # products exact
    ku = np.maximum(csr.getnnz(axis=1) - 1, 1)[:, None] * 2.0**-24
    bound = ku / (1 - ku) * scale
    worst = float((np.abs(y_np - ref) / np.maximum(bound, 1e-300)).max())
    if not np.isfinite(y_np).all() or worst > 1.0:
        raise AssertionError(f"spmm: error {worst:.4f} x the f32 summation "
                             f"bound (per row, gamma_(deg-1) |A||X|)")
    y2 = spmm_2d(a, xt, mesh=mesh)
    diff = int((y2 != y.data.reshape(y2.shape)).sum())
    if (np.abs(y2.cpu().numpy().astype(np.float64) - ref) > bound).any():
        raise AssertionError("spmm_2d: outside the f32 summation bound")
    ym = spmm_15d(a, x, MAX_PLUS, mesh=mesh)
    if not torch.equal(spmm_2d(a, xt, MAX_PLUS, mesh=mesh),
                       ym.data.reshape(y2.shape)):
        raise AssertionError("spmm_2d and spmm_15d differ under MAX_PLUS")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: spmm_15d(a, x, mesh=mesh), iters=10)
    peak = torch.cuda.max_memory_allocated()
    ONE_BY_ONE["spmm"] = ms
    # the function: A's live (row, col, val) and X read once, Y written
    call_bytes = int(a.nnz.sum()) * 12 + 2 * n * SPMM_K * 4
    log(f"spmm_15d (k = {SPMM_K}, f32): within the f32 summation bound "
        f"(worst row at {worst:.4f} of it); spmm_2d within it too, {diff} "
        f"of {y2.numel()} entries differ from spmm_15d in the last bits "
        f"(atomic f32 adds in any order), bitwise equal under MAX_PLUS; "
        f"segreduce route {segreduce.route(torch.float32, SPMM_K, True)} "
        f"(vector values), launches {routes} a call; {ms:.3f} ms a call "
        f"(CUDA events, 10 calls) against a bytes bound of "
        f"{call_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({call_bytes / 1e9:.3f}"
        f" GB: A's live entries, X and Y once); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if routes != {"sorted": 0, "atomic": 1}:
        raise AssertionError(f"spmm: segreduce launches {routes}, not 1 "
                             f"atomic")
    with _segreduce_calls() as seg:
        spmm_15d(a, x, mesh=mesh)
    seen = check_segreduce_calls(seg, "spmm_15d")
    if seen != routes:
        raise AssertionError(f"spmm: a call called segreduce {seen}, the "
                             f"first launched {routes}")
    log("profile of one spmm_15d:")
    profile_breakdown(lambda: spmm_15d(a, x, mesh=mesh))
    return routes


def planted_families(n, fam_lo, fam_hi, p_in, cross_per, seed=0):
    """A protein-similarity network with planted families, vectorized:
    families of fam_lo..fam_hi proteins (uniform; the last one takes what
    is left of n), pairs within a family linked with probability ``p_in``
    at weights in [0.5, 1), about ``cross_per`` links a protein across
    families at weights in [0.01, 0.05), unit self-loops. Returns (family
    of each protein, rows, cols, weights), each link in both directions."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(fam_lo, fam_hi + 1, n // fam_lo + 1)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), n) + 1]
    sizes[-1] -= int(sizes.sum()) - n
    starts = np.cumsum(sizes) - sizes
    family = np.repeat(np.arange(len(sizes)), sizes)
    us, vs = [], []
    for s in np.unique(sizes):
        iu, ju = np.triu_indices(int(s), 1)
        base = starts[sizes == s][:, None]
        us.append((base + iu).ravel())
        vs.append((base + ju).ravel())
    u, v = np.concatenate(us), np.concatenate(vs)
    keep = rng.random(len(u)) < p_in
    u, v = u[keep], v[keep]
    w_in = rng.uniform(0.5, 1.0, len(u))
    m = int(round(cross_per * n / 2))
    cu, cv = rng.integers(0, n, m), rng.integers(0, n, m)
    other = family[cu] != family[cv]
    cu, cv = np.minimum(cu[other], cv[other]), np.maximum(cu[other], cv[other])
    _, first = np.unique(cu * n + cv, return_index=True)
    first.sort()
    cu, cv = cu[first], cv[first]
    w_x = rng.uniform(0.01, 0.05, len(cu))
    loops = np.arange(n)
    rows = np.concatenate([u, cu, v, cv, loops]).astype(np.int64)
    cols = np.concatenate([v, cv, u, cu, loops]).astype(np.int64)
    w = np.concatenate([w_in, w_x])
    return family, rows, cols, np.concatenate([w, w, np.ones(n)])


def write_label_file(path, rows, cols, vals) -> int:
    """The network in the MCL LABEL format (``PROT_%06d``, tab-separated,
    one line an entry); returns the bytes written."""
    lines = [f"PROT_{r:06d}\tPROT_{c:06d}\t{w:.6g}"
             for r, c, w in zip(rows.tolist(), cols.tolist(), vals.tolist())]
    data = ("\n".join(lines) + "\n").encode()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(data)
    return len(data)


def _normalize_cols64(c):
    import scipy.sparse as sp
    s = np.asarray(c.sum(axis=0)).ravel()
    inv = np.where(s > 0, 1.0 / np.maximum(s, 1e-300), 0.0)
    return (c @ sp.diags(inv)).tocsr()


def _keep_above(c, threshold):
    c = c.tocsr()
    c.data[c.data <= threshold] = 0
    c.eliminate_zeros()
    return c


def mcl_reference(a, inflation=2.0, prune=1e-4, max_iters=20, tol=1e-5):
    """``hipmcl``'s steps in float64 with scipy: normalize; then each
    iteration the expansion C·C with entries <= prune dropped, inflation,
    normalize, prune, normalize, and the chaos sum of squares, stopping
    when it changes by less than ``tol``; clusters are the connected
    components of the symmetrized attractor pattern. Returns (labels,
    iterations, nnz of each iterate)."""
    import scipy.sparse.csgraph as csgraph
    c = _normalize_cols64(a.astype(np.float64).tocsr())
    prev, nnz = np.nan, []
    for it in range(1, max_iters + 1):
        c2 = _keep_above(c @ c, prune).power(inflation)
        c2 = _normalize_cols64(_keep_above(_normalize_cols64(c2), prune))
        chaos = float((c2.data ** 2).sum())
        c, done = c2, (not np.isnan(prev)) and abs(chaos - prev) < tol
        prev = chaos
        nnz.append(c.nnz)
        if done:
            break
    _, labels = csgraph.connected_components(c + c.T, directed=False)
    return labels, it, nnz


def same_partition(a, b) -> bool:
    """Whether two labelings induce the same partition."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    pairs = np.unique(a * (int(b.max()) + 1) + b)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def purity(labels, truth) -> float:
    """Σ over clusters of its largest planted family's share of it."""
    nf = int(truth.max()) + 1
    pairs, counts = np.unique(labels.astype(np.int64) * nf + truth,
                              return_counts=True)
    best = np.zeros(int(labels.max()) + 1, np.int64)
    np.maximum.at(best, pairs // nf, counts)
    return float(best.sum() / len(labels))


def hipmcl_phase(mesh) -> dict:
    """Phase 14; returns the segreduce launches of the cold run by route."""
    import scipy.sparse as sp
    from repro_torch.apps import hipmcl
    from repro_torch.core.dist import DistSpMat
    from repro_torch.io import read_generalized_tuples
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    n = HIPMCL_PROTEINS
    t0 = time.perf_counter()
    family, rows, cols, vals = planted_families(n, *HIPMCL_FAMILY,
                                                HIPMCL_P_IN, HIPMCL_CROSS)
    path = ROOT / "build" / "hipmcl_planted.lbl"
    nbytes = write_label_file(path, rows, cols, vals)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape, r, c, v, labels = read_generalized_tuples(str(path), 4)
    t_read = time.perf_counter() - t0
    truth = family[np.array([int(lb[5:]) for lb in labels])]
    t0 = time.perf_counter()
    a = DistSpMat.from_global_coo(shape, r, c, v.astype(np.float32), (1, 1),
                                  mesh=mesh)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    log(f"hipmcl network: {n} proteins in {family.max() + 1} families of "
        f"{HIPMCL_FAMILY[0]}-{HIPMCL_FAMILY[1]}, {len(rows)} entries "
        f"({nbytes / 1e6:.1f} MB of LABEL file, {t_gen:.2f} s to make); "
        f"read_generalized_tuples {t_read:.2f} s, from_global_coo "
        f"{t_asm:.2f} s (cap {a.cap})")
    t0 = time.perf_counter()
    ref, ref_iters, ref_nnz = mcl_reference(
        sp.csr_matrix((v, (r, c)), shape=shape))
    log(f"hipmcl reference (scipy, float64): {ref_iters} iterations, "
        f"{len(np.unique(ref))} clusters, iterate nnz {ref_nnz} "
        f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.reset_peak_memory_stats()
    _routes_zero()
    cold, cold_s = _wall(lambda: hipmcl(a, mesh=mesh))
    routes = dict(segreduce.route_launches)
    peak = torch.cuda.max_memory_allocated()
    check_descents("phase 14")
    _routes_zero()
    with recorder.capture() as rec, _segreduce_calls() as seg, \
            _calls(DistSpMat, "to_global_coo",
                   keep=lambda out: len(out[0])) as packs, \
            _calls(DistSpMat, "from_global_coo", static=True) as unpacks:
        recorded, rec_s = _wall(lambda: hipmcl(a, mesh=mesh))
        plans = rec.events("plan.spgemm")
        retries = rec.events("plan.overflow_retry")
        spans = rec.snapshot()["spans"]
    rec_routes = dict(segreduce.route_launches)
    # phase 21 resumes a crashed run of this network to these labels
    ONE_BY_ONE["hipmcl"] = (shape, r, c, v.astype(np.float32), cold)
    iters = spans["hipmcl.iter"]["count"]
    fsv_iters = spans["fastsv.iter"]["count"]
    for name, got in (("cold", cold), ("recorded", recorded)):
        if not same_partition(got, ref):
            raise AssertionError(
                f"hipmcl ({name}): {len(np.unique(got))} clusters, not the "
                f"float64 reference's partition ({len(np.unique(ref))})")
    # pack of iteration i is packs[i + 1] (packs[0]: the normalized input);
    # the unpack that starts it, unpacks[i]
    trip = [packs[i + 1][0] + unpacks[i][0] for i in range(iters)]
    log(f"hipmcl (inflation 2.0, prune 1e-4, tol 1e-5, at most 20 "
        f"iterations): {iters} iterations (reference {ref_iters}), "
        f"{len(np.unique(cold))} clusters, the reference's partition in the "
        f"cold and recorded runs, purity {purity(cold, truth):.4f} against "
        f"the planted families; cold {cold_s:.2f} s, recorded {rec_s:.2f} s; "
        f"host round trip (to_global_coo + from_global_coo) "
        f"{sum(trip):.2f} s of the recorded run ({100 * sum(trip) / rec_s:.1f}"
        f"%); peak device memory {peak / 2**30:.3f} GiB; segreduce launches "
        f"{routes}; overflow retries {len(retries)}")
    for i in range(iters):
        p = plans[i]
        log(f"  iteration {i}: prod_cap {p['prod_cap']}, out_cap "
            f"{p['out_cap']}, merge {p['merge']}, iterate nnz "
            f"{packs[i + 1][1]}, round trip {trip[i] * 1e3:.1f} ms")
    # atomic: each column normalization (one before the loop, two an
    # iteration) and FastSV's assign (two an iteration); sorted: the final
    # union's, one a FastSV iteration and each expansion's merge, which
    # makes one call or, where the merge engine folds windows, more
    atomic = 1 + 2 * iters + 2 * fsv_iters
    if routes["atomic"] != atomic or \
            routes["sorted"] < iters + 1 + fsv_iters:
        raise AssertionError(f"hipmcl: segreduce launches {routes}, not "
                             f"{atomic} atomic and at least "
                             f"{iters + 1 + fsv_iters} sorted ({iters} "
                             f"iterations, {fsv_iters} of FastSV)")
    seen = check_segreduce_calls(seg, "hipmcl, the recorded run")
    if not seen == rec_routes == routes:
        raise AssertionError(f"hipmcl: the recorded run called segreduce "
                             f"{seen} and launched {rec_routes}, the cold "
                             f"run launched {routes}")
    log("profile of one warm hipmcl iteration (max_iters=1: normalize, one "
        "expansion, the final FastSV):")
    profile_breakdown(lambda: hipmcl(a, mesh=mesh, max_iters=1))
    check_descents("phase 14's profiled run")
    return routes


# --------------------------------------------------------------------------
# phases 16-19: the 2x2 grid, four ranks (processes) sharing the card
# --------------------------------------------------------------------------

def _digest(*arrays) -> str:
    import hashlib
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _smm_calls():
    """Record semiring_matmul's calls while the block runs, by (kind,
    dtype, A's shape, B's shape): the first call's operands (cloned) and
    the number of calls. Yields the record, a dict."""
    from repro_torch.kernels import semiring_matmul as smm
    inner = smm.semiring_matmul
    shapes = {}

    def keep(a, b, kind="plus_times"):
        key = (kind, a.dtype, tuple(a.shape), tuple(b.shape))
        if key not in shapes:
            shapes[key] = [(a.clone(), b.clone(), kind), 0]
        shapes[key][1] += 1
        return inner(a, b, kind)

    smm.semiring_matmul = keep
    try:
        yield shapes
    finally:
        smm.semiring_matmul = inner


def _hold_rank_calls(seg, mm, routes) -> dict:
    """Hold every segreduce shape a rank's run recorded against the plain
    version and time it (``_hold_call``, the first call's inputs standing
    for its shape's calls), and every semiring_matmul shape against its
    plain version; fails unless the held calls are all the run's launches
    by route. Frees the recorded inputs."""
    from repro_torch.kernels import semiring_matmul as smm
    shapes, held = [], {"sorted": 0, "atomic": 0}
    for (vals, ids, s, tag, kw), k in seg.values():
        h = _hold_call(vals, ids, s, tag, kw)
        shapes.append((k, h))
        if h["route"] == "atomic" or s > 0:       # a sorted S = 0 is no launch
            held[h["route"]] += k
    seg.clear()
    if held != routes:
        raise AssertionError(f"held segreduce calls {held}, the run's "
                             f"launches {routes}")
    mm_err, mm_calls = 0.0, 0
    for (a, b, kind), k in mm.values():
        exact = kind != "plus_times" or not a.dtype.is_floating_point
        mm_err = max(mm_err, _smm_compare(smm.semiring_matmul(a, b, kind),
                                          smm.semiring_matmul_plain(a, b,
                                                                    kind),
                                          a, b, exact))
        if a.shape[0] and b.shape[1]:          # an empty C launches nothing
            mm_calls += k
    mm.clear()
    return {"shapes": shapes, "ms": sum(k * h["ms"] for k, h in shapes),
            "bound": sum(k * h["bound"] for k, h in shapes),
            "err": max((h["err"] for _, h in shapes), default=0.0),
            "smm_calls": mm_calls, "smm_err": mm_err}


class _Wall:
    """A measured run: the wall, the peak memory and the exchange
    accounting (``core/comm.py``) from 0 here."""

    def __init__(self, mesh):
        from repro_torch.core import comm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comm.reset_stats()
        self.t0 = time.perf_counter()

    def done(self, **rec) -> dict:
        from repro_torch.core import comm
        torch.cuda.synchronize()
        rec.update(wall=time.perf_counter() - self.t0,
                   peak=torch.cuda.max_memory_allocated(),
                   comm=copy.deepcopy(comm.stats))
        return rec


class _RankRun(_Wall):
    """One measured run on one rank (``_Wall``) that also counts
    segreduce's launches by route and semiring_matmul's from 0 here and
    records both kernels' calls by shape. ``done()`` reads the counts back
    with the wall, then holds the recorded calls (``_hold_rank_calls``),
    one rank at a time so that no other rank's work shares the card while
    a kernel is timed."""

    def __init__(self, mesh):
        from repro_torch.kernels import semiring_matmul as smm
        self.grid = (mesh.pr, mesh.pc) if mesh.layers == 1 else \
            (mesh.layers, mesh.pr, mesh.pc)
        self._seg, self._mm = _segreduce_calls(), _smm_calls()
        _routes_zero()
        smm.launches = 0
        self.seg, self.mm = self._seg.__enter__(), self._mm.__enter__()
        super().__init__(mesh)

    def done(self, **rec) -> dict:
        from repro_torch.core import comm
        from repro_torch.core.dist import grid_all
        from repro_torch.kernels import segreduce
        from repro_torch.kernels import semiring_matmul as smm
        rec = super().done(**rec)
        rec.update(routes=dict(segreduce.route_launches), smm=smm.launches)
        self._seg.__exit__(None, None, None)
        self._mm.__exit__(None, None, None)
        g = comm.of(self.grid)
        turn = torch.ones(1, dtype=torch.bool, device="cuda")
        for rk in range(g.size(comm.WORLD)):
            if rk == g.rank:
                rec["held"] = _hold_rank_calls(self.seg, self.mm,
                                               rec["routes"])
            grid_all(turn, self.grid)         # the next rank's turn
        rec["descents"] = bool(segreduce.descents())
        return rec


def _grid_tricount(mesh) -> dict:
    """Phase 16 on a rank: phase 3's graph, the planner's pick, then each
    schedule (rotate with overlap on and off, alltoall, bcast); then (c)
    the batched product and (d) int8 compression on MCL's expansion."""
    from repro_torch.apps.tricount import triangle_count
    from repro_torch.core import comm
    from repro_torch.core.dist import DistSpMat
    from repro_torch.core.mask import structural
    from repro_torch.core.matops import (mat_apply_local, mat_select_lower,
                                         mat_sum)
    from repro_torch.core.plan import plan_spgemm, spgemm
    from repro_torch.core.semiring import ARITHMETIC

    z = np.load(GRID_DIR / "rmat15.npz")
    shape = tuple(int(x) for x in z["shape"])
    t0 = time.perf_counter()
    a = DistSpMat.from_global_coo(shape, z["rows"], z["cols"], z["vals"],
                                  (GRID_Q, GRID_Q), mesh=mesh,
                                  random_permute=True)
    t_asm = time.perf_counter() - t0
    cold = triangle_count(a, mesh=mesh)
    run = _RankRun(mesh)
    count = triangle_count(a, mesh=mesh)
    rec = run.done(count=count, cold=cold, t_asm=t_asm)
    ones = lambda t: t.apply(torch.ones_like)                 # noqa: E731
    low = mat_select_lower(mat_apply_local(a, ones, mesh=mesh), mesh=mesh)
    mask = structural(low)
    p = plan_spgemm(low, low, mask=mask)
    rec["plan"] = (p.variant, p.merge, p.schedule, p.prod_cap, p.out_cap)
    rec["tile_bytes"] = low.cap * (8 + low.val.element_size()) + 4
    rec["schedules"] = {}
    kept = {}
    for sched, overlap in (("rotate", True), ("rotate", False),
                           ("alltoall", True), ("bcast", True)):
        kw = dict(mesh=mesh, mask=mask, schedule=sched, overlap=overlap)
        spgemm(low, low, ARITHMETIC, **kw)                     # warm-up
        run = _RankRun(mesh)
        c, pl = spgemm(low, low, ARITHMETIC, **kw)
        n = int(mat_sum(c))
        rec["schedules"][f"{sched}/{'overlap' if overlap else 'bulk'}"] = \
            run.done(count=n, merge=pl.merge, attempts=pl.attempts)
        if sched == "rotate":
            kept[overlap] = (c.row, c.col, c.val, c.nnz)
            if overlap:
                kept["c"] = (c, pl)
    rec["overlap_bitwise"] = _same_fields(kept[True], kept[False])
    # (c) the same masked product in 4 column batches of L
    c_full, pl = kept["c"]
    rec["batched"] = _grid_batched_tricount(mesh, low, mask, pl, c_full)
    # C's global COO, for phase 20's 2x2x2 product
    coo = c_full.to_global_coo()
    if comm.of(c_full.grid).rank == 0:
        rec["c_coo"] = coo
    del c_full, kept
    # (d) int8 wire compression on MCL's first expansion
    rec["compress"] = _grid_compressed_mcl(mesh, z)
    return rec


def _same_fields(xs, ys) -> bool:
    """Tensors bitwise equal, the sign of float zeros included."""
    return all(
        torch.equal(x, y) and torch.equal(torch.signbit(x), torch.signbit(y))
        if x.is_floating_point() else torch.equal(x, y)
        for x, y in zip(xs, ys))


def _live_sorted(c):
    """A DistSpMat tile's live (key, val), sorted by key (row-major)."""
    t = c.tile()
    n = int(t.nnz)
    key = t.row[:n].long() * (t.shape[1] + 1) + t.col[:n].long()
    order = torch.argsort(key)
    return key[order], t.val[:n][order]


def _grid_batched_tricount(mesh, low, mask, pl, c_full) -> dict:
    """Phase 16 (c) on a rank: ``spgemm_2d_batched`` of the masked
    tricount product in GRID_NBATCH column batches, with the planned
    multiply's caps: each batch's sum, and whether the batches' entries,
    together, are the unbatched C's bitwise (on this rank's tile)."""
    from repro_torch.core.dist import grid_all
    from repro_torch.core.matops import mat_sum
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.core.spgemm import spgemm_2d_batched
    kw = dict(mesh=mesh, prod_cap=pl.prod_cap, out_cap=pl.out_cap,
              nbatch=GRID_NBATCH, mask=mask)
    spgemm_2d_batched(low, low, ARITHMETIC, **kw)              # warm-up
    run = _RankRun(mesh)
    outs = spgemm_2d_batched(low, low, ARITHMETIC, **kw)
    rec = run.done()
    rec["sums"] = [int(mat_sum(c)) for c, _ in outs]
    rec["ok"] = all(grid_all(ok, c.grid) for c, ok in outs)
    kb, vb = zip(*(_live_sorted(c) for c, _ in outs))
    key, val = torch.cat(kb), torch.cat(vb)
    order = torch.argsort(key)
    kf, vf = _live_sorted(c_full)
    same = torch.equal(key[order], kf) and torch.equal(val[order], vf)
    rec["union_bitwise"] = grid_all(torch.tensor(same, device=mesh.device),
                                    low.grid)
    return rec


def _mcl_expansion_operand(z, mesh):
    """MCL's first expansion operand from phase 3's graph: A with unit
    self-loops, column-normalized, f32, on this rank's tile. Returns it
    with the largest |value|, the largest column count and the caps of
    P·P, sized from scipy's counts of each rank's stage products and C
    tile (each rank counts its own; the grid takes the largest)."""
    from repro_torch.core import comm
    from repro_torch.core.dist import DistSpMat
    n = int(z["shape"][0])
    rows = np.concatenate([z["rows"], np.arange(n)])
    cols = np.concatenate([z["cols"], np.arange(n)])
    count = np.bincount(cols, minlength=n)
    vals = (1.0 / count[cols]).astype(np.float32)
    p = DistSpMat.from_global_coo((n, n), rows, cols, vals,
                                  (GRID_Q, GRID_Q), mesh=mesh)
    g = comm.of(p.grid)
    sizes = work_3d(rows, cols, n, (1, GRID_Q, GRID_Q), False,
                    tiles=[(g.i, g.j)])
    keys = ("stage", "partial", "piece", "tile")
    mine = torch.tensor([sizes[k] for k in keys], dtype=torch.int64,
                        device=mesh.device)
    most = comm.gather_grid(mine, p.grid).reshape(-1, len(keys)).max(axis=0)
    sizes = {k: int(v) for k, v in zip(keys, most)}
    return p, float(np.abs(vals).max()), int(count.max()), \
        caps_from(sizes, 1), sizes


def _grid_compressed_mcl(mesh, z) -> dict:
    """Phase 16 (d) on a rank: P·P uncompressed (rotate, caps from scipy's
    counts), then ``compress='int8'`` under rotate with overlap on and off
    and under alltoall, and batched with compression: each run's wire
    bytes and its error against the uncompressed C on this rank's tile.
    The uncompressed run and the overlapped int8 rotate record and hold
    their kernel calls (``_RankRun``); the others are timed only."""
    from repro_torch.core.dist import grid_all
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.core.spgemm import (_restrict_cols, spgemm_2d,
                                         spgemm_2d_batched)
    from repro_torch.obs import recorder
    p, vmax, kmax, (prod_cap, out_cap), sizes = \
        _mcl_expansion_operand(z, mesh)
    caps = dict(mesh=mesh, prod_cap=prod_cap, out_cap=out_cap)
    rec = {"caps": (prod_cap, out_cap, sizes), "vmax": vmax, "k": kmax,
           "nnz_p": int(p.host_nnz().sum())}
    spgemm_2d(p, p, ARITHMETIC, schedule="rotate", **caps)     # cold
    run = _RankRun(mesh)
    exact, ok = spgemm_2d(p, p, ARITHMETIC, schedule="rotate", **caps)
    rec["exact"] = run.done(ok=grid_all(ok, p.grid),
                            nnz_c=int(exact.host_nnz().sum()))
    ex = exact.tile()

    def err_to(c, ref):
        """Max |C - ref| over this rank's tile, -1 if the index structure
        differs."""
        t = c.tile()
        if not (torch.equal(t.row, ref.row) and torch.equal(t.col, ref.col)
                and torch.equal(t.nnz, ref.nnz)):
            return -1.0
        return float((t.val - ref.val).abs().max())

    kept = {}
    for name, sched, overlap, meter in (
            ("rotate/overlap", "rotate", True, _RankRun),
            ("rotate/bulk", "rotate", False, _Wall),
            ("alltoall", "alltoall", True, _Wall)):
        kw = dict(caps, schedule=sched, overlap=overlap, compress="int8")
        run = meter(mesh)
        c, ok = spgemm_2d(p, p, ARITHMETIC, **kw)
        rec[name] = run.done(ok=grid_all(ok, p.grid), err=err_to(c, ex))
        if sched == "rotate":
            kept[overlap] = (c.row, c.col, c.val, c.nnz)
        del c
    rec["overlap_bitwise"] = _same_fields(kept[True], kept[False])
    del kept
    with recorder.capture() as r:
        spgemm_2d(p, p, ARITHMETIC, schedule="rotate", compress="int8",
                  **caps)
        counters = r.snapshot()["counters"]
    rec["counters"] = {k: counters.get(k, 0) for k in
                       ("dist.compress.bytes_in", "dist.compress.bytes_out")}
    # batched with compression: A's residual carried batch to batch
    run = _Wall(mesh)
    outs = spgemm_2d_batched(p, p, ARITHMETIC, nbatch=GRID_NBATCH,
                             compress="int8", **caps)
    rec["batched"] = run.done(
        ok=all(grid_all(ok, p.grid) for _, ok in outs))
    slab = -(-p.nb // GRID_NBATCH)
    rec["batched"]["errs"] = [
        err_to(c, _restrict_cols(exact, t * slab, slab).tile())
        for t, (c, _) in enumerate(outs)]
    return rec


def _grid_graph500(mesh):
    """Phase 10's permuted graph, assembled on the 2x2 grid."""
    from repro_torch.core.dist import DistSpMat
    z = np.load(GRID_DIR / "rmat20.npz")
    shape = tuple(int(x) for x in z["shape"])
    t0 = time.perf_counter()
    a = DistSpMat.from_global_coo(shape, z["rows"], z["cols"], z["vals"],
                                  (GRID_Q, GRID_Q), mesh=mesh)
    torch.cuda.synchronize()
    return a, time.perf_counter() - t0


def _grid_bfs_pagerank(a, mesh, roots, rank) -> dict:
    """Phase 17 on a rank: BFS from phase 10's roots, then PageRank."""
    from repro_torch.apps import bfs_levels, pagerank
    bfs_levels(a, roots[0], mesh=mesh)                         # cold
    run = _RankRun(mesh)
    levels = [bfs_levels(a, r, mesh=mesh) for r in roots]
    bfs = run.done(digest=_digest(*levels))
    if rank == 0:
        bfs["levels"] = levels
    kw = dict(mesh=mesh, alpha=PR_ALPHA, tol=PR_TOL, max_iters=PR_MAX_ITERS)
    pagerank(a, **kw)                                          # cold
    run = _RankRun(mesh)
    r = pagerank(a, **kw)
    pr = run.done(digest=_digest(r))
    if rank == 0:
        pr["r"] = r
    return {"bfs": bfs, "pagerank": pr}


def _grid_fastsv_matching_spmm(a, mesh, rank) -> dict:
    """Phase 18 on a rank: FastSV, maximal matching and SpMM on phase
    17's matrix."""
    from repro_torch.apps import fastsv, maximal_matching
    from repro_torch.core import comm, spmm_15d, spmm_2d
    from repro_torch.core.dist import DistVec, grid_all
    from repro_torch.core.semiring import MAX_PLUS
    out = {}
    fastsv(a, mesh=mesh)                                       # cold
    run = _RankRun(mesh)
    labels = fastsv(a, mesh=mesh)
    out["fastsv"] = run.done(digest=_digest(labels))
    maximal_matching(a, mesh=mesh, max_iters=MATCH_MAX_ITERS)   # cold
    run = _RankRun(mesh)
    mr, mc = maximal_matching(a, mesh=mesh, max_iters=MATCH_MAX_ITERS)
    out["matching"] = run.done(digest=_digest(mr, mc))
    n = a.shape[0]
    x_np = np.random.default_rng(0).standard_normal((n, SPMM_K)) \
        .astype(np.float32)
    x = DistVec.from_global(x_np, (GRID_Q, GRID_Q), layout="col", mesh=mesh)
    spmm_15d(a, x, mesh=mesh)                                  # cold
    run = _RankRun(mesh)
    y = spmm_15d(a, x, mesh=mesh)
    out["spmm"] = run.done()
    # X 2D-block distributed: rank (i, j) holds row block j, k-panel i
    g = comm.of(a.grid)
    kp = SPMM_K // GRID_Q
    xp = np.zeros((a.nb * GRID_Q, SPMM_K), np.float32)
    xp[:n] = x_np
    blk = torch.from_numpy(np.ascontiguousarray(
        xp[g.j * a.nb:(g.j + 1) * a.nb, g.i * kp:(g.i + 1) * kp])) \
        .to(mesh.device)
    run = _RankRun(mesh)
    y2 = spmm_2d(a, blk, mesh=mesh)
    out["spmm_2d"] = run.done()
    # Y's shard (mb/pc rows of block i*pc + j) is the row-layout piece
    y2_g = DistVec(y2[None, None], n, a.grid, "row").to_global()
    y_g = y.to_global()
    run = _RankRun(mesh)
    same = torch.equal(spmm_2d(a, blk, MAX_PLUS, mesh=mesh),
                       spmm_15d(a, x, MAX_PLUS, mesh=mesh).data[0, 0])
    out["spmm_max_plus"] = run.done()
    out["spmm"]["max_plus_equal"] = grid_all(
        torch.tensor(same, device=mesh.device), a.grid)
    if rank == 0:
        out["fastsv"]["labels"] = labels
        out["matching"]["mates"] = (mr, mc)
        out["spmm"]["y"], out["spmm"]["y2"] = y_g, y2_g
    return out


def _grid_hipmcl(mesh, path, rank) -> dict:
    """Phase 19 on a rank: HipMCL on the planted network's LABEL file."""
    from repro_torch.apps import hipmcl
    from repro_torch.core.dist import DistSpMat
    from repro_torch.io import read_generalized_tuples
    t0 = time.perf_counter()
    shape, r, c, v, _ = read_generalized_tuples(str(path), 4)
    a = DistSpMat.from_global_coo(shape, r, c, v.astype(np.float32),
                                  (GRID_Q, GRID_Q), mesh=mesh)
    t_read = time.perf_counter() - t0
    hipmcl(a, mesh=mesh)                                       # cold
    run = _RankRun(mesh)
    labels = hipmcl(a, mesh=mesh)
    rec = run.done(digest=_digest(labels), t_read=t_read)
    if rank == 0:
        rec["labels"] = labels
    return rec


def grid_rank(rank, port, backend, roots, mcl_path, out) -> None:
    """One rank of phases 16-19: joins the world, makes the 2x2 grid (its
    device ``cuda:(rank % device_count)``) and puts each phase's record on
    ``out``; a failure puts its traceback there instead."""
    import traceback
    from repro_torch.core import comm
    from repro_torch.core.dist import make_grid
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        comm.init_world(rank, GRID_Q * GRID_Q, port, backend)
        mesh = make_grid(GRID_Q, GRID_Q)
        out.put((rank, 16, _grid_tricount(mesh)))
        a, t_asm = _grid_graph500(mesh)
        rec = _grid_bfs_pagerank(a, mesh, roots, rank)
        rec["t_asm"] = t_asm
        out.put((rank, 17, rec))
        out.put((rank, 18, _grid_fastsv_matching_spmm(a, mesh, rank)))
        del a
        torch.cuda.empty_cache()
        out.put((rank, 19, _grid_hipmcl(mesh, mcl_path, rank)))
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _per_rank(recs, key):
    return [r[key] for r in recs]


def _rank_lines(what, recs) -> None:
    """Each rank's peak memory, segreduce launches by route, descent flag
    and exchanges; fails on a set flag, or when no rank launched
    segreduce."""
    for rk, r in enumerate(recs):
        c = r["comm"]
        h = r["held"]
        log(f"  {what}, rank {rk}: wall {r['wall'] * 1e3:.1f} ms, peak "
            f"{r['peak'] / 2**30:.3f} GiB, segreduce {r['routes']}, "
            f"semiring_matmul {r['smm']}, descent flag "
            f"{'SET' if r['descents'] else 'clear'}, exchanges "
            f"{c['calls']} moving {c['bytes'] / 1e6:.3f} MB in "
            f"{c['seconds'] * 1e3:.1f} ms ({100 * c['seconds'] / r['wall']:.1f}"
            f"% of the wall)")
        log(f"    rank {rk} held {sum(k for k, _ in h['shapes'])} segreduce "
            f"calls at {len(h['shapes'])} shapes against the plain version "
            f"(max abs err {h['err']:.3g}): {h['ms']:.4f} ms of device time, "
            f"bound {h['bound']:.4f} ms (each shape's first call times its "
            f"calls); {h['smm_calls']} semiring_matmul calls held (max abs "
            f"err {h['smm_err']:.3g})")
        for k, sh in h["shapes"]:
            log(f"      {_shape_line(k, sh)}")
        if r["descents"]:
            raise AssertionError(f"{what}, rank {rk}: a sorted_ids promise "
                                 f"was broken (descent flag set)")
        if h["smm_calls"] != r["smm"]:
            raise AssertionError(f"{what}, rank {rk}: {r['smm']} "
                                 f"semiring_matmul launches, {h['smm_calls']} "
                                 f"held")
    # a rank whose tiles hold nothing to reduce (tricount's upper-right
    # tile of L) may launch none; the run as a whole must
    if sum(sum(r["routes"].values()) for r in recs) < 1:
        raise AssertionError(f"{what}: no rank launched segreduce")


def _same_digests(what, recs) -> None:
    ds = _per_rank(recs, "digest")
    if len(set(ds)) != 1:
        raise AssertionError(f"{what}: the ranks' host answers differ {ds}")


def _check_tricount_grid(recs) -> None:
    want, wall1 = ONE_BY_ONE["tricount"]
    counts = _per_rank(recs, "count") + _per_rank(recs, "cold")
    if set(counts) != {EXPECTED_TRIANGLES} or want != EXPECTED_TRIANGLES:
        raise AssertionError(f"2x2 tricount {counts}, phase 3 {want}, scipy "
                             f"{EXPECTED_TRIANGLES}")
    r0 = recs[0]
    log(f"phase 16, tricount on 2x2: {r0['count']} triangles on every rank "
        f"(scipy's and phase 3's); planner pick {r0['plan']}; warm wall "
        f"{max(_per_rank(recs, 'wall')) * 1e3:.1f} ms (the slowest rank) "
        f"beside phase 3's 1x1 {wall1 * 1e3:.1f} ms; assembly "
        f"{max(_per_rank(recs, 't_asm')):.2f} s; L's packed tile "
        f"{r0['tile_bytes'] / 1e6:.3f} MB an exchange (cap x (4+4+4) + 4 "
        f"bytes)")
    _rank_lines("tricount, planner's pick", recs)
    for name in r0["schedules"]:
        rs = [r["schedules"][name] for r in recs]
        got = {x["count"] for x in rs}
        if got != {EXPECTED_TRIANGLES}:
            raise AssertionError(f"2x2 tricount under {name}: {got}")
        log(f"  schedule {name}: {EXPECTED_TRIANGLES} triangles on every "
            f"rank, merge {rs[0]['merge']}, attempts {rs[0]['attempts']}, "
            f"wall {max(x['wall'] for x in rs) * 1e3:.1f} ms")
        _rank_lines(f"schedule {name}", rs)
    if not all(_per_rank(recs, "overlap_bitwise")):
        raise AssertionError("rotate with overlap on and off: C differs")
    log("  rotate with overlap on and off: C bitwise equal on every rank")
    _check_batched_grid(_per_rank(recs, "batched"))
    _check_compressed_grid(_per_rank(recs, "compress"))
    ONE_BY_ONE["grid_c"] = r0["c_coo"]
    ONE_BY_ONE["grid_wall"] = max(_per_rank(recs, "wall"))
    ONE_BY_ONE["grid_rotate_wall"] = max(
        r["schedules"]["rotate/overlap"]["wall"] for r in recs)


def _check_batched_grid(recs) -> None:
    sums = {tuple(r["sums"]) for r in recs}
    if len(sums) != 1 or sum(recs[0]["sums"]) != EXPECTED_TRIANGLES:
        raise AssertionError(f"2x2 batched tricount: batch sums {sums}")
    if not all(r["ok"] and r["union_bitwise"] for r in recs):
        raise AssertionError("2x2 batched tricount: a batch overflowed, or "
                             "the batches' entries are not C's")
    log(f"  (c) spgemm_2d_batched, {GRID_NBATCH} column batches of the "
        f"masked product: batch sums {recs[0]['sums']}, total "
        f"{sum(recs[0]['sums'])} (scipy's); the batches' entries together "
        f"bitwise equal to the unbatched C on every rank; wall "
        f"{max(_per_rank(recs, 'wall')) * 1e3:.1f} ms")
    _rank_lines("batched tricount", recs)


def _check_compressed_grid(recs) -> None:
    r0 = recs[0]
    bound = 2 * (r0["vmax"] / 254) * r0["vmax"] * (r0["k"] + 1)
    ex = _per_rank(recs, "exact")
    if not all(x["ok"] for x in ex):
        raise AssertionError("2x2 P.P: the uncompressed product overflowed")
    ONE_BY_ONE["pp_nnz"] = ex[0]["nnz_c"]         # phase 21 (a)'s out cap
    log(f"  (d) int8 wire compression on MCL's first expansion P.P (phase "
        f"3's graph with unit self-loops, column-normalized, f32; nnz(P) "
        f"{r0['nnz_p']}, nnz(C) {ex[0]['nnz_c']}; caps (prod, out, scipy's "
        f"sizes) {r0['caps']}); error bound 2 (vmax/254) vmax (k+1) = "
        f"{bound:.4g} (vmax {r0['vmax']:.4g}, k {r0['k']}); uncompressed "
        f"rotate wall {max(_per_rank(ex, 'wall')) * 1e3:.1f} ms, wire "
        f"{_wire_mb(ex)}")
    _rank_lines("P.P uncompressed", ex)
    for name in ("rotate/overlap", "rotate/bulk", "alltoall"):
        rs = _per_rank(recs, name)
        err = max(x["err"] for x in rs)
        if min(x["err"] for x in rs) < 0 or not all(x["ok"] for x in rs):
            raise AssertionError(f"2x2 P.P int8 {name}: an index structure "
                                 f"differs from the uncompressed C, or a "
                                 f"flag is down")
        if not 0 < err <= bound:
            raise AssertionError(f"2x2 P.P int8 {name}: max abs err {err} "
                                 f"outside (0, {bound}]")
        log(f"    compress='int8' {name}: max abs err {err:.4g} (> 0, "
            f"within the bound); wall {max(_per_rank(rs, 'wall')) * 1e3:.1f} "
            f"ms; wire {_wire_mb(rs)}; peak "
            f"{max(_per_rank(rs, 'peak')) / 2**30:.3f} GiB")
        if "held" in rs[0]:
            _rank_lines(f"P.P int8 {name}", rs)
    if not all(_per_rank(recs, "overlap_bitwise")):
        raise AssertionError("2x2 P.P int8 rotate: overlap on and off "
                             "differ")
    log("    int8 rotate with overlap on and off: C bitwise equal on every "
        "rank")
    cts = _per_rank(recs, "counters")
    log(f"    dist.compress.bytes_in / bytes_out by rank (A's and B's "
        f"value payloads): "
        f"{[(c['dist.compress.bytes_in'], c['dist.compress.bytes_out']) for c in cts]}")
    bt = _per_rank(recs, "batched")
    errs = [e for x in bt for e in x["errs"]]
    if min(errs) < 0 or not 0 < max(errs) <= bound \
            or not all(x["ok"] for x in bt):
        raise AssertionError(f"2x2 P.P int8 batched: errors {errs} outside "
                             f"(0, {bound}] or a flag down")
    log(f"    batched ({GRID_NBATCH}) with compression and error feedback: "
        f"max abs err by batch "
        f"{[max(x['errs'][t] for x in bt) for t in range(GRID_NBATCH)]} "
        f"(each within the bound); wall "
        f"{max(_per_rank(bt, 'wall')) * 1e3:.1f} ms; wire {_wire_mb(bt)}")


def _wire_mb(recs) -> str:
    """Each rank's bytes put on the wire, in MB."""
    return "[" + ", ".join(f"{r['comm']['bytes'] / 1e6:.3f}"
                           for r in recs) + "] MB by rank"


def _check_bfs_pagerank_grid(recs) -> None:
    one = ONE_BY_ONE["bfs"]
    bfs = _per_rank(recs, "bfs")
    _same_digests("bfs", bfs)
    for root, got, ref in zip(one["roots"], bfs[0]["levels"], one["refs"]):
        if not np.array_equal(got, ref):
            raise AssertionError(f"2x2 BFS from {root}: levels differ from "
                                 f"scipy's")
    log(f"phase 17, BFS on 2x2 from phase 10's roots {one['roots']}: levels "
        f"bitwise equal to scipy's on every rank; assembly "
        f"{max(_per_rank(recs, 't_asm')):.2f} s; the 4 searches "
        f"{max(_per_rank(bfs, 'wall')) * 1e3:.1f} ms beside phase 10's 1x1 "
        f"{sum(one['walls']) * 1e3:.1f} ms")
    _rank_lines("bfs", bfs)
    ref, wall1, iters1 = ONE_BY_ONE["pagerank"]
    pr = _per_rank(recs, "pagerank")
    _same_digests("pagerank", pr)
    r = pr[0]["r"]
    err = float(np.abs(r.astype(np.float64) - ref).sum())
    if not np.isfinite(r).all() or r.shape != ref.shape or err > PR_L1_TOL:
        raise AssertionError(f"2x2 pagerank: L1 {err} to the reference")
    log(f"  pagerank on 2x2: L1 to the float64 reference {err:.3g} (limit "
        f"{PR_L1_TOL}); wall {max(_per_rank(pr, 'wall')) * 1e3:.1f} ms "
        f"beside phase 11's 1x1 {wall1 * 1e3:.1f} ms ({iters1} iterations)")
    _rank_lines("pagerank", pr)


def _check_fastsv_matching_spmm_grid(recs) -> None:
    csr = ONE_BY_ONE["csr"]
    ref, wall1, _ = ONE_BY_ONE["fastsv"]
    fs = _per_rank(recs, "fastsv")
    _same_digests("fastsv", fs)
    if not np.array_equal(fs[0]["labels"], ref):
        raise AssertionError("2x2 fastsv: labels differ from scipy's")
    log(f"phase 18, FastSV on 2x2: labels equal to each component's smallest "
        f"vertex (scipy) on every rank; wall "
        f"{max(_per_rank(fs, 'wall')) * 1e3:.1f} ms beside phase 12's 1x1 "
        f"{wall1 * 1e3:.1f} ms")
    _rank_lines("fastsv", fs)
    card1, mwall1, _ = ONE_BY_ONE["matching"]
    mt = _per_rank(recs, "matching")
    _same_digests("matching", mt)
    card = check_matching(*mt[0]["mates"], csr)
    log(f"  matching on 2x2: {card} pairs, consistent and maximal (1x1: "
        f"{card1}); wall {max(_per_rank(mt, 'wall')) * 1e3:.1f} ms beside "
        f"phase 13's 1x1 {mwall1 * 1e3:.1f} ms")
    _rank_lines("matching", mt)
    sm = _per_rank(recs, "spmm")
    n = csr.shape[0]
    x64 = np.random.default_rng(0).standard_normal((n, SPMM_K)) \
        .astype(np.float32).astype(np.float64)
    ref = csr @ x64
    ku = np.maximum(csr.getnnz(axis=1) - 1, 1)[:, None] * 2.0**-24
    bound = ku / (1 - ku) * (abs(csr) @ np.abs(x64))
    worst = [float((np.abs(sm[0][k].astype(np.float64) - ref)
                    / np.maximum(bound, 1e-300)).max()) for k in ("y", "y2")]
    if max(worst) > 1.0 or not all(np.isfinite(sm[0][k]).all()
                                   for k in ("y", "y2")):
        raise AssertionError(f"2x2 spmm: error {worst} x the f32 bound")
    if not all(_per_rank(sm, "max_plus_equal")):
        raise AssertionError("2x2 spmm_2d and spmm_15d differ under MAX_PLUS")
    log(f"  spmm on 2x2 (k = {SPMM_K}): spmm_15d and spmm_2d within the f32 "
        f"summation bound (worst rows at {worst[0]:.4f} and {worst[1]:.4f} "
        f"of it), bitwise equal under MAX_PLUS; spmm_15d "
        f"{max(_per_rank(sm, 'wall')) * 1e3:.3f} ms a call (host wall) beside "
        f"phase 15's 1x1 {ONE_BY_ONE['spmm']:.3f} ms (CUDA events)")
    _rank_lines("spmm_15d", sm)
    _rank_lines("spmm_2d", _per_rank(recs, "spmm_2d"))
    _rank_lines("spmm_2d and spmm_15d under MAX_PLUS",
                _per_rank(recs, "spmm_max_plus"))


def _check_hipmcl_grid(recs, ref, family_of, one) -> None:
    _same_digests("hipmcl", recs)
    got = recs[0]["labels"]
    labels1, wall1 = one
    if not (same_partition(got, ref) and same_partition(got, labels1)):
        raise AssertionError("2x2 hipmcl: not the float64 MCL's partition")
    pur = purity(got, family_of)
    if pur != 1.0:
        raise AssertionError(f"2x2 hipmcl: purity {pur}")
    log(f"phase 19, HipMCL on 2x2 ({GRID_HIPMCL_PROTEINS} proteins, cut from "
        f"phase 14's {HIPMCL_PROTEINS}): {len(np.unique(got))} clusters, the "
        f"float64 MCL's partition and the 1x1 run's, purity {pur:.4f}; "
        f"warm wall {max(_per_rank(recs, 'wall')):.2f} s beside the 1x1 "
        f"run's warm {wall1:.2f} s on the same network; LABEL read and "
        f"assembly {max(_per_rank(recs, 't_read')):.2f} s")
    _rank_lines("hipmcl", recs)


def grid_phases() -> tuple[list, dict]:
    """Phases 16-19: four ranks on a 2x2 grid. Returns each rank's
    segreduce launches by route over the four phases' measured runs, and
    the max abs err of each kernel's held calls."""
    import scipy.sparse as sp
    import torch.multiprocessing as mp
    from repro_torch.apps import hipmcl
    from repro_torch.core.dist import DistSpMat, make_grid
    from repro_torch.io import read_generalized_tuples

    # phase 19's network, its float64 reference, and the 1x1 run beside it
    family, rows, cols, vals = planted_families(
        GRID_HIPMCL_PROTEINS, *HIPMCL_FAMILY, HIPMCL_P_IN, HIPMCL_CROSS)
    path = GRID_DIR / "hipmcl_planted.lbl"
    write_label_file(path, rows, cols, vals)
    shape, r, c, v, names = read_generalized_tuples(str(path), 4)
    family_of = family[np.array([int(lb[5:]) for lb in names])]
    ref, _, _ = mcl_reference(sp.csr_matrix((v, (r, c)), shape=shape))
    mesh = make_grid(1, 1, device="cuda")
    a = DistSpMat.from_global_coo(shape, r, c, v.astype(np.float32), (1, 1),
                                  mesh=mesh)
    hipmcl(a, mesh=mesh)                                       # cold
    one = _wall(lambda: hipmcl(a, mesh=mesh))
    ONE_BY_ONE["hipmcl_grid"] = (path, ref, family_of, one[0])
    del a
    log(f"device memory before phases 16-19: "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated; "
        f"releasing the cache")
    torch.cuda.empty_cache()
    world = GRID_Q * GRID_Q
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    log(f"phases 16-19: {world} ranks on {torch.cuda.device_count()} card(s), "
        f"backend {backend}"
        + ("" if backend == "nccl" else " (NCCL refuses two ranks on one "
           "card: gathers cross through the card's memory, other "
           "exchanges are staged through pinned host memory)")
        + "; four processes share one card, so no wall here is a scaling "
        "result")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=grid_rank, daemon=True,
                         args=(rk, port, backend, ONE_BY_ONE["bfs"]["roots"],
                               path, out)) for rk in range(world)]
    checks = {16: _check_tricount_grid, 17: _check_bfs_pagerank_grid,
              18: _check_fastsv_matching_spmm_grid,
              19: lambda recs: _check_hipmcl_grid(recs, ref, family_of, one)}
    return _run_ranks(procs, out, checks, world, "phases 16-19")


def _run_ranks(procs, out, checks, world, what,
               started=False) -> tuple[list, dict]:
    """Start the ranks (unless ``started``), take each phase's records
    from ``out`` (every rank within GRID_TIMEOUT_S), check them in phase
    order and stop the ranks. Returns each rank's segreduce launches by
    route over the measured runs and the max abs err of each kernel's held
    calls."""
    import queue
    t0 = time.perf_counter()
    for p in procs if not started else ():
        p.start()
    got: dict = {ph: {} for ph in checks}
    launches = [{"sorted": 0, "atomic": 0} for _ in range(world)]
    errs = {"segreduce": 0.0, "semiring_matmul": 0.0}
    try:
        for ph in checks:
            while len(got[ph]) < world:
                try:
                    rk, key, rec = out.get(timeout=GRID_TIMEOUT_S)
                except queue.Empty:
                    missing = sorted(set(range(world)) - set(got[ph]))
                    raise AssertionError(
                        f"phase {ph}: ranks {missing} did not report within "
                        f"{GRID_TIMEOUT_S} s") from None
                if key == "error":
                    raise AssertionError(f"rank {rk} failed:\n{rec}")
                got[key][rk] = rec
            recs = [got[ph][rk] for rk in range(world)]
            checks[ph](recs)
            for rk, rec in enumerate(recs):
                for run in _runs(rec):
                    for k in launches[rk]:
                        launches[rk][k] += run["routes"][k]
                    errs["segreduce"] = max(errs["segreduce"],
                                            run["held"]["err"])
                    errs["semiring_matmul"] = max(errs["semiring_matmul"],
                                                  run["held"]["smm_err"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"{what}: ranks exited with {bad}")
    log(f"{what}: {time.perf_counter() - t0:.1f} s with the ranks' "
        f"start-up; segreduce launches of the measured runs by rank "
        f"{launches}, every one held against the plain version (max abs "
        f"err {errs})")
    return launches, errs


# --------------------------------------------------------------------------
# phase 20: the 2x2x2 grid (3D communication-avoiding SpGEMM), eight ranks
# --------------------------------------------------------------------------

def _pad_to(n, mult):
    return -(-n // mult) * mult


def work_3d(rows, cols, n, grid, masked, tiles=None) -> dict:
    """Host-side (scipy) sizes of the work of the ranks at ``tiles`` ((i, j)
    positions, every layer; all by default) in ``spgemm_3d`` of the n x n
    0/1 matrix (rows, cols) by itself on ``grid`` (L, q, q), masked by its
    own pattern or not: the largest stage's products, the largest (masked)
    partial C of a layer's tile, its largest piece for one layer, and the
    largest C3 tile. On one layer, (1, q, q), these are ``spgemm_2d``'s:
    stage products and C tiles."""
    import scipy.sparse as sp
    L, q, _ = grid
    pad = _pad_to(n, L * q * q)
    a = sp.csr_matrix((np.ones(len(rows), np.int64), (rows, cols)),
                      shape=(pad, pad))
    tr = pad // q            # A's and C's tile rows, B's tile columns
    sl = pad // L            # one layer's contraction slab
    tk = sl // q             # one stage's contraction block
    kbl = tr // L            # C3's column sub-block
    sizes = dict(stage=0, partial=0, piece=0, tile=0)
    for i, j in tiles or [(i, j) for i in range(q) for j in range(q)]:
        arows = a[i * tr:(i + 1) * tr]
        colcnt = np.asarray(arows.getnnz(axis=0), np.int64)
        bcols = a[:, j * tr:(j + 1) * tr].tocsr()
        rowcnt = np.asarray(bcols.getnnz(axis=1), np.int64)
        m = a[i * tr:(i + 1) * tr, j * tr:(j + 1) * tr]
        total = None
        for l in range(L):
            for k in range(q):
                lo = l * sl + k * tk
                sizes["stage"] = max(sizes["stage"], int(
                    colcnt[lo:lo + tk] @ rowcnt[lo:lo + tk]))
            part = (arows[:, l * sl:(l + 1) * sl]
                    @ bcols[l * sl:(l + 1) * sl]).tocsr()
            if masked:
                part = part.multiply(m).tocsr()
            sizes["partial"] = max(sizes["partial"], part.nnz)
            if part.nnz:
                sizes["piece"] = max(sizes["piece"], int(np.bincount(
                    part.tocoo().col // kbl, minlength=L).max()))
            total = part if total is None else total + part
        total = total.tocsc()
        for l in range(L):
            sizes["tile"] = max(sizes["tile"],
                                total[:, l * kbl:(l + 1) * kbl].nnz)
    return sizes


def caps_from(sizes, L) -> tuple[int, int]:
    """(prod_cap, out_cap) that hold ``work_3d``'s sizes: prod_cap each
    stage, each partial C and L times each piece (every piece fits cap_l =
    prod_cap // L), out_cap each C3 tile."""
    prod_cap = _pad_to(max(sizes["stage"], sizes["partial"],
                           L * sizes["piece"], 1), 8 * L)
    return prod_cap, _pad_to(max(sizes["tile"], 1), 8)


def caps_3d(rows, cols, n, grid, masked) -> tuple[int, int, dict]:
    """``caps_from(work_3d(...))`` over every rank, with the sizes."""
    sizes = work_3d(rows, cols, n, grid, masked)
    return caps_from(sizes, grid[0]) + (sizes,)


def _grid3_lower():
    """Phase 3's graph permuted as ``from_global_coo(random_permute=True,
    seed=0)`` permutes it, its strict lower triangle L with unit values:
    phase 16's operand in global coordinates."""
    z = np.load(GRID_DIR / "rmat15.npz")
    n = int(z["shape"][0])
    rp = np.random.default_rng(0).permutation(n).astype(np.int64)
    r, c = rp[z["rows"]], rp[z["cols"]]
    low = r > c
    return n, r[low], c[low]


def _grid3_dense_graph():
    """Phase 4's graph (R-MAT scale 11, edge factor 64), unit values."""
    from repro_torch.io.rmat import rmat_coo
    shape, rows, cols, _ = rmat_coo(DENSE_SCALE, DENSE_EDGE_FACTOR,
                                    seed=RMAT_SEED, symmetrize=True,
                                    drop_self_loops=True)
    return shape[0], rows, cols


def _grid3_product(mesh, n, rows, cols, caps, masked, rank) -> dict:
    """One phase-20 product on a rank: A = (rows, cols) as 'acol', B as
    'brow' (and the mask as 'csub'), ``spgemm_3d`` cold, then measured
    with overlap on (its kernel calls recorded and held, ``_RankRun``) and
    off (timed); merge 'deferred'. C3's global COO on rank 0."""
    from repro_torch.core.dist import DistSpMat3D, grid_all
    from repro_torch.core.mask import structural
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.core.spgemm import spgemm_3d
    grid = (mesh.layers, mesh.pr, mesh.pc)
    ones = np.ones(len(rows), np.float32)
    t0 = time.perf_counter()
    a3, b3 = (DistSpMat3D.from_global_coo((n, n), rows, cols, ones, grid, d,
                                          mesh=mesh)
              for d in ("acol", "brow"))
    mask = None
    if masked:
        mask = structural(DistSpMat3D.from_global_coo(
            (n, n), rows, cols, ones, grid, "csub", mesh=mesh))
    torch.cuda.synchronize()
    rec = {"t_asm": time.perf_counter() - t0}
    kw = dict(mesh=mesh, prod_cap=caps[0], out_cap=caps[1], mask=mask,
              merge="deferred")
    spgemm_3d(a3, b3, ARITHMETIC, **kw)                        # cold
    kept = {}
    for overlap in (True, False):
        run = (_RankRun if overlap else _Wall)(mesh)
        c3, ok = spgemm_3d(a3, b3, ARITHMETIC, overlap=overlap, **kw)
        rec["overlap" if overlap else "bulk"] = run.done(
            ok=grid_all(ok, grid))
        kept[overlap] = c3
    rec["overlap_bitwise"] = _same_fields(
        *((c.row, c.col, c.val, c.nnz) for c in (kept[True], kept[False])))
    c3 = kept[True]
    rec["nnz"] = int(c3.host_nnz().sum())
    r, c, v = c3.to_global_coo()
    if rank == 0:
        order = np.lexsort((c, r))
        rec["coo"] = (r[order], c[order], v[order])
    return rec


def grid3_rank(rank, port, backend, caps, out) -> None:
    """One rank of phase 20: joins a world of eight, makes the 2x2x2 grid
    (its device ``cuda:(rank % device_count)``) and puts each product's
    record on ``out``; a failure puts its traceback there instead."""
    import traceback
    from repro_torch.core import comm
    from repro_torch.core.dist import make_grid
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        L, q, _ = GRID3
        comm.init_world(rank, L * q * q, port, backend)
        mesh = make_grid(q, q, L)
        n, r, c = _grid3_lower()
        out.put((rank, "20a", _grid3_product(mesh, n, r, c,
                                             caps["tricount"], True, rank)))
        n, r, c = _grid3_dense_graph()
        out.put((rank, "20b", _grid3_product(mesh, n, r, c, caps["dense"],
                                             False, rank)))
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _axis_lines(what, recs) -> None:
    """Each rank's exchanges by axis: one layer's SUMMA ('row', 'col',
    'plane') apart from the inter-layer exchanges ('layer')."""
    for rk, r in enumerate(recs):
        parts = []
        for ax in ("row", "col", "plane", "layer", "world"):
            a = r["comm"]["axes"].get(ax)
            if a:
                parts.append(f"{ax} {a['calls']} calls, "
                             f"{a['bytes'] / 1e6:.3f} MB, "
                             f"{a['seconds'] * 1e3:.1f} ms")
        log(f"    {what}, rank {rk} exchanges by axis: " + "; ".join(parts))


def _check_grid3(recs, name, caps, walls) -> None:
    """Checks shared by phase 20's two products: every flag up, overlap on
    and off bitwise equal; prints the walls and each rank's lines."""
    for key in ("overlap", "bulk"):
        if not all(r[key]["ok"] for r in recs):
            raise AssertionError(f"2x2x2 {name} ({key}): a rank's ok flag is "
                                 f"down with the host-sized caps {caps}")
    if not all(_per_rank(recs, "overlap_bitwise")):
        raise AssertionError(f"2x2x2 {name}: overlap on and off differ")
    on, off = _per_rank(recs, "overlap"), _per_rank(recs, "bulk")
    if any(r["smm"] for r in on):
        raise AssertionError(f"2x2x2 {name}: semiring_matmul launched "
                             f"{[r['smm'] for r in on]}")
    log(f"  {name}: caps from scipy's counts of each rank's work "
        f"(prod_cap, out_cap, sizes) {caps}; every ok flag up; overlap on "
        f"and off bitwise equal on every rank; warm wall "
        f"{max(_per_rank(on, 'wall')) * 1e3:.1f} ms overlapped, "
        f"{max(_per_rank(off, 'wall')) * 1e3:.1f} ms bulk (the slowest "
        f"rank){walls}; assembly {max(_per_rank(recs, 't_asm')):.2f} s")
    _rank_lines(f"{name}, overlap", on)
    _axis_lines(f"{name}, overlap", on)
    _axis_lines(f"{name}, bulk", off)


def _check_grid3_tricount(recs, caps) -> None:
    r, c, v = recs[0]["coo"]
    count = int(v.astype(np.float64).sum())
    want = ONE_BY_ONE["grid_c"]
    wo = np.lexsort((want[1], want[0]))
    same = (np.array_equal(r, want[0][wo]) and np.array_equal(c, want[1][wo])
            and np.array_equal(v.view(np.uint32),
                               want[2][wo].astype(np.float32).view(np.uint32)))
    if count != EXPECTED_TRIANGLES or not same:
        raise AssertionError(f"2x2x2 tricount: {count} triangles, C3 "
                             f"{'equal to' if same else 'differs from'} "
                             f"phase 16's C")
    log(f"phase 20, masked tricount product on 2x2x2 (spgemm_3d, merge "
        f"deferred, mask structural(L) as 'csub'): sum of C3 {count} "
        f"(scipy's), nnz(C3) {recs[0]['nnz']}, C3's global COO bitwise "
        f"equal to phase 16's 2x2 masked C")
    one = ONE_BY_ONE["tricount"][1]
    walls = (f"; beside phase 16's 2x2 {ONE_BY_ONE['grid_wall'] * 1e3:.1f}"
             f" ms (the planned tricount) and rotate "
             f"{ONE_BY_ONE['grid_rotate_wall'] * 1e3:.1f} ms, and phase 3's "
             f"1x1 {one * 1e3:.1f} ms; eight processes share one card, so "
             f"this is no scaling result")
    _check_grid3(recs, "tricount product", caps, walls)


def _check_grid3_dense(recs, caps) -> None:
    import scipy.sparse as sp
    r, c, v = recs[0]["coo"]
    n, rows, cols = _grid3_dense_graph()
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, n))
    ref = (a @ a).tocoo()
    order = np.lexsort((ref.col, ref.row))
    same = (np.array_equal(r, ref.row[order].astype(np.int64))
            and np.array_equal(c, ref.col[order].astype(np.int64))
            and np.array_equal(v, ref.data[order].astype(np.float32)))
    got = (len(r), int(v.max()))
    want = (EXPECTED_DENSE["nnz_c"], EXPECTED_DENSE["max_c"])
    if got != want or not same or recs[0]["nnz"] != want[0]:
        raise AssertionError(f"2x2x2 A.A of phase 4's graph: (nnz, max) "
                             f"{got}, expected {want}; equal to scipy: "
                             f"{same}")
    log(f"phase 20 (b), phase 4's graph A.A unmasked on 2x2x2 (ARITHMETIC, "
        f"ones): nnz {got[0]}, max {got[1]}, bitwise equal to scipy's")
    _check_grid3(recs, "A.A", caps, "")


def grid3_phase() -> tuple[list, dict]:
    """Phase 20: eight ranks on a 2x2x2 grid. Returns each rank's
    segreduce launches by route over the measured runs, and the max abs
    err of each kernel's held calls."""
    import torch.multiprocessing as mp
    L, q, _ = GRID3
    world = L * q * q
    t0 = time.perf_counter()
    n, r, c = _grid3_lower()
    caps = {"tricount": caps_3d(r, c, n, GRID3, True)}
    n, r, c = _grid3_dense_graph()
    caps["dense"] = caps_3d(r, c, n, GRID3, False)
    log(f"phase 20 caps from scipy's counts ({time.perf_counter() - t0:.2f}"
        f" s): {caps}")
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    log(f"phase 20: {world} ranks on {torch.cuda.device_count()} card(s), "
        f"backend {backend}"
        + ("" if backend == "nccl" else " (NCCL refuses two ranks on one "
           "card: gathers cross through the card's memory, other "
           "exchanges are staged through pinned host memory)")
        + "; eight processes share one card, so no wall here is a scaling "
        "result")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=grid3_rank, daemon=True,
                         args=(rk, port, backend, caps, out))
             for rk in range(world)]
    checks = {"20a": lambda recs: _check_grid3_tricount(recs,
                                                       caps["tricount"]),
              "20b": lambda recs: _check_grid3_dense(recs, caps["dense"])}
    return _run_ranks(procs, out, checks, world, "phase 20")


def _runs(rec):
    """The measured runs in a phase's record (dicts with 'routes')."""
    if "routes" in rec:
        yield rec
    for v in rec.values():
        if isinstance(v, dict):
            yield from _runs(v)


# --------------------------------------------------------------------------
# phase 21: the robustness layer — fault sites, tiered audits, exchange
# deadlines, the degradation ladder and checkpointed resume
# --------------------------------------------------------------------------

def _hold_uncounted(seg, what: str) -> dict:
    """``check_segreduce_calls``, its own launches (the recorded calls run
    again against the plain version) taken back off segreduce's counts,
    so that the counts hold the phase's runs alone. Call it after the
    ``_segreduce_calls`` block that recorded ``seg``, or the holds' calls
    are recorded too."""
    from repro_torch.kernels import segreduce
    launches, routes = segreduce.launches, dict(segreduce.route_launches)
    held = check_segreduce_calls(seg, what)
    segreduce.launches = launches
    segreduce.route_launches.update(routes)
    return held


def _plan_record(rec, name):
    """(attempts, degraded) of the last ``name`` event the recorder took
    (``plan.spgemm.done`` / ``plan.spmspv.done``), (1, '') without one."""
    evs = rec.events(name)
    return (evs[-1]["attempts"], evs[-1]["degraded"]) if evs else (1, "")


def _robust_tricount(mesh) -> dict:
    """Phase 21 (a): phase 3's graph on 1x1. Each comm-site kind at
    ``spgemm2d.comm_a`` under the boundary audit (detected, retried once
    at the planner's grown caps, the right count), ``drop`` with the audit off (a wrong count: the
    documented trade), a lying ok flag, a persistent ``merge.kv_ok`` fault
    walking the ladder, a persistent fault on phase 16 (d)'s int8 P.P
    shedding the compressed schedule; the walls at each audit level."""
    from repro_torch.apps.tricount import triangle_count
    from repro_torch.core.dist import DistSpMat
    from repro_torch.core.mask import structural
    from repro_torch.core.matops import (mat_apply_local, mat_select_lower,
                                         mat_sum)
    from repro_torch.core.plan import spgemm
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.obs import recorder
    from repro_torch.robust import audit, faults, recover

    z = np.load(GRID_DIR / "rmat15.npz")
    shape = tuple(int(x) for x in z["shape"])
    a = DistSpMat.from_global_coo(shape, z["rows"], z["cols"], z["vals"],
                                  (1, 1), mesh=mesh, random_permute=True)
    walls = {}
    for level in ("off", "boundary", "full"):
        with audit.at_level(level):
            triangle_count(a, mesh=mesh)                       # warm-up
            walls[level] = [_wall(lambda: triangle_count(a, mesh=mesh))
                            for _ in range(3)]
        counts = {n for n, _ in walls[level]}
        if counts != {EXPECTED_TRIANGLES}:
            raise AssertionError(f"tricount at audit {level}: {counts}")
    log("phase 21 (a), tricount (R-MAT scale 15) warm walls by audit level, "
        "3 calls each: " + "; ".join(
            f"{lv} {', '.join(f'{s * 1e3:.2f}' for _, s in ws)} ms"
            for lv, ws in walls.items()))
    # the planner's grown caps (phase 3: 2^25 product slots grow to
    # 2^27), so that an attempt of the faulted runs is the fault's alone
    with recorder.capture() as rec:
        triangle_count(a, mesh=mesh)
        ev = (rec.events("plan.spgemm.done") or rec.events("plan.spgemm"))
    caps = dict(prod_cap=ev[-1]["prod_cap"], out_cap=ev[-1]["out_cap"])
    log(f"  faulted tricounts at the caps the planner grew to {caps}")
    tc = lambda: triangle_count(a, mesh=mesh, **caps)         # noqa: E731
    with _segreduce_calls() as seg:
        for kind in ROBUST_KINDS:
            with audit.at_level("boundary"), recorder.capture() as rec, \
                    faults.inject(f"spgemm2d.comm_a:{kind}"):
                count, s = _wall(tc)
                attempts, degraded = _plan_record(rec, "plan.spgemm.done")
                fails = rec.events("audit.failure")
            log(f"  spgemm2d.comm_a:{kind}, audit boundary: {count} "
                f"triangles, attempts {attempts}, degraded {degraded!r}, "
                f"{len(fails)} audit failure(s) "
                f"({fails[0]['error'][:72] if fails else '-'}), "
                f"{s * 1e3:.1f} ms (recorded)")
            if (count, attempts, degraded, len(fails)) != \
                    (EXPECTED_TRIANGLES, 2, "", 1):
                raise AssertionError(f"comm_a:{kind}: not detected and "
                                     f"retried once to the right count")
        with faults.inject("spgemm2d.comm_a:drop"):
            lost = tc()
        log(f"  spgemm2d.comm_a:drop, audit off: {lost} triangles against "
            f"{EXPECTED_TRIANGLES} (the documented trade: undetected)")
        if lost == EXPECTED_TRIANGLES:
            raise AssertionError("an undetected drop left the count whole")
        with recorder.capture() as rec, \
                faults.inject("plan.spgemm.ok:flip"):
            count = tc()
            attempts, degraded = _plan_record(rec, "plan.spgemm.done")
        log(f"  plan.spgemm.ok:flip: {count} triangles, attempts {attempts}")
        if (count, attempts) != (EXPECTED_TRIANGLES, 2):
            raise AssertionError("the lying ok flag was not retried once")
        # the merge engine's flag lies on every call: caps that hold the
        # unmasked product (its products, from L's counts), no growth, so
        # each failure takes a rung
        ones = lambda t: t.apply(torch.ones_like)             # noqa: E731
        low = mat_select_lower(mat_apply_local(a, ones, mesh=mesh),
                               mesh=mesh)
        lr, lc, _ = low.to_global_coo()
        products = int(np.bincount(lc, minlength=shape[0])
                       @ np.bincount(lr, minlength=shape[0]))
        try:
            with faults.inject("merge.kv_ok:flip"), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                (c, pl), s = _wall(lambda: spgemm(
                    low, low, ARITHMETIC, mesh=mesh, mask=structural(low),
                    merge="deferred", prod_cap=products, out_cap=products,
                    max_attempts=1))
        finally:
            recover.reset_degradation()
        count = int(mat_sum(c))
        log(f"  merge.kv_ok:flip (persistent, merge='deferred', caps "
            f"{pl.prod_cap}/{pl.out_cap} for L.L's {products} products): "
            f"{count} triangles, attempts {pl.attempts}, degraded "
            f"{pl.degraded}, {s * 1e3:.1f} ms")
        if count != EXPECTED_TRIANGLES or "sort-merge" not in pl.degraded:
            raise AssertionError("the kv_ok fault did not end on the "
                                 "sort merge with the right count")
        del c, low
    # held after the recording block: the holds' own calls unrecorded
    routes = _hold_uncounted(seg, "phase 21 (a), the faulted tricounts")
    routes_pp = _robust_compressed(z, mesh)
    return {k: routes[k] + routes_pp[k] for k in routes}


def _robust_compressed(z, mesh) -> dict:
    """Phase 21 (a), the compressed exchange: phase 16 (d)'s P.P on 1x1,
    int8, a corrupted payload on every attempt; the ladder sheds
    compression and overlap and the uncompressed product is C."""
    from repro_torch.core.dist import DistSpMat
    from repro_torch.core.plan import spgemm
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.robust import audit, faults
    n = int(z["shape"][0])
    rows = np.concatenate([z["rows"], np.arange(n)])
    cols = np.concatenate([z["cols"], np.arange(n)])
    count = np.bincount(cols, minlength=n)
    vals = (1.0 / count[cols]).astype(np.float32)
    p = DistSpMat.from_global_coo((n, n), rows, cols, vals, (1, 1),
                                  mesh=mesh)
    # caps from the counts: one stage's products, phase 16's nnz(C)
    products = int(count @ np.bincount(rows, minlength=n))
    nnz_c = ONE_BY_ONE["pp_nnz"]
    torch.cuda.reset_peak_memory_stats()
    with _segreduce_calls() as seg:
        with audit.at_level("boundary"), warnings.catch_warnings(), \
                faults.inject("dist.compressed_exchange:corrupt_val:"
                              "count=99"):
            warnings.simplefilter("ignore", RuntimeWarning)
            (c, pl), s = _wall(lambda: spgemm(
                p, p, ARITHMETIC, mesh=mesh, compress="int8",
                prod_cap=products, out_cap=nnz_c))
        got = int(c.nnz.sum())
        total = float(c.val.double().sum())
        log(f"  dist.compressed_exchange:corrupt_val:count=99 on P.P "
            f"(nnz(P) {len(rows)}, {products} products, int8, audit "
            f"boundary): attempts {pl.attempts}, degraded {pl.degraded}, "
            f"compress {pl.compress}, overlap {pl.overlap}; nnz(C) {got} "
            f"(phase 16: {nnz_c}), sum {total:.4f} (n = {n}: P is column-"
            f"stochastic); {s:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if pl.degraded != ("serial-schedule:overlap+compress=int8",) \
                or pl.compress is not None or got != nnz_c \
                or abs(total - n) > 1e-3 * n:
            raise AssertionError("the persistent int8 fault did not shed "
                                 "to the uncompressed product")
        del c, p
    return _hold_uncounted(seg, "phase 21 (a), the shed P.P")


def _level_attempts(rec) -> list:
    """Each BFS level's SpMSpV attempts, from the recorder's plan events
    (a level without a ``.done`` event took one)."""
    out = []
    for e in rec.events():
        if e["name"] == "plan.spmspv":
            out.append(1)
        elif e["name"] == "plan.spmspv.done":
            out[-1] = e["attempts"]
    return out


def _robust_bfs(graph, mesh) -> dict:
    """Phase 21 (b): one BFS root of phase 10 (scale 20) with a quarter of
    the frontier dropped at level ROBUST_BFS_LEVEL under the boundary
    audit. (``corrupt_val`` leaves a bool frontier as it was in both
    packages: ``True * 1000 + 7`` casts back to True.)"""
    from repro_torch.apps import bfs_levels
    from repro_torch.obs import recorder
    from repro_torch.robust import audit, faults
    root = ONE_BY_ONE["bfs"]["roots"][0]
    ref = ONE_BY_ONE["bfs"]["refs"][0]
    with recorder.capture() as rec:
        bfs_levels(graph, root, mesh=mesh)
        clean = _level_attempts(rec)
    # the guard counts an activation per attempt: the level's first one
    at = sum(clean[:ROBUST_BFS_LEVEL]) + 1
    with _segreduce_calls() as seg:
        with audit.at_level("boundary"), recorder.capture() as rec, \
                faults.inject(f"spmspv.comm_x:drop:at={at}"):
            levels, s = _wall(lambda: bfs_levels(graph, root, mesh=mesh))
            got = _level_attempts(rec)
            fails = rec.events("audit.failure")
    routes = _hold_uncounted(seg, "phase 21 (b), the faulted BFS")
    want = list(clean)
    want[ROBUST_BFS_LEVEL] += 1
    log(f"phase 21 (b), BFS root {root} on R-MAT scale 20 with "
        f"spmspv.comm_x:drop at level {ROBUST_BFS_LEVEL} (audit "
        f"boundary): levels bitwise scipy's {np.array_equal(levels, ref)}; "
        f"attempts by level {got} (clean {clean}); {len(fails)} audit "
        f"failure(s); {s * 1e3:.1f} ms (recorded) beside phase 10's "
        f"{ONE_BY_ONE['bfs']['walls'][0] * 1e3:.1f} ms")
    if not np.array_equal(levels, ref) or got != want or len(fails) != 1:
        raise AssertionError("phase 21 (b): the corrupted frontier was not "
                             "retried once at its level, or levels differ")
    return routes


def _ckpt_line(rec, loop) -> str:
    snap = rec.snapshot()
    save = snap["spans"].get("ckpt.save", {"count": 0, "total_us": 0.0})
    it = snap["spans"][f"{loop}.iter"]
    per = snap["counters"].get("ckpt.bytes_saved", 0) / max(save["count"], 1)
    return (f"{save['count']} saves of {per / 1e6:.3f} MB, "
            f"{save['total_us'] / max(save['count'], 1) / 1e3:.2f} ms a save "
            f"beside the iteration's median {it['p50_us'] / 1e3:.2f} ms "
            f"({it['count']} iterations)")


def _robust_checkpoints(graph, mesh) -> dict:
    """Phase 21 (c): PageRank (phase 11) crashed by ``loop.crash`` at its
    ROBUST_CRASH_AT['pagerank']-th iteration with the newest checkpoint's
    leaf corrupted, resumed past it; HipMCL (phase 14) crashed at its
    ROBUST_CRASH_AT['hipmcl']-th and resumed. Both equal to the
    uninterrupted run, bitwise."""
    import shutil
    from repro_torch.apps import hipmcl, pagerank
    from repro_torch.core.dist import DistSpMat
    from repro_torch.obs import recorder
    from repro_torch.robust import faults
    from repro_torch.robust.faults import InjectedCrash
    from repro_torch.train.checkpoint import all_steps
    kw = dict(mesh=mesh, alpha=PR_ALPHA, tol=PR_TOL, max_iters=PR_MAX_ITERS)
    d = ROBUST_DIR / "pagerank"
    shutil.rmtree(d, ignore_errors=True)
    with _segreduce_calls() as seg:
        bare, bare_s = _wall(lambda: pagerank(graph, **kw))
        # iterations 0 .. at-2 complete and save, two leaves each
        # ('__loop_done__', then 'r'): the newest save's 'r' is leaf
        # 2 * (at - 1)
        at = ROBUST_CRASH_AT["pagerank"]
        with faults.inject(f"loop.crash:crash:at={at}",
                           f"checkpoint.leaf:flip:at={2 * (at - 1)}"):
            try:
                pagerank(graph, checkpoint_dir=str(d), **kw)
                raise AssertionError("pagerank: the injected crash did not "
                                     "happen")
            except InjectedCrash as err:
                crash = str(err)
        steps = sorted(all_steps(str(d)))
        with recorder.capture() as rec, \
                warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            resumed, res_s = _wall(lambda: pagerank(
                graph, checkpoint_dir=str(d), **kw))
            saves = _ckpt_line(rec, "pagerank")
        fell_back = [str(w.message)[:90] for w in warned
                     if "falling back" in str(w.message)]
        log(f"phase 21 (c), PageRank on R-MAT scale 20 with checkpoints: "
            f"{crash}; steps on disk {steps}; the newest's leaf 'r' "
            f"corrupted, resume fell back: {fell_back}; resumed r bitwise "
            f"equal to the uninterrupted run {np.array_equal(resumed, bare)}"
            f" ({res_s * 1e3:.1f} ms resumed, recorded; {bare_s * 1e3:.1f} "
            f"ms uninterrupted, no checkpoints); {saves}")
        if not np.array_equal(resumed, bare) or len(fell_back) != 1 \
                or steps != [at - 4, at - 3, at - 2]:
            raise AssertionError("phase 21 (c): PageRank's resume differs, "
                                 "or did not fall back past the corrupt "
                                 "step")
        shape, r, c, v, cold = ONE_BY_ONE["hipmcl"]
        a = DistSpMat.from_global_coo(shape, r, c, v, (1, 1), mesh=mesh)
        d = ROBUST_DIR / "hipmcl"
        shutil.rmtree(d, ignore_errors=True)
        at = ROBUST_CRASH_AT["hipmcl"]
        with faults.inject(f"loop.crash:crash:at={at}"):
            try:
                hipmcl(a, mesh=mesh, checkpoint_dir=str(d))
                raise AssertionError("hipmcl: the injected crash did not "
                                     "happen")
            except InjectedCrash as err:
                crash = str(err)
        with recorder.capture() as rec:
            labels, s = _wall(lambda: hipmcl(a, mesh=mesh,
                                             checkpoint_dir=str(d)))
            saves = _ckpt_line(rec, "hipmcl")
        log(f"  HipMCL ({shape[0]} proteins) with checkpoints: {crash}; "
            f"resumed from step {at - 2} to "
            f"{len(np.unique(labels))} clusters, labels bitwise phase 14's "
            f"{np.array_equal(labels, cold)} ({s:.2f} s resumed, "
            f"recorded); {saves}")
        if not np.array_equal(labels, cold):
            raise AssertionError("phase 21 (c): HipMCL's resume changed "
                                 "the labels")
        del a
    return _hold_uncounted(seg, "phase 21 (c), the checkpointed runs")


def _grid_robust(mesh, rank) -> dict:
    """Phase 21 (d) on a rank: phase 16's operand (the masked tricount
    product on 2x2). A dropped B tile under the boundary audit (one rank's
    tile corrupted, every rank retries); a straggler on rank 1 only (every
    rank backs off and retries); a persistent one (every rank sheds the
    schedule, then raises TopologyError); C saved for the 1x1 restore."""
    from repro_torch.core.dist import DistSpMat, save_spmat
    from repro_torch.core.mask import structural
    from repro_torch.core.matops import (mat_apply_local, mat_select_lower,
                                         mat_sum)
    from repro_torch.core.plan import spgemm
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.obs import recorder
    from repro_torch.robust import audit, deadline, faults, recover
    warnings.simplefilter("ignore", RuntimeWarning)
    z = np.load(GRID_DIR / "rmat15.npz")
    shape = tuple(int(x) for x in z["shape"])
    a = DistSpMat.from_global_coo(shape, z["rows"], z["cols"], z["vals"],
                                  (GRID_Q, GRID_Q), mesh=mesh,
                                  random_permute=True)
    ones = lambda t: t.apply(torch.ones_like)                 # noqa: E731
    low = mat_select_lower(mat_apply_local(a, ones, mesh=mesh), mesh=mesh)
    kw = dict(mesh=mesh, mask=structural(low))
    # warm-up; then the caps and merge the planner ended on, so that an
    # attempt of the faulted runs is the fault's alone
    with recorder.capture() as r:
        spgemm(low, low, ARITHMETIC, **kw)
        ev = (r.events("plan.spgemm.done") or r.events("plan.spgemm"))[-1]
    kw.update(prod_cap=ev["prod_cap"], out_cap=ev["out_cap"],
              merge=ev["merge"])
    rec = {}
    run = _RankRun(mesh)
    with audit.at_level("boundary"), faults.inject("spgemm2d.comm_b:drop"):
        c, p = spgemm(low, low, ARITHMETIC, **kw)
    rec["drop"] = run.done(plan=(p.attempts, p.degraded),
                           count=int(mat_sum(c)))
    coo = c.to_global_coo()
    if rank == 0:
        rec["c_coo"] = coo
    save_spmat(str(ROBUST_DIR / "grid_c"), 0, c)
    del c
    lag = [f"dist.exchange_deadline:delay:amount={ROBUST_LAG_S}"] \
        if rank == 1 else []
    run = _RankRun(mesh)
    with deadline.configure(startup_deadline=ROBUST_DEADLINE_S,
                            backoff_base=0.01), faults.inject(*lag):
        c, p = spgemm(low, low, ARITHMETIC, **kw)
    rec["lag"] = run.done(plan=(p.attempts, p.degraded),
                          count=int(mat_sum(c)))
    del c
    lag = [f"dist.exchange_deadline:delay:amount={ROBUST_LAG_S},count=99"] \
        if rank == 1 else []
    run = _RankRun(mesh)
    try:
        with deadline.configure(startup_deadline=ROBUST_DEADLINE_S,
                                backoff_base=0.01), faults.inject(*lag):
            spgemm(low, low, ARITHMETIC, **kw)
        topo = None
    except deadline.TopologyError as err:
        topo = (err.site, str(err))
    finally:
        recover.reset_degradation()
    rec["topo"] = run.done(error=topo)
    return rec


def robust_rank(rank, port, backend, out) -> None:
    """One rank of phase 21 (d): joins a world of four, makes the 2x2 grid
    and puts its record on ``out``; a failure puts its traceback there."""
    import traceback
    from repro_torch.core import comm
    from repro_torch.core.dist import make_grid
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        comm.init_world(rank, GRID_Q * GRID_Q, port, backend)
        mesh = make_grid(GRID_Q, GRID_Q)
        out.put((rank, 21, _grid_robust(mesh, rank)))
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _check_robust_grid(recs) -> None:
    from repro_torch.core.dist import make_grid, restore_spmat
    drops = _per_rank(recs, "drop")
    plans = {r["plan"] for r in drops}
    log(f"phase 21 (d), 2x2 (phase 16's masked product at the caps and "
        f"merge the planner ended on), spgemm2d.comm_b:drop under the "
        f"boundary audit: (attempts, "
        f"degraded) by rank {[r['plan'] for r in drops]}, counts "
        f"{_per_rank(drops, 'count')}, walls "
        f"{[round(r['wall'] * 1e3, 1) for r in drops]} ms")
    _rank_lines("faulted product", drops)
    want = ONE_BY_ONE["grid_c"]
    got = recs[0]["c_coo"]
    same = all(np.array_equal(x.view(np.uint8), y.view(np.uint8))
               for x, y in zip(got, want))
    if plans != {(2, ())} or set(_per_rank(drops, "count")) != \
            {EXPECTED_TRIANGLES} or not same:
        raise AssertionError("2x2 drop: the ranks did not all retry once to "
                             "phase 16's C")
    lags = _per_rank(recs, "lag")
    log(f"  straggler on rank 1 only ({ROBUST_LAG_S} s inside the timed "
        f"region, deadline {ROBUST_DEADLINE_S} s): (attempts, degraded) by "
        f"rank {[r['plan'] for r in lags]}, walls "
        f"{[round(r['wall'] * 1e3, 1) for r in lags]} ms")
    _rank_lines("straggled product", lags)
    if {r["plan"] for r in lags} != {(2, ())} or \
            set(_per_rank(lags, "count")) != {EXPECTED_TRIANGLES}:
        raise AssertionError("2x2 straggler: the ranks did not all back off "
                             "and retry once")
    topo = _per_rank(recs, "topo")
    errs = {r["error"] for r in topo}
    log(f"  persistent straggler on rank 1: every rank raised "
        f"{sorted(errs)[0] if len(errs) == 1 else errs}; walls "
        f"{[round(r['wall'] * 1e3, 1) for r in topo]} ms")
    if len(errs) != 1 or None in errs or "serial-schedule" not in \
            next(iter(errs))[1]:
        raise AssertionError("2x2 persistent straggler: not the same "
                             "TopologyError after the schedule shed on "
                             "every rank")
    mesh = make_grid(1, 1, device="cuda")
    t0 = time.perf_counter()
    c, step = restore_spmat(str(ROBUST_DIR / "grid_c"), (1, 1), mesh=mesh)
    t_restore = time.perf_counter() - t0
    r, cc, v = c.to_global_coo()
    order = np.lexsort((cc, r))
    worder = np.lexsort((want[1], want[0]))
    same = (np.array_equal(r[order], want[0][worder])
            and np.array_equal(cc[order], want[1][worder])
            and np.array_equal(v[order].view(np.uint32),
                               want[2][worder].view(np.uint32)))
    log(f"  C saved on 2x2 (rank 0 wrote {len(r)} entries), restored onto "
        f"1x1 in this process in {t_restore:.2f} s: bitwise phase 16's C "
        f"{same}")
    if not same or step != 0:
        raise AssertionError("the 2x2 checkpoint did not restore bitwise "
                             "onto 1x1")


def robust_phase(graph, mesh) -> dict:
    """Phase 21: (a)-(c) on 1x1 here, (d) on four ranks. Returns
    segreduce's launches by route: this process's from its counters (0
    before the phase), of them the faulted runs' (each recorded by shape
    and held against the plain version), and each rank's measured runs'
    (held on the rank)."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import segreduce
    t0 = time.perf_counter()
    ROBUST_DIR.mkdir(parents=True, exist_ok=True)
    routes = _robust_tricount(mesh)
    for part in (_robust_bfs(graph, mesh),
                 _robust_checkpoints(graph, mesh)):
        for k in routes:
            routes[k] += part[k]
    launched = dict(segreduce.route_launches)
    if any(routes[k] > launched[k] for k in routes):
        raise AssertionError(f"phase 21: held {routes} segreduce calls, "
                             f"the counters read {launched}")
    torch.cuda.empty_cache()
    world = GRID_Q * GRID_Q
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=robust_rank, daemon=True,
                         args=(rk, port, backend, out))
             for rk in range(world)]
    ranks, errs = _run_ranks(procs, out, {21: _check_robust_grid}, world,
                             "phase 21 (d)")
    log(f"phase 21: {time.perf_counter() - t0:.1f} s; segreduce launches on "
        f"1x1 {launched}, of them the faulted runs' {routes}, each held "
        f"against the plain version; the ranks' measured runs {ranks} (max "
        f"abs err {errs['segreduce']:.3g})")
    if sum(launched.values()) < 1 or sum(sum(r.values()) for r in ranks) < 1:
        raise AssertionError("phase 21 launched no segreduce")
    return {"1x1": launched, "1x1_faulted_held": routes, "ranks_2x2": ranks,
            "max_abs_err": errs["segreduce"]}


# --------------------------------------------------------------------------
# phase 22: in-process elastic regrid — a device lost on 2x2, the apps
# finishing on 1x1 in the same world; 2x2x2 -> 1x2x2; the Chrome traces
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _regrid_clock():
    """Record each ``DistSpMat.regrid`` / ``DistSpMat3D.regrid`` while the
    block runs: its seconds (synchronized) and the bytes this rank put on
    the wire in it (``core/comm.py``'s accounting). Yields the list."""
    from repro_torch.core import comm
    from repro_torch.core.dist import DistSpMat, DistSpMat3D
    got = []
    inner = {cls: cls.regrid for cls in (DistSpMat, DistSpMat3D)}

    def wrap(fn):
        def regrid(self, *a, **kw):
            torch.cuda.synchronize()
            b0, t0 = comm.stats["bytes"], time.perf_counter()
            res = fn(self, *a, **kw)
            torch.cuda.synchronize()
            got.append({"s": time.perf_counter() - t0,
                        "bytes": comm.stats["bytes"] - b0,
                        "kept": res is not None})
            return res
        return regrid

    for cls, fn in inner.items():
        cls.regrid = wrap(fn)
    try:
        yield got
    finally:
        for cls, fn in inner.items():
            cls.regrid = fn


def _profiler_warmup() -> None:
    """Start torch.profiler's CUDA tracing once in this rank, beside the
    other ranks: its first start costs seconds, which the ranks would
    otherwise pay one after another in their turns to hold their calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _elastic_kw(app) -> dict:
    return dict(alpha=PR_ALPHA, tol=PR_TOL, max_iters=PR_MAX_ITERS) \
        if app == "pagerank" else {}


def _pagerank_crash(a, mesh) -> dict:
    """Phase 22 (a)'s PageRank reference on a rank: the same device loss
    without ``elastic``, checkpointing every iteration: it raises
    TopologyError after saving the last iteration done on 2x2."""
    from repro_torch.apps import pagerank
    from repro_torch.robust import faults
    from repro_torch.robust.deadline import TopologyError
    run = _RankRun(mesh)
    err = None
    with faults.inject(ELASTIC_LOSS):
        try:
            pagerank(a, mesh=mesh, checkpoint_dir=str(ELASTIC_DIR / "pr"),
                     **_elastic_kw("pagerank"))
        except TopologyError as e:
            err = str(e)
    return run.done(error=err)


def _elastic_app(app, a, mesh, rank) -> dict:
    """One app of phase 22 (a) on a rank: ``elastic=True`` with the device
    loss at its ELASTIC_AT-th iteration on 2x2; its kernel calls held
    (``_RankRun``), its regrids timed, its iterations on each grid read
    from the recorder (spans ``<app>.iter``, event ``loop.topology``)."""
    from repro_torch import apps
    from repro_torch.obs import recorder
    from repro_torch.robust import faults
    count = lambda: recorder.snapshot()["spans"].get(          # noqa: E731
        f"{app}.iter", {}).get("count", 0)
    n0 = count()
    run = _RankRun(mesh)
    with _regrid_clock() as regrids, faults.inject(ELASTIC_LOSS):
        res = getattr(apps, app)(a, mesh=mesh, elastic=True,
                                 **_elastic_kw(app))
    topo = [e for e in recorder.events("loop.topology") if e["loop"] == app]
    it = topo[-1]["it"] if topo else None
    rec = run.done(digest=_digest(res), regrids=regrids,
                   iters=(it, count() - n0 - (it or 0)),
                   finite=bool(np.isfinite(res).all()))
    if rank == 0:
        rec["res"] = res
    return rec


def elastic_rank(rank, port, backend, mcl_path, out) -> None:
    """One rank of phase 22 (a): joins a world of four, makes the 2x2 grid,
    runs PageRank's crash reference, then each app with ``elastic=True``
    (``REPRO_TRACE`` records the rank and dumps its trace at exit) and
    puts the record on ``out``; a failure puts its traceback there."""
    import traceback
    from repro_torch.core import comm
    from repro_torch.core.dist import DistSpMat, make_grid
    from repro_torch.io import read_generalized_tuples
    from repro_torch.obs import recorder
    warnings.simplefilter("ignore", RuntimeWarning)
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        comm.init_world(rank, GRID_Q * GRID_Q, port, backend)
        if not recorder.enabled():
            raise AssertionError("REPRO_TRACE did not start the recorder")
        _profiler_warmup()
        mesh = make_grid(GRID_Q, GRID_Q)
        a, t_asm = _grid_graph500(mesh)
        rec = {"t_asm": t_asm, "crash": _pagerank_crash(a, mesh)}
        for app in ("pagerank", "fastsv"):
            rec[app] = _elastic_app(app, a, mesh, rank)
        del a
        torch.cuda.empty_cache()
        shape, r, c, v, _ = read_generalized_tuples(str(mcl_path), 4)
        m = DistSpMat.from_global_coo(shape, r, c, v.astype(np.float32),
                                      (GRID_Q, GRID_Q), mesh=mesh)
        rec["hipmcl"] = _elastic_app("hipmcl", m, mesh, rank)
        rec["coverage"] = recorder.coverage("pagerank.iter")
        out.put((rank, "22a", rec))
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _regrid_line(regrids) -> str:
    if not regrids:
        return "no regrid (its state is global COO: only the mesh moves)"
    return "; ".join(f"regrid {g['s']:.3f} s, {g['bytes'] / 1e6:.3f} MB sent"
                     f"{'' if g['kept'] else ', retired'}" for g in regrids)


def _elastic_lines(app, recs) -> None:
    _same_digests(f"elastic {app}", recs)
    if not all(r["finite"] for r in recs):
        raise AssertionError(f"elastic {app}: a rank's answer is not finite")
    for rk, r in enumerate(recs):
        before, after = r["iters"]
        log(f"  {app}, rank {rk}: {before} iterations on 2x2, {after} on "
            f"1x1 after the shrink; {_regrid_line(r['regrids'])}; wall "
            f"{r['wall']:.2f} s, peak {r['peak'] / 2**30:.3f} GiB")
        if before != ELASTIC_AT - 1 or (after > 0) != (rk == 0):
            raise AssertionError(f"elastic {app}, rank {rk}: {before} "
                                 f"iterations before the loss and {after} "
                                 f"after; rank 0 alone goes on")
        want_regrids = 0 if app == "hipmcl" else 1
        if len(r["regrids"]) != want_regrids or \
                any(g["kept"] != (rk == 0) for g in r["regrids"]):
            raise AssertionError(f"elastic {app}, rank {rk}: regrids "
                                 f"{r['regrids']}")
    _rank_lines(f"elastic {app}", recs)


def jax_obs_names() -> set:
    """The span and event names the JAX package emits, read from its
    source text (nothing of it is imported): the literal names of
    ``span``/``timed``/``event`` and the planner's events, ``<name>.iter``
    of each ``CheckpointedLoop``, and the guarded sites (``KNOWN_SITES``),
    whose guard spans are named by the site."""
    import re
    names = set()
    for path in (ROOT / "src" / "repro").rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(
            r'_obs\.(?:span|timed|event)\(\s*"([^"]+)"', text))
        names |= set(re.findall(r'_plan_event\(\s*"([^"]+)"', text))
        names |= {m + ".iter" for m in re.findall(
            r'CheckpointedLoop\([^)]*?name="(\w+)"', text, re.S)}
        for block in re.findall(r"KNOWN_SITES = \{(.*?)\n\}", text, re.S):
            names |= set(re.findall(r'^\s*"([^"]+)":', block, re.M))
    return names


def _check_elastic_traces(coverage) -> None:
    """Phase 22 (c): each rank's REPRO_TRACE file (written as the rank
    exits), beside the rank's ``coverage('pagerank.iter')``."""
    jax = jax_obs_names()
    for rk, cov in enumerate(coverage):
        path = ELASTIC_TRACE.with_name(
            f"{ELASTIC_TRACE.stem}.rank{rk}{ELASTIC_TRACE.suffix}")
        doc = json.loads(path.read_text())
        evs = doc["traceEvents"]
        named = {e["name"] for e in evs if e["ph"] in ("X", "i")}
        missing = {"pagerank.iter", "dist.regrid", "loop.topology"} - named
        foreign = named - jax
        log(f"  phase 22 (c), rank {rk}: {path.parent.name}/{path.name} "
            f"({path.stat().st_size / 1e6:.2f} MB, {len(evs)} trace "
            f"events, {len(named)} span and event names, all the JAX "
            f"package's: {not foreign}); coverage('pagerank.iter') "
            f"{cov:.4f}")
        if missing or foreign or "epoch_unix_s" not in doc["otherData"]:
            raise AssertionError(f"rank {rk}'s trace: missing {missing}, "
                                 f"names the JAX package never emits "
                                 f"{foreign}")


def _check_elastic_grid(recs, mesh, graph) -> None:
    """Phase 22 (a) and (c): the answers against the references, each
    rank's lines, the traces."""
    from repro_torch.apps import pagerank
    crash = _per_rank(recs, "crash")
    if None in _per_rank(crash, "error"):
        raise AssertionError("phase 22: a crash reference did not raise "
                             "TopologyError")
    _rank_lines("pagerank crashed on 2x2 (the reference)", crash)
    log(f"phase 22 (a), four ranks on 2x2, a device lost at the "
        f"{ELASTIC_AT}th iteration of each app (elastic=True): every rank "
        f"goes on to the same answer; assembly "
        f"{max(_per_rank(recs, 't_asm')):.2f} s")
    prs = _per_rank(recs, "pagerank")
    with _segreduce_calls() as seg:
        resumed, res_s = _wall(lambda: pagerank(
            graph, mesh=mesh, checkpoint_dir=str(ELASTIC_DIR / "pr"),
            **_elastic_kw("pagerank")))
    held = _hold_uncounted(seg, "phase 22 (a), PageRank resumed on 1x1")
    ref = ONE_BY_ONE["pagerank"][0]
    r = prs[0]["res"]
    err = float(np.abs(r.astype(np.float64) - ref).sum())
    same = np.array_equal(r.view(np.uint32), resumed.view(np.uint32))
    log(f"  pagerank: r bitwise equal to the crashed 2x2 run resumed on 1x1 "
        f"from its checkpoint here ({res_s * 1e3:.1f} ms, segreduce {held}, "
        f"held): {same}; L1 to phase 11's float64 reference {err:.3g} "
        f"(limit {PR_L1_TOL})")
    if not same or err > PR_L1_TOL:
        raise AssertionError("elastic pagerank: r differs from the resumed "
                             "run, or from the float64 reference")
    _elastic_lines("pagerank", prs)
    fs = _per_rank(recs, "fastsv")
    ok = np.array_equal(fs[0]["res"], ONE_BY_ONE["fastsv"][0])
    log(f"  fastsv: labels bitwise phase 12's and scipy's: {ok}")
    if not ok:
        raise AssertionError("elastic fastsv: labels differ from phase 12's")
    _elastic_lines("fastsv", fs)
    ms = _per_rank(recs, "hipmcl")
    _, mref, family_of, one = ONE_BY_ONE["hipmcl_grid"]
    got = ms[0]["res"]
    ok = same_partition(got, mref) and same_partition(got, one)
    log(f"  hipmcl ({GRID_HIPMCL_PROTEINS} proteins): {len(np.unique(got))} "
        f"clusters, phase 19's float64 MCL partition: {ok}, purity "
        f"{purity(got, family_of):.4f}")
    if not ok:
        raise AssertionError("elastic hipmcl: not the float64 MCL's "
                             "partition")
    _elastic_lines("hipmcl", ms)
    ONE_BY_ONE["elastic_coverage"] = _per_rank(recs, "coverage")


def _regrid3d_operands(mesh, n, rows, cols, caps) -> dict:
    """Phase 22 (b) on a rank: phase 20's operands (L as 'acol' and
    'brow', the mask as 'csub') on 2x2x2, each regridded to 1x2x2 (global
    COO before and after); then, on the four ranks that hold 1x2x2, the
    masked tricount product through ``spgemm_3d`` there (cold)."""
    from repro_torch.core import comm
    from repro_torch.core.dist import (DistSpMat3D, grid_all, grid_sum,
                                       make_grid)
    from repro_torch.core.mask import structural
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.core.spgemm import spgemm_3d
    ones = np.ones(len(rows), np.float32)
    grid = (1, GRID_Q, GRID_Q)
    small = make_grid(GRID_Q, GRID_Q, 1)          # every rank: its groups
    rec, moved = {}, {}
    comm.reset_stats()
    with _regrid_clock() as regrids:
        for d in ("acol", "brow", "csub"):
            m = DistSpMat3D.from_global_coo((n, n), rows, cols, ones, GRID3,
                                            d, mesh=mesh)
            before = _sorted_coo(m.to_global_coo())
            m1 = m.regrid(grid, mesh=small)
            del m
            if m1 is not None:
                moved[d] = m1
                rec[d] = all(
                    x.dtype == y.dtype and np.array_equal(x.view(np.uint8),
                                                          y.view(np.uint8))
                    for x, y in zip(before, _sorted_coo(m1.to_global_coo())))
    rec["regrids"] = regrids
    if not moved:
        rec["retired"] = True
        return rec
    run = _RankRun(small)
    c3, ok = spgemm_3d(moved["acol"], moved["brow"], ARITHMETIC, mesh=small,
                       prod_cap=caps[0], out_cap=caps[1],
                       mask=structural(moved["csub"]), merge="deferred")
    live = c3.val.reshape(-1)[:int(c3.nnz.reshape(()))]
    total = grid_sum(live.double().sum().reshape(1), grid)
    rec["product"] = run.done(ok=grid_all(ok, grid), count=int(total))
    return rec


def _sorted_coo(coo):
    r, c, v = coo
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def regrid3d_rank(rank, port, backend, caps, out) -> None:
    """One rank of phase 22 (b): joins a world of eight, makes the 2x2x2
    grid and puts its record on ``out``."""
    import traceback
    from repro_torch.core import comm
    from repro_torch.core.dist import make_grid
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        L, q, _ = GRID3
        comm.init_world(rank, L * q * q, port, backend)
        _profiler_warmup()
        mesh = make_grid(q, q, L)
        n, r, c = _grid3_lower()
        out.put((rank, "22b", _regrid3d_operands(mesh, n, r, c, caps)))
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _check_regrid3d(recs) -> None:
    log(f"phase 22 (b), eight ranks on 2x2x2: phase 20's L as 'acol' and "
        f"'brow' and structural(L) as 'csub', each regridded to 1x2x2 in "
        f"the same world (ranks 4-7 retire)")
    for rk, r in enumerate(recs):
        kept = not r.get("retired")
        log(f"  rank {rk}: {_regrid_line(r['regrids'])}"
            + (f"; global COO bitwise before and after: "
               f"{[r[d] for d in ('acol', 'brow', 'csub')]}" if kept else ""))
        if kept != (rk < GRID_Q * GRID_Q) or \
                (kept and not all(r[d] for d in ("acol", "brow", "csub"))):
            raise AssertionError(f"2x2x2 -> 1x2x2, rank {rk}: kept {kept}, "
                                 f"records {r}")
    prods = [r["product"] for r in recs[:GRID_Q * GRID_Q]]
    counts = set(_per_rank(prods, "count"))
    log(f"  masked tricount product on 1x2x2 (spgemm_3d, caps "
        f"{ONE_BY_ONE['caps_122'][:2]}): {sorted(counts)} triangles on "
        f"ranks 0-3, every ok flag up: {all(_per_rank(prods, 'ok'))}; wall "
        f"{max(_per_rank(prods, 'wall')) * 1e3:.1f} ms")
    if counts != {EXPECTED_TRIANGLES} or not all(_per_rank(prods, "ok")):
        raise AssertionError(f"1x2x2 tricount: {counts}")
    _rank_lines("1x2x2 tricount product", prods)


def elastic_phase(graph, mesh) -> dict:
    """Phase 22: (a) and (c) on four ranks (2x2 -> 1x1), (b) on eight
    (2x2x2 -> 1x2x2). Returns segreduce's launches by route on each
    rank's measured runs (each held on its rank) and the max abs err."""
    import os
    import shutil
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    ELASTIC_TRACE.parent.mkdir(parents=True, exist_ok=True)
    for old in ELASTIC_TRACE.parent.glob(f"{ELASTIC_TRACE.stem}.rank*"):
        old.unlink()
    torch.cuda.empty_cache()
    world = GRID_Q * GRID_Q
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=elastic_rank, daemon=True,
                         args=(rk, port, backend,
                               ONE_BY_ONE["hipmcl_grid"][0], out))
             for rk in range(world)]
    # the ranks' environment names the trace; this process records nothing
    os.environ["REPRO_TRACE"] = str(ELASTIC_TRACE)
    try:
        for p in procs:
            p.start()
    finally:
        del os.environ["REPRO_TRACE"]
    ranks, errs = _run_ranks(
        procs, out, {"22a": lambda recs: _check_elastic_grid(recs, mesh,
                                                              graph)},
        world, "phase 22 (a)", started=True)
    _check_elastic_traces(ONE_BY_ONE.pop("elastic_coverage"))
    n, r, c = _grid3_lower()
    small = (1, GRID_Q, GRID_Q)
    ONE_BY_ONE["caps_122"] = caps_3d(r, c, n, small, True)
    world3 = math.prod(GRID3)
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=regrid3d_rank, daemon=True,
                         args=(rk, port, backend, ONE_BY_ONE["caps_122"],
                               out))
             for rk in range(world3)]
    ranks3, errs3 = _run_ranks(procs, out, {"22b": _check_regrid3d}, world3,
                               "phase 22 (b)")
    log(f"phase 22: {time.perf_counter() - t0:.1f} s; segreduce launches by "
        f"rank of (a) {ranks} and (b) {ranks3}, each held against the plain "
        f"version on its rank (max abs err "
        f"{max(errs['segreduce'], errs3['segreduce']):.3g})")
    if sum(sum(x.values()) for x in ranks + ranks3) < 1:
        raise AssertionError("phase 22 launched no segreduce")
    return {"2x2->1x1": ranks, "2x2x2->1x2x2": ranks3,
            "max_abs_err": max(errs["segreduce"], errs3["segreduce"])}


# --------------------------------------------------------------------------
# phase 28: the sharding layer — qwen2-moe-a2.7b under a ShardingPlan with
# expert-parallel MoE on a (data=2, model=2) mesh, four ranks sharing the card
# --------------------------------------------------------------------------

def _ep_cut_cfg():
    """(a)'s and (d)'s model: phase 7's cut to E2E_LAYERS layers in f32."""
    from repro_torch.configs import get_config
    return get_config(SERVE_ARCH).scaled(n_layers=E2E_LAYERS,
                                         dtype="float32",
                                         param_dtype="float32")


def _ep_prompt(vocab, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (EP_BATCH, S))


def _ep_half() -> int:
    return EP_BATCH // EP_MESH[0]


def ep_reference(model, params, prompt) -> None:
    """Phase 28 (b)'s reference, run by phase 7 on its model: each data
    shard's rows alone (rows 0-1, then 2-3) through ``greedy_generate``
    (prefill + EP_TOKENS tokens); their last-position prefill logits and
    tokens kept on the host in EP_REFERENCE."""
    from repro_torch.serve import greedy_generate
    half, logits, tokens = _ep_half(), [], []
    for d in range(EP_MESH[0]):
        first = []
        tok = greedy_generate(
            model, params, prompt[d * half:(d + 1) * half],
            EP_PROMPT + EP_TOKENS + 1, EP_TOKENS, device="cuda",
            on_logits=lambda lg: first.append(lg.float().cpu())
            if not first else None)
        logits.append(first[0])
        tokens.append(tok.cpu())
    EP_REFERENCE.update(prefill=torch.cat(logits), tokens=torch.cat(tokens))
    log(f"phase 28 (b)'s reference: rows 0-{half - 1} and {half}-"
        f"{EP_BATCH - 1} alone, prefill + {EP_TOKENS} tokens each; tokens "
        f"{EP_REFERENCE['tokens'].tolist()}")


def ep_alone() -> dict:
    """Phase 28 without the phases before it: phase 7's model made on the
    card from the same seed for (b)'s reference, then ``ep_phase``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    cfg = get_config(SERVE_ARCH).scaled(param_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cuda")
    ep_reference(Model(cfg), params,
                 _ep_prompt(cfg.vocab, SERVE_PROMPT, 0))
    del params
    torch.cuda.empty_cache()
    return ep_phase()


def _digest_t(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def _ep_transport(mesh) -> dict:
    """One 64 MiB gather over 'model' through the card's mailbox (3 calls)
    and staged through pinned host memory over gloo (1 call, the staged
    path's own function), host seconds each: what the mailbox saves a
    gather."""
    from repro_torch.core import comm
    mc = comm.mesh_comm(mesh)
    x = torch.ones(32 << 20, dtype=torch.bfloat16, device="cuda")

    def staged():
        return comm._from_wire(comm._gathered_wire(x, mc, "model"),
                               x).view(x.dtype)

    out = {}
    for what, gather, n in (
            ("card", lambda: comm.all_gather(x, mc, "model"), 3),
            ("staged", staged, 1)):
        if what == "card" and comm._CARD is None:
            continue
        secs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = gather()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if not bool((y == 1).all()):
            raise AssertionError(f"the {what} gather moved wrong bytes")
        out[what] = min(secs)
    return out


def _held_record(held) -> dict:
    """``_bsr_hold``'s record without the kept operands."""
    return dict(calls=held["calls"], rows=sorted(held["rows"]),
                max_abs_err=held["max_abs_err"])


def _check_held(part, rk, held, launches) -> None:
    """Every ``bsr_spmm`` launch of a rank's run held, each at R = EP_R."""
    if held["calls"] != launches or held["rows"] != [EP_R]:
        raise AssertionError(f"({part}) rank {rk}: {held['calls']} bsr_spmm "
                             f"calls held at R {held['rows']}, for "
                             f"{launches} launches at R = {EP_R}")


def _ep_cut(mesh, rank):
    """(a) on one rank: the 2-layer f32 cut under the plan, two forwards of
    the global EP_BATCH x EP_E2E_PROMPT batch. Returns (the record, the
    parameters, the plan)."""
    from repro_torch.dist import shardings as sh
    from repro_torch.kernels import bsr_spmm as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import Model, init_params
    cfg = _ep_cut_cfg()
    plan = make_plan(cfg, mesh=mesh, moe_ep=True)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", plan=plan)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens = torch.as_tensor(_ep_prompt(cfg.vocab, EP_E2E_PROMPT, 2),
                             device="cuda")
    model = Model(cfg, plan)
    _zero_launches()
    runs = []
    with _bsr_hold() as held:
        for _ in range(2):
            with torch.no_grad():
                lg, aux, _ = model(params, dict(tokens=tokens))
            whole = sh.gather(lg, axes=(plan.model_axis,))  # its shard's rows
            runs.append((whole, float(aux)))
    launches = (fa.launches, bs.launches)
    d = sh.dp_index(plan)
    ref, _ = torch.load(EP_DIR / f"ref_a_{d}.pt")
    # the plan's aux is the mean of the data shards' (the reference's pmean)
    ref_aux = sum(torch.load(EP_DIR / f"ref_a_{k}.pt")[1]
                  for k in range(EP_MESH[0])) / EP_MESH[0]
    err = float((runs[0][0].cpu() - ref).abs().max())
    # a call that needs a gradient raises (the expert sum carries none)
    from repro_torch.models import layers as L
    x = torch.zeros(1, 8, cfg.d_model, device="cuda", requires_grad=True)
    layer = {k: sh.local(v)[0] for k, v in params["blocks"]["pos0"].items()}
    try:
        L.moe_block_ep(x, layer, cfg, plan)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    rec = dict(data=d, launches=launches, t_init=t_init, err=err,
               refused=refused, bsr_held=_held_record(held),
               aux=runs[0][1], aux_err=abs(runs[0][1] - ref_aux),
               scale=float(ref.abs().max()),
               digests=[_digest_t(w) for w, _ in runs],
               finite=all(bool(torch.isfinite(w).all()) for w, _ in runs),
               shape=tuple(runs[0][0].shape),
               transport=_ep_transport(mesh))
    return rec, params, plan


def _ep_restore(params, cfg, rank):
    """(d) on one rank: (a)'s parameters saved from (2, 2), restored onto
    (4, 1) and (1, 4) (``reshard_restore``); each rank's block of each leaf
    against the saved global leaf (gathered from (2, 2)) sliced by the new
    spec, bitwise."""
    import shutil
    from repro_torch.core import comm
    from repro_torch.dist import shardings as sh
    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.launch.mesh import make_mesh, make_plan
    from repro_torch.models.model import init_param_specs
    from repro_torch.train.checkpoint import save_checkpoint
    ckpt = EP_DIR / "ckpt"
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt), 0, params)
    rec = {"save": time.perf_counter() - t0, "leaves": 0}
    meshes = {shape: make_mesh(shape, EP_AXES, device="cuda")
              for shape in EP_RESTORE}
    for shape, m in meshes.items():
        specs = init_param_specs(cfg, make_plan(cfg, mesh=m, moe_ep=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, step = reshard_restore(str(ckpt), params, mesh=m, specs=specs)
        torch.cuda.synchronize()
        rec[f"restore {shape}"] = time.perf_counter() - t0
        n = 0
        for got, saved, spec in zip(_leaves(tree), _leaves(params),
                                    _leaves(specs)):
            want = sh.local_shard(sh.gather(saved), spec, m)
            if got.placements != sh.placements(spec, m) or \
                    not torch.equal(sh.local(got), want):
                raise AssertionError(f"(d): a block on {shape} differs "
                                     f"from the saved leaf's")
            n += 1
        rec["leaves"] = n
        if step != 0:
            raise AssertionError(f"(d): restored step {step}")
        del tree
    comm.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return rec


def _ep_full(mesh, rank):
    """(b) on one rank: qwen2-moe-a2.7b at full width and depth in bf16,
    each rank drawing each leaf and keeping its block; phase 7's prompt
    through ``greedy_generate``, a cold run and a measured warm run (every
    launch count and the exchange accounting set to 0 just before it). The
    cold run holds every bsr_spmm call and the first flash_attention call
    against the plain version, and on rank 0 keeps layer 0's we_g and we_2
    operands of the prefill and of the first decode step for (c); the warm
    run is the main path alone. Returns (the record, (c)'s operands)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.dist import shardings as sh
    from repro_torch.kernels import bsr_spmm as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import Model, init_params
    from repro_torch.serve import greedy_generate
    cfg = get_config(SERVE_ARCH).scaled(param_dtype="bfloat16")
    plan = make_plan(cfg, mesh=mesh, moe_ep=True)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", plan=plan)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    held_bytes = sum(sh.local(v).numel() * sh.local(v).element_size()
                     for v in _leaves(params))
    model = Model(cfg, plan)
    prompt = _ep_prompt(cfg.vocab, EP_PROMPT, 0)         # phase 7's
    max_len = EP_PROMPT + EP_TOKENS + 1
    run = lambda hook: greedy_generate(model, params, prompt, max_len,  # noqa
                                       EP_TOKENS, device="cuda",
                                       on_logits=hook)
    m = 3 * sum(cfg.layer_moe())         # bsr_spmm calls a forward
    keep = (0, 2, m, m + 2) if rank == 0 else ()
    cold = _Clock((fa, bs), keep_logits=False)
    with _bsr_hold(keep) as bheld, _flash_hold() as held:
        cold.start()
        run(cold)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_stats()
    _zero_launches()
    clock = _Clock((fa, bs))
    clock.start()
    t0 = time.perf_counter()
    tokens = run(clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(before=before, t_init=t_init, held_bytes=held_bytes,
               wall=wall,
               cold_prefill=cold.walls[0], walls=clock.walls,
               launches=(fa.launches, bs.launches),
               per_forward=clock.launches, other=_other_launches((fa, bs)),
               peak=torch.cuda.max_memory_allocated(),
               comm=copy.deepcopy(comm.stats), held=dict(held),
               bsr_held=_held_record(bheld),
               prefill=clock.logits[0], tokens=tokens.cpu(),
               finite=all(bool(torch.isfinite(lg).all())
                          for lg in clock.logits))
    del params
    torch.cuda.empty_cache()
    return rec, bheld["ops"]


def _ep_hold_bsr(ops) -> dict:
    """(c) on rank 0, the other ranks waiting: layer 0's we_g and we_2
    launches of (b)'s prefill and first decode step (this rank's
    E / model_size experts) held against the plain version and timed
    beside the bound and ``torch.bmm`` (its E_loc experts)."""
    from repro_torch.kernels import bsr_spmm as bs
    out = {}
    before = bs.launches
    for what, op in zip(EP_TIMED, ops):
        cols, vals, x = (t.cuda() for t in op)
        R, _, C, bk = vals.shape
        got, want = bs.bsr_spmm(cols, vals, x), bs.bsr_spmm_plain(cols, vals,
                                                                  x)
        err = _bsr_close(got, want, cols, vals, x)
        xe, w = vals[:, 0], x.reshape(R, bk, -1)
        ms = cuda_time_ms(lambda: bs.bsr_spmm(cols, vals, x), iters=10)
        lib = cuda_time_ms(lambda: torch.bmm(xe, w), iters=10)
        plain = cuda_time_ms(lambda: bs.bsr_spmm_plain(cols, vals, x),
                             iters=3, warmup=1)
        bound, by, flops, nbytes, nblocks = _bsr_bound(cols, vals, x)
        out[what] = dict(R=R, C=C, bk=bk, n=x.shape[1], experts=nblocks,
                         ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by, max_abs_err=err,
                         gflop=flops / 1e9, mb=nbytes / 1e6)
    bs.launches = before                # the held launches do not count
    return out


def ep_rank(rank, port, backend, out) -> None:
    """One rank of phase 28: joins the world, makes the (2, 2) mesh on its
    card and puts (a), (d), (b) and (c)'s records on ``out`` (a failure
    puts its traceback there instead)."""
    import gc
    import traceback
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_mesh
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        comm.init_world(rank, math.prod(EP_MESH), port, backend)
        mesh = make_mesh(EP_MESH, EP_AXES, device="cuda")
        mem = lambda: f"{torch.cuda.memory_allocated() / 2**30:.3f}"  # noqa
        rec, params, plan = _ep_cut(mesh, rank)
        out.put((rank, "a", rec))
        log(f"  phase 28 rank {rank}: (a) done, {mem()} GiB allocated")
        out.put((rank, "d", _ep_restore(params, _ep_cut_cfg(), rank)))
        del params, plan
        gc.collect()                      # DTensor trees hold cycles
        torch.cuda.empty_cache()
        log(f"  phase 28 rank {rank}: (d) done, {mem()} GiB allocated")
        rec, ops = _ep_full(mesh, rank)
        out.put((rank, "b", rec))
        comm.barrier()                    # the card is rank 0's alone
        if rank == 0:
            out.put((rank, "c", _ep_hold_bsr(ops)))
        comm.barrier()
        comm.close_world()
    except BaseException:                                  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
        raise


def _ep_collect(procs, out, world, checks) -> dict:
    """Each part's records from ``out``, by part and rank, each part checked
    (``checks[part](records)``) as soon as every rank has reported it;
    fails on a rank's error or on a part not reported within
    EP_TIMEOUT_S."""
    import queue
    got = {k: {} for k in checks}
    need = {k: 1 if k == "c" else world for k in checks}
    try:
        for part in checks:
            while len(got[part]) < need[part]:
                try:
                    rk, key, rec = out.get(timeout=EP_TIMEOUT_S)
                except queue.Empty:
                    raise AssertionError(
                        f"phase 28 ({part}): ranks did not report within "
                        f"{EP_TIMEOUT_S} s") from None
                if key == "error":
                    raise AssertionError(f"phase 28: rank {rk} failed:\n"
                                         f"{rec}")
                got[key][rk] = rec
            checks[part](got[part])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"phase 28: ranks exited with {bad}")
    return got


def _tag(c, name) -> str:
    t = c["tags"].get(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    return (f"{t['calls']} calls, {t['bytes'] / 1e9:.3f} GB sent, "
            f"{t['seconds']:.3f} s")


def _check_ep_cut(recs) -> None:
    want = (2 * E2E_LAYERS, 2 * 3 * E2E_LAYERS)
    for rk, r in sorted(recs.items()):
        tr = r["transport"]
        log(f"  (a) rank {rk} (data shard {r['data']}): init_params "
            f"{r['t_init']:.2f} s; logits {r['shape']} max |dlogit| "
            f"{r['err']:.3g} against the plan-less forward of its rows "
            f"(tolerance {E2E_LOGIT_TOL}, logits up to {r['scale']:.2f}); "
            f"aux {r['aux']:.6f} (|d| {r['aux_err']:.2g}); launches "
            f"(flash_attention, bsr_spmm) {r['launches']}; digests "
            f"{r['digests']}; a 64 MiB gather over 'model': card mailbox "
            f"{tr.get('card', float('nan')) * 1e3:.2f} ms, staged over gloo "
            f"{tr['staged'] * 1e3:.1f} ms; a CUDA call that needs a "
            f"gradient: {r['refused']!r}; {_held_text(r['bsr_held'])}")
        _check_held("a", rk, r["bsr_held"], r["launches"][1])
        if not r["finite"] or not r["err"] <= E2E_LOGIT_TOL:
            raise AssertionError(f"(a) rank {rk}: logits off by {r['err']}")
        if not r["aux_err"] <= 1e-6:
            raise AssertionError(f"(a) rank {rk}: aux off by {r['aux_err']}")
        if r["digests"][0] != r["digests"][1]:
            raise AssertionError(f"(a) rank {rk}: two runs differ")
        if r["launches"] != want:
            raise AssertionError(f"(a) rank {rk}: launches {r['launches']}, "
                                 f"not {want}")
        if not (r["refused"] or "").startswith("moe_block_ep"):
            raise AssertionError(f"(a) rank {rk}: moe_block_ep on a CUDA "
                                 f"input that needs a gradient did not "
                                 f"refuse it ({r['refused']})")
    for a, b in EP_GROUPS:
        if recs[a]["digests"] != recs[b]["digests"]:
            raise AssertionError(f"(a): ranks {a} and {b} (one model group) "
                                 f"hold different logits")


def _held_text(h) -> str:
    return (f"{h['calls']} bsr_spmm calls at R {h['rows']} held against the "
            f"plain version (max abs err {h['max_abs_err']:.3g})")


def _check_ep_restore(recs) -> None:
    for rk, r in sorted(recs.items()):
        log(f"  (d) rank {rk}: save from {EP_MESH} {r['save']:.2f} s; "
            + "; ".join(f"restore onto {s} {r[f'restore {s}']:.2f} s"
                        for s in EP_RESTORE)
            + f"; {r['leaves']} leaves, every block bitwise the saved "
            "leaf's")


def _check_ep_full(recs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.model import vocab_padded
    ref = EP_REFERENCE
    cfg = get_config(SERVE_ARCH)
    moe_layers = sum(cfg.layer_moe())
    want_prefill = (cfg.n_layers, 3 * moe_layers)
    for rk, r in sorted(recs.items()):
        decode = sorted(r["walls"][1:])
        med = decode[len(decode) // 2]
        c = r["comm"]
        log(f"  (b) rank {rk}: {r['before'] / 2**30:.3f} GiB allocated "
            f"before; init_params {r['t_init']:.2f} s holding "
            f"{r['held_bytes'] / 1e9:.2f} GB; prefill cold (holds "
            f"included) {r['cold_prefill'] * 1e3:.1f} ms, warm "
            f"{r['walls'][0] * 1e3:.1f}"
            f" ms; decode per token (median of {len(decode)}) "
            f"{med * 1e3:.1f} ms (min {decode[0] * 1e3:.1f}, max "
            f"{decode[-1] * 1e3:.1f}); warm run {r['wall']:.3f} s; peak "
            f"{r['peak'] / 2**30:.3f} GiB; launches (flash_attention, "
            f"bsr_spmm) {r['launches']}, per forward {r['per_forward'][0]} "
            f"then {sorted(set(r['per_forward'][1:]))}; exchanges: leaf "
            f"gathers {_tag(c, 'leaf_gather')}, expert sums "
            f"{_tag(c, 'expert_sum')}; all {c['calls']} calls "
            f"{c['seconds']:.3f} s ({100 * c['seconds'] / r['wall']:.1f}% of "
            f"the wall); in the cold run, the first flash_attention call "
            f"held (max abs err "
            f"{r['held'].get('max_abs_err', float('nan')):.3g}) and "
            f"{_held_text(r['bsr_held'])}")
        _check_held("b", rk, r["bsr_held"], r["launches"][1])
        if not r["finite"]:
            raise AssertionError(f"(b) rank {rk}: non-finite logits")
        tok = r["tokens"]
        if int(tok.min()) < 0 or int(tok.max()) >= vocab_padded(cfg):
            raise AssertionError(f"(b) rank {rk}: tokens out of range")
        if r["per_forward"][0] != want_prefill or any(
                f != (0, 3 * moe_layers) for f in r["per_forward"][1:]) \
                or r["other"]:
            raise AssertionError(f"(b) rank {rk}: launches "
                                 f"{r['per_forward']}, other {r['other']}")
        if not r["held"]:
            raise AssertionError(f"(b) rank {rk}: no flash_attention held")
    first = recs[0]
    for rk, r in recs.items():
        if not torch.equal(r["tokens"], first["tokens"]) or \
                not torch.equal(r["prefill"], first["prefill"]):
            raise AssertionError(f"(b): rank {rk}'s tokens or prefill logits "
                                 f"differ from rank 0's")
    err = float((first["prefill"] - ref["prefill"]).abs().max())
    scale = float(ref["prefill"].abs().max())
    agree = float((first["tokens"] == ref["tokens"]).float().mean())
    bitwise = torch.equal(first["prefill"], ref["prefill"])
    log(f"  (b): last-position prefill logits within {err:.4g} of phase 7's "
        f"rows alone (2^-4 of max |logit| {scale:.2f} = "
        f"{EP_PREFILL_TOL * scale:.4g}; bitwise: {bitwise}); tokens agree at "
        f"{100 * agree:.1f}%: {first['tokens'].tolist()} vs "
        f"{ref['tokens'].tolist()}")
    # each (token, choice) row has one owner, so the sum over 'model' is
    # exact and the combine is moe_block's: the plan-less model's bits
    if not bitwise or not torch.equal(first["tokens"], ref["tokens"]):
        raise AssertionError(f"(b): prefill logits (off by {err}) or tokens "
                             f"differ from phase 7's rows alone")
    return {"prefill_err": err, "token_agreement": agree}


def _check_ep_shape(c) -> None:
    if tuple(c) != EP_TIMED:
        raise AssertionError(f"(c): timed {tuple(c)}, not {EP_TIMED}")
    for what, r in c.items():
        log(f"  (c) rank 0's layer-0 {what} at the EP shape (R={r['R']} K=1 "
            f"bm=C={r['C']} bk={r['bk']} n={r['n']} bf16, {r['experts']} "
            f"experts with tokens): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.bmm ({r['R']} experts) "
            f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['gflop']:.1f} GFLOP, {r['mb']:.1f} MB), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it; held (max abs err "
            f"{r['max_abs_err']:.3g})")
        if r["R"] != EP_R:
            raise AssertionError(f"(c): R = {r['R']}, not {EP_R}")


def ep_phase() -> dict:
    """Phase 28: (a)'s reference here (the plan-less forward of each data
    shard's rows on the card), then four ranks. Returns the launches by
    rank of flash_attention and bsr_spmm over (a) and (b), (c)'s records
    and the held max abs errors."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.models import Model, init_params
    t0 = time.perf_counter()
    if "prefill" not in EP_REFERENCE:
        raise AssertionError("phase 28 needs phase 7's reference")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    EP_DIR.mkdir(parents=True)
    cfg = _ep_cut_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    prompt = torch.as_tensor(_ep_prompt(cfg.vocab, EP_E2E_PROMPT, 2),
                             device="cuda")
    half = _ep_half()
    with torch.no_grad():
        for d in range(EP_MESH[0]):
            lg, aux, _ = Model(cfg)(params, dict(
                tokens=prompt[d * half:(d + 1) * half]))
            torch.save((lg.cpu(), float(aux)), EP_DIR / f"ref_a_{d}.pt")
    del params, lg
    torch.cuda.empty_cache()
    world = math.prod(EP_MESH)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    log(f"phase 28: {SERVE_ARCH} under make_plan(mesh=(data={EP_MESH[0]}, "
        f"model={EP_MESH[1]}), moe_ep=True), {world} ranks on "
        f"{torch.cuda.device_count()} card(s), backend {backend}"
        + ("" if backend == "nccl" else " (leaf gathers and expert sums "
           "cross through the card's memory: comm.CardMailbox)"))
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=ep_rank, daemon=True,
                         args=(rk, port, backend, out))
             for rk in range(world)]
    for p in procs:
        p.start()
    b = {}
    got = _ep_collect(procs, out, world, {
        "a": _check_ep_cut, "d": _check_ep_restore,
        "b": lambda recs: b.update(_check_ep_full(recs)),
        "c": lambda recs: _check_ep_shape(recs[0])})
    c = got["c"][0]
    launches = {rk: tuple(a + b_ for a, b_ in zip(got["a"][rk]["launches"],
                                                  got["b"][rk]["launches"]))
                for rk in range(world)}
    flash_err = max(got["b"][rk]["held"]["max_abs_err"]
                    for rk in range(world))
    log(f"phase 28: {time.perf_counter() - t0:.1f} s with the ranks' "
        f"start-up; launches (flash_attention, bsr_spmm) of (a) and (b) by "
        f"rank {launches}")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    return {"flash_attention": [launches[rk][0] for rk in range(world)],
            "bsr_spmm": [launches[rk][1] for rk in range(world)],
            "ep_shape": c, "flash_max_abs_err": flash_err,
            "bsr_max_abs_err": max(
                [r["max_abs_err"] for r in c.values()]
                + [got[part][rk]["bsr_held"]["max_abs_err"]
                   for part in "ab" for rk in range(world)]),
            **b}


# --------------------------------------------------------------------------
# phase 6: flash_attention kernel vs plain
# --------------------------------------------------------------------------

FLASH_MAIN = (4, 2048, 16, 128)      # (B, S, H, d) of phase 7's prefill
# (B, S, H, KVH, d, dv, causal) of phases 23-25's attention: MLA's first
# fill (d = qk_nope + qk_rope, dv = v_head_dim), qwen2-vl's prefill (GQA,
# 28 query heads over 4 KV heads) and hubert's encoder (non-causal)
FLASH_PATHS = {
    "deepseek-v2-lite-16b": (4, 2048, 16, 16, 192, 128, True),
    "qwen2-vl-7b": (4, 2048, 28, 4, 128, 128, True),
    "hubert-xlarge": (8, 1500, 16, 16, 80, 80, False),
}


def _want_route(d, dv, dtype, backward=False):
    """The route ``csrc/flash_attention{,_bwd}.cu`` should take for fresh
    (16-byte aligned) tensors and Skv > 0: bf16 with d and dv multiples of 8,
    64 <= d <= 192 and 64 <= dv <= 128 runs the forward's wgmma kernel; the
    backward's takes bf16 with d == dv, a multiple of 8 in 64..128."""
    if dtype != torch.bfloat16 or d % 8 or dv % 8:
        return "fma"
    if backward:
        return "wgmma" if d == dv and 64 <= d <= 128 else "fma"
    return "wgmma" if 64 <= d <= 192 and 64 <= dv <= 128 else "fma"


def _check_routes(what, got, want, must) -> None:
    """Print each case's route (``got``: case -> route) and fail unless it
    is ``want``'s, and unless ``must`` (a description -> (case, route)) holds
    every case it names."""
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    line = []
    for case, r in got.items():
        B, S, skv, kvh, d, dv, dtype, causal = case
        line.append(f"{S}/{skv}/{kvh}/{d}/{dv}/{short[dtype]}/"
                    f"{'c' if causal else 'n'}:{r}")
        if len(line) == 6:
            log("  " + "  ".join(line))
            line = []
    if line:
        log("  " + "  ".join(line))
    bad = {c: r for c, r in got.items() if r != want[c]}
    if bad:
        raise AssertionError(f"{what}: routes {bad} differ from "
                             f"{ {c: want[c] for c in bad} }")
    for desc, (case, r) in must.items():
        if got.get(case) != r:
            raise AssertionError(f"{what}: {desc} {case} took "
                                 f"{got.get(case)}, not {r}")
    log(f"{what} routes (S/Skv/KVH/d/dv/type/causal:route above): "
        f"{sum(r == 'wgmma' for r in got.values())} wgmma, "
        f"{sum(r == 'fma' for r in got.values())} fma; "
        f"{', '.join(f'{k} {r}' for k, (_, r) in must.items())}")


def _close(got, want, rtol, atol, what):
    """Max abs error; raises unless |got - want| <= atol + rtol |want|."""
    err = (got.double() - want.double()).abs()
    if not bool((err <= atol + rtol * want.double().abs()).all()):
        raise AssertionError(f"{what}: max err {float(err.max())} beyond "
                             f"{atol} + {rtol} |want|")
    return float(err.max()) if err.numel() else 0.0


def _flash_bound(q, k, v, causal):
    """Least time of attention on these inputs: q, k, v read once and o
    written once at 3.35 TB/s, or 2 (d + dv) FLOP a (query, visible key)
    pair at the bf16 tensor-core peak (the f32 FMA peak for f32 inputs)."""
    B, S, H, d = q.shape
    skv, dv = k.shape[1], v.shape[3]
    # visible pairs: bottom-right causal alignment, query i sees i + skv - S
    pairs = sum(min(skv, max(0, i + skv - S + 1)) for i in range(S)) \
        if causal else S * skv
    flops = 2 * B * H * (d + dv) * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + B * S * H * dv) \
        * q.element_size()
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def _sdpa(q, k, v, causal):
    """``F.scaled_dot_product_attention`` on (B, H, S, d) copies of q, k, v:
    GQA through ``enable_gqa`` (KV heads read in place), dv != d as it
    is."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = k.shape[2] != q.shape[2]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=gqa)


def _time_flash(fa, q, k, v, causal, what, tol) -> dict:
    """Hold one attention shape against the plain version and time it:
    kernel, plain version and the library call, beside the bound."""
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    err = _close(got, want, *tol, f"flash {what}")
    del got, want
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                      iters=20)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=causal), iters=5,
        warmup=1)
    library_ms = cuda_time_ms(_sdpa(q, k, v, causal), iters=20)
    bound, by, flops, nbytes = _flash_bound(q, k, v, causal)
    log(f"flash_attention {what} {str(q.dtype)[6:]} "
        f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} "
        f"ms; bound {bound:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB), {100 * bound / ms:.1f}% of it; max abs err "
        f"{err:.3g}")
    return {"shape": what, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms, "max_abs_err": err}


def check_flash_attention() -> dict:
    """Phase 6. Tolerance: f32 within 2e-5 (+ 2e-5 relative): another order
    of the same float32 sums; bf16 within 2^-7 (+ 2^-7 relative): the kernel
    rounds p to bf16 before P V (as the Pallas kernel) and both round the
    output once, so they part by about one bf16 ulp."""
    from repro_torch.kernels import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: (2e-5, 2e-5), bf16: (2.0 ** -7, 2.0 ** -7)}
    H = 16
    # (B, S, Skv, KVH, d, dv, dtype, causal). S = 130 and 2080 leave a ragged
    # last 128-row query tile; the bf16 cases at d = 64 and 128 run the
    # wgmma kernel
    cases = [(2 if S < 2048 else 1, S, S, kvh, d, d, dtype, causal)
             for S in (1, 77, 130, 2048, 2080) for d in (16, 64, 128)
             for kvh in (16, 4) for dtype in (f32, bf16)
             for causal in (True, False)]
    cases += [(1, 5, 300, 4, 128, 128, f32, True),
              (2, 33, 40, 2, 64, 64, bf16, True)]
    # Skv > S under the causal mask (a cache's alignment), Skv < S (rows that
    # see no key), GQA, on the wgmma kernel
    cases += [(2, 130, 300, 4, 64, 64, bf16, True),
              (1, 130, 2080, 4, 128, 128, bf16, True),
              (1, 300, 2080, 2, 128, 128, bf16, False),
              (2, 300, 40, 4, 64, 64, bf16, True)]
    # MLA's d = 192 with dv = 128, causal, and hubert's d = 80 without a
    # mask, over ragged S (bf16: the wgmma kernel's D = 192, DV = 128 and
    # D = DV = 128 over zero columns; f32: the FMA kernel)
    cases += [(2 if S < 2048 else 1, S, S, 16, 192, 128, dtype, True)
              for S in (1, 77, 130, 2080) for dtype in (f32, bf16)]
    cases += [(1, 130, 300, 16, 192, 128, bf16, True)]
    cases += [(2 if S < 1500 else 1, S, S, 16, 80, 80, dtype, False)
              for S in (1, 77, 130, 1500) for dtype in (f32, bf16)]
    # the wgmma kernel's other widths: MLA at ragged S with Skv beside S
    # (rows that see no key when S > Skv), d = 80 with GQA (KVH 4) under the
    # causal mask, d != dv both ways, d = 96 over zero columns
    cases += [(2, 77, 200, 16, 192, 128, bf16, True),
              (1, 300, 130, 16, 192, 128, bf16, True),
              (2, 130, 130, 4, 80, 80, bf16, True),
              (1, 77, 300, 4, 80, 80, bf16, True),
              (1, 300, 77, 4, 80, 80, bf16, True),
              (1, 130, 130, 4, 64, 128, bf16, True),
              (1, 130, 130, 4, 128, 64, bf16, False),
              (1, 77, 77, 16, 192, 64, bf16, True),
              (1, 130, 130, 16, 96, 96, bf16, True)]
    max_err = 0.0
    routes = {}
    for i, (B, S, skv, kvh, d, dv, dtype, causal) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        q = torch.randn(B, S, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, skv, kvh, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, skv, kvh, dv, generator=g, device="cuda").to(dtype)
        routes[cases[i]] = fa.route(q, k, v)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"flash_attention {tuple(got.shape)}/"
                                 f"{got.dtype} vs {tuple(want.shape)}/"
                                 f"{want.dtype}")
        err = _close(got, want, *tol[dtype],
                     f"flash_attention B={B} S={S} Skv={skv} KVH={kvh} "
                     f"d={d} dv={dv} {dtype} causal={causal}")
        max_err = max(max_err, err)
    log(f"flash_attention: {len(cases)} cases match the plain version (max "
        f"abs err {max_err:.3g}; causal and not, f32 and bf16, S in 1, 77, "
        f"130, 300, 1500, 2048, 2080, d in 16, 64, 80, 96, 128 and 192 (dv "
        f"= d, or 64 and 128 beside it), KVH 16 and 4 at H = 16; Skv of 40 "
        f"to 2080 beside S of 5 to 300)")

    B, S, H, d = FLASH_MAIN
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(B, S, H, d, generator=g, device="cuda")
               .to(bf16) for _ in range(3))
    main_case = (B, S, S, H, d, d, bf16, True)
    routes[main_case] = fa.route(q, k, v)
    must = {"FLASH_MAIN": (main_case, "wgmma"),
            "f32": ((2, 130, 130, 16, 128, 128, f32, True), "fma"),
            "d = 16": ((2, 130, 130, 16, 16, 16, bf16, True), "fma")}
    for arch, (B2, S2, H2, kvh, d2, dv2, causal) in FLASH_PATHS.items():
        qq = torch.empty(B2, S2, H2, d2, device="cuda", dtype=bf16)
        kk = torch.empty(B2, S2, kvh, d2, device="cuda", dtype=bf16)
        vv = torch.empty(B2, S2, kvh, dv2, device="cuda", dtype=bf16)
        case = (B2, S2, S2, kvh, d2, dv2, bf16, causal)
        routes[case] = fa.route(qq, kk, vv)
        must[arch] = (case, "wgmma")
        del qq, kk, vv
    _check_routes("flash_attention", routes,
                  {c: _want_route(c[4], c[5], c[6]) for c in routes}, must)
    main = _time_flash(fa, q, k, v, True, str(FLASH_MAIN), tol[bf16])
    record = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:62",
              "launches": None,
              "max_abs_err": max(max_err, main.pop("max_abs_err")), **main}
    del record["shape"]
    record["paths"] = {}
    for arch, (B, S, H, kvh, d, dv, causal) in FLASH_PATHS.items():
        g = torch.Generator(device="cuda").manual_seed(8)
        q = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf16)
        k = torch.randn(B, S, kvh, d, generator=g, device="cuda").to(bf16)
        v = torch.randn(B, S, kvh, dv, generator=g, device="cuda").to(bf16)
        rec = _time_flash(fa, q, k, v, causal, f"{arch} (B, S, H, KVH, d, "
                          f"dv) = {(B, S, H, kvh, d, dv)}", tol[bf16])
        record["max_abs_err"] = max(record["max_abs_err"],
                                    rec.pop("max_abs_err"))
        record["paths"][arch] = rec
        del q, k, v
    return record


# --------------------------------------------------------------------------
# phase 6b: bsr_spmm kernel vs plain (on phase 7's operands)
# --------------------------------------------------------------------------

def _bsr_close(got, want, cols, vals, x):
    """Max abs error; raises unless within the bound of any summation order,
    2 bk u (|A| @ |x|) with u = 2^-24 (both sum in float32), plus one
    rounding of a bf16 output on each side (2^-7 |want|)."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    bk = vals.shape[3]
    bound = 2 * bk * 2.0 ** -24 * bsr_spmm_plain(
        cols, vals.float().abs(), x.float().abs()).double()
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.double().abs()
    err = (got.double() - want.double()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"beyond the summation-order bound: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _bsr_bound(cols, vals, x):
    """Least time of y = A @ x for these operands: the stored blocks whose id
    is not -1 (the work this data needs), 2 bm bk n FLOP each at the bf16
    tensor-core peak; or bytes: those blocks and the x blocks they name,
    read once, the ids, and y written once, at 3.35 TB/s."""
    R, K, bm, bk = vals.shape
    n = x.shape[1]
    real = cols >= 0
    nblocks = int(real.sum())
    named = int(torch.unique(cols[real].clamp(max=x.shape[0] // bk - 1))
                .numel())
    flops = 2 * bm * bk * n * nblocks
    nbytes = (nblocks * bm * bk + named * bk * n + R * bm * n) \
        * vals.element_size() + cols.numel() * 4
    peak = BF16_FLOPS if vals.dtype == torch.bfloat16 else F32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes, nblocks


def check_bsr_spmm(paths: dict) -> dict:
    """Phase 6b: ``paths`` maps a served architecture (phase 7's first, then
    phase 23's) to the (block_cols, block_vals, x) of layer 0's ``we_g`` and
    ``we_2`` products in its prefill and of its ``we_g`` product in the first
    decode step. Each is held against the plain version and timed; the
    record's top-level times are phase 7's prefill ``we_g``."""
    from repro_torch.kernels import bsr_spmm as bs

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for arch, (main_ops, we2_ops, decode_ops) in paths.items():
        cases += [(f"{arch} layer 0 we_g", *main_ops),
                  (f"{arch} layer 0 we_2", *we2_ops),
                  (f"{arch} decode layer 0 we_g", *decode_ops),
                  (f"{arch} layer 0 we_g, f32", main_ops[0],
                   main_ops[1].float(), main_ops[2].float())]
    # random blocked-ELL at three densities with -1 padding, ragged shapes;
    # then, on the wgmma kernels (bf16, bk and n multiples of 8), K = 4
    # stored blocks a row with ids past x's last block and rows of padding
    # alone, at prefill's and decode's tile shapes, and bk = 48 (TMA fills
    # the rest of a 64-deep slice with zeros)
    for i, (R, K, bm, bk, n, nblk, density, dtype, oor, pad_rows) in enumerate(
            [(32, 4, 128, 128, 256, 8, 0.1, f32, 0, ()),
             (32, 4, 128, 128, 256, 8, 0.5, bf16, 0, ()),
             (32, 4, 128, 128, 256, 8, 1.0, f32, 0, ()),
             (7, 3, 5, 7, 9, 4, 0.6, bf16, 0, ()),
             (64, 1, 8, 2048, 1408, 64, 0.25, bf16, 0, ()),  # decode's shape
             (9, 2, 100, 64, 130, 6, 0.7, f32, 0, ()),
             (3, 1, 640, 48, 200, 2, 1.0, bf16, 0, ()),
             (16, 4, 256, 128, 512, 6, 0.8, bf16, 2, (3, 7)),
             (16, 4, 8, 256, 512, 6, 0.8, bf16, 2, (0, 5)),
             (8, 3, 130, 48, 136, 4, 0.9, bf16, 1, (2,)),
             (8, 3, 8, 48, 136, 4, 0.9, bf16, 1, (6,)),
             (6, 2, 960, 64, 136, 4, 0.9, bf16, 1, (4,))]):   # C = 960
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        cols = torch.randint(0, nblk + oor, (R, K), generator=g,
                             device="cuda", dtype=torch.int32)
        cols = torch.where(torch.rand(R, K, generator=g, device="cuda")
                           < density, cols, -1)
        if pad_rows:
            cols[list(pad_rows)] = -1
        vals = torch.randn(R, K, bm, bk, generator=g, device="cuda").to(dtype)
        x = torch.randn(nblk * bk, n, generator=g, device="cuda").to(dtype)
        cases.append((f"R={R} K={K} bm={bm} bk={bk} n={n} density "
                      f"{density} {dtype}, ids up to {nblk + oor - 1} of "
                      f"{nblk}, padding rows {pad_rows}", cols, vals, x))
    max_err = 0.0
    for name, cols, vals, x in cases:
        got = bs.bsr_spmm(cols, vals, x)
        want = bs.bsr_spmm_plain(cols, vals, x)
        torch.cuda.synchronize()
        try:
            max_err = max(max_err, _bsr_close(got, want, cols, vals, x))
        except AssertionError as e:
            raise AssertionError(f"bsr_spmm {name}: {e}") from e
    log(f"bsr_spmm: {len(cases)} cases match the plain version (max abs err "
        f"{max_err:.3g}, within 2 bk u |A||x| + one bf16 rounding)")
    del cases

    timed = {arch: _time_bsr_path(bs, arch, *ops)
             for arch, ops in paths.items()}
    first = next(iter(timed.values()))["prefill we_g"]
    return {"name": "bsr_spmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bsr_spmm.cu",
            "replaces": "src/repro/kernels/bsr_spmm.py:41",
            "launches": None, "max_abs_err": max_err,
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "paths": timed}


def _time_bsr_path(bs, arch, main_ops, we2_ops, decode_ops) -> dict:
    """Times of one architecture's three expert products: the kernel, the
    plain version (prefill ``we_g``) and ``torch.bmm`` over every expert,
    beside the bound of what this data needs."""
    out = {}
    for what, (cols, vals, x) in (("prefill we_g", main_ops),
                                  ("prefill we_2", we2_ops),
                                  ("decode we_g", decode_ops)):
        E, _, C, bk = vals.shape
        xe, w = vals[:, 0], x.reshape(E, bk, -1)
        decode = what.startswith("decode")
        ms = cuda_time_ms(lambda: bs.bsr_spmm(cols, vals, x),
                          iters=20 if decode else 10)
        lib = cuda_time_ms(lambda: torch.bmm(xe, w),
                           iters=20 if decode else 10)
        rec = {"ms": ms, "library_ms": lib}
        if what == "prefill we_g":
            rec["plain_ms"] = cuda_time_ms(
                lambda: bs.bsr_spmm_plain(cols, vals, x), iters=3, warmup=1)
        bound, by, flops, nbytes, nblocks = _bsr_bound(cols, vals, x)
        rec.update(bound_ms=bound, bound_by=by)
        line = (f"bsr_spmm {arch} {what} (R={E} K=1 bm=C={C} bk={bk} "
                f"n={x.shape[1]} bf16, {nblocks} experts with tokens): kernel "
                f"{ms:.4f} ms")
        if decode:
            rec["device_ms"] = kernel_device_ms(
                lambda: bs.bsr_spmm(cols, vals, x), "bsr_spmm_wgmma_kernel")
            line += (f" a call back to back (CUDA events; the host's enqueue "
                     f"paces it), {rec['device_ms']:.4f} ms of device time a "
                     f"launch (profiler)")
        if "plain_ms" in rec:
            line += f", plain {rec['plain_ms']:.4f} ms"
        line += (f", torch.bmm (all {E} experts) {lib:.4f} ms; bound "
                 f"{bound:.4f} ms by {by} ({flops / 1e9:.1f} GFLOP, "
                 f"{nbytes / 1e6:.1f} MB), {100 * bound / ms:.1f}% of it")
        if decode:
            line += f", {100 * bound / rec['device_ms']:.1f}% by device time"
        log(line)
        out[what] = rec
    return out


# --------------------------------------------------------------------------
# phase 6c: the flash_attention backward kernel vs its plain backward
# --------------------------------------------------------------------------

FLASH_TRAIN = (2, 4096, 16, 128)     # (B, S, H, d) of phase 26's attention


def _flash_grads(fa, q, k, v, do, causal):
    """The kernels' (o, lse) and (dq, dk, dv) for these operands: the
    forward kernel with its lse, then the backward kernel."""
    B, S, H, _ = q.shape
    o = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device="cuda")
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    fa._launch(q, k, v, o, causal, lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fa._launch_backward(q, k, v, o, lse, do, dq, dk, dv, causal)
    return o, lse, (dq, dk, dv)


def _grad_close(got, want, rtol, frac, what):
    """Max abs error; raises unless |got - want| <= rtol |want| + frac
    max|want| (the gradient's own scale: its sums run over S or Skv
    terms in another order)."""
    scale = float(want.double().abs().max()) if want.numel() else 0.0
    return _close(got, want, rtol, frac * scale, what)


def _flash_bwd_bound(q, k, v, causal):
    """Least time of the backward on these inputs: 2 (3 d + 2 dv) FLOP a
    (query, visible key) pair (Q K^T and dO V^T again, dV, dK, dQ) at the
    bf16 tensor-core peak (f32 FMA for f32), or q, k, v, o, dO and lse read
    once and dq, dk, dv written once at 3.35 TB/s."""
    B, S, H, d = q.shape
    skv, dv = k.shape[1], v.shape[3]
    pairs = sum(min(skv, max(0, i + skv - S + 1)) for i in range(S)) \
        if causal else S * skv
    flops = 2 * B * H * (3 * d + 2 * dv) * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel()
                  + 2 * B * S * H * dv) * q.element_size() + B * H * S * 4
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def check_flash_backward() -> dict:
    """Phase 6c. Over causal and not, f32 and bf16, ragged S (130, 2080),
    Skv beside S (bottom right, and rows that see no key), GQA, d = dv in
    16, 64, 128, d = 80 and MLA's d = 192 with dv = 128: the forward
    kernel's lse against the plain version's (within 1e-4 absolute: the
    wgmma kernel's exp2 and log2 are approximate), and the backward
    kernel's dq, dk, dv against ``flash_attention_backward_plain`` on the
    same (q, k, v, o, lse, dO). Tolerance: f32 within 1e-4 |want| + 1e-4
    max|want|, bf16 within 2^-7 |want| + 2^-9 max|want| (one bf16 rounding
    of each store, and sums of up to 4,096 float32 terms in another order).
    Then at phase 26's (2, 4096, 16, 128) bf16 causal: the backward's time
    beside its bound, the plain backward and SDPA's backward, and the
    forward kernel with and without lse."""
    from repro_torch.kernels import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: (1e-4, 1e-4), bf16: (2.0 ** -7, 2.0 ** -9)}
    H = 16
    cases = [(2 if S < 2048 else 1, S, S, kvh, d, d, dtype, causal)
             for S in (130, 2080) for d in (16, 64, 128)
             for kvh in (16, 4) for dtype in (f32, bf16)
             for causal in (True, False)]
    cases += [(2, 130, 300, 4, 64, 64, bf16, True),       # Skv > S
              (2, 300, 40, 4, 64, 64, bf16, True),        # rows see no key
              (1, 300, 2080, 2, 128, 128, f32, False),
              (1, 77, 33, 16, 128, 128, f32, True)]
    cases += [(1, S, S, 16, 192, 128, dtype, True) for S in (130, 2080)
              for dtype in (f32, bf16)]
    cases += [(1, S, S, 16, 80, 80, dtype, False) for S in (130, 1500)
              for dtype in (f32, bf16)]
    # the wgmma backward's edges: rows that see no key (S > Skv, causal),
    # GQA groups of 2 (KVH 8) and 4 (KVH 4) at d = 64 and 128 with ragged
    # tiles, Skv > S with a group of 2, d = 80 causal over zero columns
    cases += [(1, 300, 100, 4, 128, 128, bf16, True),
              (1, 130, 130, 8, 64, 64, bf16, True),
              (1, 130, 130, 8, 128, 128, bf16, False),
              (1, 257, 257, 4, 64, 64, bf16, False),
              (1, 257, 257, 4, 128, 128, bf16, True),
              (1, 77, 300, 8, 128, 128, bf16, True),
              (1, 130, 130, 4, 80, 80, bf16, True)]
    max_err = lse_err = 0.0
    routes = {}
    for i, (B, S, skv, kvh, d, dv, dtype, causal) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        q = torch.randn(B, S, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, skv, kvh, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, skv, kvh, dv, generator=g, device="cuda").to(dtype)
        do = torch.randn(B, S, H, dv, generator=g, device="cuda").to(dtype)
        routes[cases[i]] = fa.backward_route(q, k, v)
        o, lse, got = _flash_grads(fa, q, k, v, do, causal)
        _, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                               return_lse=True)
        want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                 causal=causal)
        torch.cuda.synchronize()
        what = (f"B={B} S={S} Skv={skv} KVH={kvh} d={d} dv={dv} {dtype} "
                f"causal={causal}")
        fin = torch.isfinite(want_lse)
        if not torch.equal(fin, torch.isfinite(lse)):
            raise AssertionError(f"flash lse {what}: -inf rows differ")
        lse_err = max(lse_err, _close(lse[fin], want_lse[fin], 0.0, 1e-4,
                                      f"flash lse {what}"))
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f"flash {name} {what}: "
                                     f"{tuple(x.shape)}/{x.dtype} vs "
                                     f"{tuple(y.shape)}/{y.dtype}")
            max_err = max(max_err, _grad_close(x, y, *tol[dtype],
                                               f"flash {name} {what}"))
    log(f"flash_attention backward: {len(cases)} cases match the plain "
        f"backward (max abs err {max_err:.3g}; lse within {lse_err:.3g}; "
        f"causal and not, f32 and bf16, S in 77, 130, 257, 300, 1500, 2080, "
        f"Skv of 33 to 2080 beside them, d in 16, 64, 80, 128 and 192 (dv = "
        f"128), KVH 16, 8, 4 and 2 at H = 16)")

    B, S, H, d = FLASH_TRAIN
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, d, generator=g, device="cuda")
                   .to(bf16) for _ in range(4))
    train_case = (B, S, S, H, d, d, bf16, True)
    routes[train_case] = fa.backward_route(q, k, v)
    _check_routes("flash_attention backward", routes,
                  {c: _want_route(c[4], c[5], c[6], backward=True)
                   for c in routes},
                  {"FLASH_TRAIN": (train_case, "wgmma"),
                   "f32": ((2, 130, 130, 16, 128, 128, f32, True), "fma"),
                   "d = 16": ((2, 130, 130, 16, 16, 16, bf16, True), "fma"),
                   "MLA": ((1, 130, 130, 16, 192, 128, bf16, True), "fma")})
    o, lse, got = _flash_grads(fa, q, k, v, do, True)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             causal=True)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        max_err = max(max_err, _grad_close(x, y, *tol[bf16],
                                           f"flash {name} {FLASH_TRAIN}"))
    del want
    dq, dk, dv = got
    ms = cuda_time_ms(lambda: fa._launch_backward(
        q, k, v, o, lse, do, dq, dk, dv, True), iters=5, warmup=1)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_backward_plain(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
    fwd_ms = cuda_time_ms(lambda: fa._launch(q, k, v, o, True), iters=20)
    fwd_lse_ms = cuda_time_ms(lambda: fa._launch(q, k, v, o, True, lse),
                              iters=20)
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(lambda: out.backward(dot, retain_graph=True),
                              iters=10)
    del qt, kt, vt, out, dot
    bound, by, flops, nbytes = _flash_bwd_bound(q, k, v, True)
    log(f"flash_attention backward {FLASH_TRAIN} bf16 causal: kernel "
        f"{ms:.4f} ms, plain backward {plain_ms:.4f} ms, SDPA's backward "
        f"(torch.autograd) {library_ms:.4f} ms; bound {bound:.4f} ms by {by} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
        f"{100 * bound / ms:.2f}% of it; the forward kernel at this shape "
        f"{fwd_ms:.4f} ms without lse, {fwd_lse_ms:.4f} ms writing it")
    return {"source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "route": "cuda", "launches": None, "max_abs_err": max_err,
            "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "forward_ms": fwd_ms, "forward_lse_ms": fwd_lse_ms}


# --------------------------------------------------------------------------
# phase 6d: bsr_spmm's gradients on its kernel vs the plain backward
# --------------------------------------------------------------------------

def _bsr_grad_close(got, want, cols, vals, x, dy):
    """Max abs error of (dvals, dx); raises unless each is within the bound
    of any summation order, 2 L u (its product of absolute values) with L
    the terms a sum takes (n for dvals, every (r, t) of a column block
    times bm for dx) and u = 2^-24, plus one bf16 rounding (2^-7 |want|)."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_backward_plain
    mags = bsr_spmm_backward_plain(cols, vals.float().abs(), x.float().abs(),
                                   dy.float().abs())
    R, K, bm, _ = vals.shape
    lens = (x.shape[1], R * K * bm)
    err = 0.0
    for name, g, w, mag, n in zip(("dvals", "dx"), got, want, mags, lens):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        bound = 2 * n * 2.0 ** -24 * mag.double()
        if g.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -7 * w.double().abs()
        e = (g.double() - w.double()).abs()
        if not bool((e <= bound).all()):
            raise AssertionError(f"{name} beyond the summation-order bound: "
                                 f"max err {float(e.max())}")
        err = max(err, float(e.max()) if e.numel() else 0.0)
    return err


def _bsr_grads(bs, cols, vals, x, dy):
    """(dvals, dx) through the kernel's autograd Function."""
    vals = vals.detach().requires_grad_()
    x = x.detach().requires_grad_()
    y = bs.bsr_spmm(cols, vals, x)
    return torch.autograd.grad(y, (vals, x), dy)


def _expert_operands(g, C, bk, n, dtype=torch.bfloat16):
    """Random operands of one expert product at phase 26's shapes: 64
    padded experts of C rows, the 4 padding experts' ids -1."""
    E = 64
    cols = torch.arange(E, dtype=torch.int32, device="cuda").reshape(E, 1)
    cols[60:] = -1
    vals = torch.randn(E, 1, C, bk, generator=g, device="cuda").to(dtype)
    x = (torch.randn(E * bk, n, generator=g, device="cuda")
         / math.sqrt(bk)).to(dtype)
    dy = torch.randn(E * C, n, generator=g, device="cuda").to(dtype)
    return cols, vals, x, dy


def check_bsr_backward() -> dict:
    """Phase 6d: both gradients of ``bsr_spmm`` through its autograd
    Function (each a product on the kernel) against
    ``bsr_spmm_backward_plain``: at phase 26's ``we_g`` and ``we_2`` shapes
    (64 experts of C = 640 rows, 4 of them padding), and on random
    blocked-ELL operands with K up to 4, repeated column ids, ids past x's
    last block, rows of padding alone and column blocks no block names.
    Then at ``we_g``'s shape: the two products' times, the transposes'
    bytes and times, the plain backward's, and ``torch.bmm``'s two
    gradient products, beside the bound."""
    from repro_torch.kernels import bsr_spmm as bs

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(700)
    cases = [("phase 26 we_g (R=64 K=1 bm=640 bk=2048 n=1408)",
              *_expert_operands(g, 640, 2048, 1408)),
             ("phase 26 we_2 (R=64 K=1 bm=640 bk=1408 n=2048)",
              *_expert_operands(g, 640, 1408, 2048))]
    # (R, K, bm, bk, n, nblk, density, dtype, ids past the end, padding rows,
    # column blocks nobody names)
    for i, (R, K, bm, bk, n, nblk, density, dtype, oor, pad_rows,
            unnamed) in enumerate(
            [(32, 4, 128, 128, 256, 8, 0.5, bf16, 0, (), (2, 5)),
             (32, 4, 128, 128, 256, 8, 0.9, f32, 2, (3,), ()),
             (7, 3, 5, 7, 9, 4, 0.6, f32, 1, (0,), (1,)),
             (16, 4, 256, 128, 512, 6, 0.8, bf16, 2, (3, 7), (0,)),
             (8, 3, 130, 48, 136, 4, 0.9, bf16, 1, (2,), ()),
             (6, 2, 64, 64, 64, 4, 1.0, bf16, 0, (), (0, 1, 2))]):
        gi = torch.Generator(device="cuda").manual_seed(710 + i)
        cols = torch.randint(0, nblk + oor, (R, K), generator=gi,
                             device="cuda", dtype=torch.int32)
        cols = torch.where(torch.rand(R, K, generator=gi, device="cuda")
                           < density, cols, -1)
        for c in unnamed:
            cols = torch.where(cols == c, -1, cols)
        if pad_rows:
            cols[list(pad_rows)] = -1
        vals = torch.randn(R, K, bm, bk, generator=gi, device="cuda").to(dtype)
        x = torch.randn(nblk * bk, n, generator=gi, device="cuda").to(dtype)
        dy = torch.randn(R * bm, n, generator=gi, device="cuda").to(dtype)
        cases.append((f"R={R} K={K} bm={bm} bk={bk} n={n} {dtype}, ids up "
                       f"to {nblk + oor - 1} of {nblk}, padding rows "
                       f"{pad_rows}, unnamed blocks {unnamed}",
                       cols, vals, x, dy))
    max_err = 0.0
    for name, cols, vals, x, dy in cases:
        got = _bsr_grads(bs, cols, vals, x, dy)
        want = bs.bsr_spmm_backward_plain(cols, vals, x, dy)
        torch.cuda.synchronize()
        try:
            max_err = max(max_err, _bsr_grad_close(got, want, cols, vals, x,
                                                   dy))
        except AssertionError as e:
            raise AssertionError(f"bsr_spmm backward {name}: {e}") from e
    log(f"bsr_spmm backward: {len(cases)} cases match the plain backward "
        f"(max abs err {max_err:.3g}, within 2 L u |.||.| + one bf16 "
        f"rounding)")

    _, cols, vals, x, dy = cases[0]
    del cases
    R, K, bm, bk = vals.shape
    n = x.shape[1]
    nblk = x.shape[0] // bk
    dyv = dy.reshape(R, 1, bm, n)
    xt = x.reshape(nblk, bk, n).transpose(1, 2).reshape(nblk * n, bk)
    cols_t, vals_t = bs._transposed(cols, vals, nblk)
    t_dvals = cuda_time_ms(lambda: bs._kernel_product(cols, dyv, xt, bf16),
                           iters=10)
    t_dx = cuda_time_ms(lambda: bs._kernel_product(cols_t, vals_t, dy, bf16),
                        iters=10)
    t_xt = cuda_time_ms(lambda: x.reshape(nblk, bk, n).transpose(1, 2)
                        .contiguous(), iters=10)
    t_vt = cuda_time_ms(lambda: bs._transposed(cols, vals, nblk), iters=10)
    vg, xg = vals.detach().requires_grad_(), x.detach().requires_grad_()
    y = bs.bsr_spmm(cols, vg, xg)
    ms = cuda_time_ms(lambda: torch.autograd.grad(y, (vg, xg), dy,
                                                  retain_graph=True),
                      iters=10)
    del y, vg, xg
    plain_ms = cuda_time_ms(lambda: bs.bsr_spmm_backward_plain(
        cols, vals, x, dy), iters=3, warmup=1)
    xe, w, dye = vals[:, 0], x.reshape(R, bk, n), dy.reshape(R, bm, n)
    library_ms = cuda_time_ms(lambda: (torch.bmm(dye, w.transpose(1, 2)),
                                       torch.bmm(xe.transpose(1, 2), dye)),
                              iters=10)
    real = int((cols >= 0).sum())
    flops = 2 * 2 * bm * bk * n * real
    nbytes = (2 * real * bm * bk + 2 * real * bk * n + R * bm * n) * 2
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")
    log(f"bsr_spmm backward at phase 26's we_g shape (R={R} K=1 bm=C={bm} "
        f"bk={bk} n={n} bf16, {real} real experts): the Function's backward "
        f"{ms:.4f} ms (dvals product {t_dvals:.4f} ms, dx product "
        f"{t_dx:.4f} ms, x's transpose {xt.numel() * 2 / 1e6:.1f} MB in "
        f"{t_xt:.4f} ms, A^T's build {vals_t.numel() * 2 / 1e6:.1f} MB in "
        f"{t_vt:.4f} ms, its width {cols_t.shape[1]} read on the host), "
        f"plain backward {plain_ms:.4f} ms, torch.bmm's two products "
        f"{library_ms:.4f} ms; bound {bound:.4f} ms by {by} "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
        f"{100 * bound / ms:.1f}% of it")
    return {"source": "src/repro_torch/kernels/csrc/bsr_spmm.cu",
            "route": "cuda", "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "dvals_ms": t_dvals, "dx_ms": t_dx, "transpose_ms": t_xt + t_vt}


# --------------------------------------------------------------------------
# phase 7: qwen2-moe-a2.7b serving at full width and depth
# --------------------------------------------------------------------------

class _Clock:
    """``on_logits`` hook of ``greedy_generate``: the host-clock wall of each
    forward (ended by a synchronize), the launches it made of each kernel
    module in ``mods``, and its logits on the host."""

    def __init__(self, mods, keep_logits=True):
        self._mods = tuple(mods)
        self.keep = keep_logits
        self.walls, self.launches, self.logits = [], [], []

    def start(self):
        torch.cuda.synchronize()
        self._last = time.perf_counter()
        self._count = [m.launches for m in self._mods]

    def __call__(self, logits):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.walls.append(now - self._last)
        count = [m.launches for m in self._mods]
        self.launches.append(tuple(c - p for c, p in zip(count,
                                                          self._count)))
        self._last, self._count = now, count
        if self.keep:
            self.logits.append(logits.float().cpu())


def _zero_launches():
    """Every kernel module's launch count set to 0."""
    from repro_torch.kernels import (bsr_spmm, flash_attention, segreduce,
                                     semiring_matmul, ssd_chunk)
    for m in (segreduce, semiring_matmul, flash_attention, bsr_spmm,
              ssd_chunk):
        m.launches = 0


def _other_launches(mods) -> int:
    """Launches since the last ``_zero_launches`` of the kernels not in
    ``mods``."""
    from repro_torch.kernels import (bsr_spmm, flash_attention, segreduce,
                                     semiring_matmul, ssd_chunk)
    return sum(m.launches for m in (segreduce, semiring_matmul,
                                    flash_attention, bsr_spmm, ssd_chunk)
               if m not in mods)


@contextlib.contextmanager
def _bsr_capture(keep):
    """While open, the operands of the ``bsr_spmm`` calls whose index (from
    0) is in ``keep`` are copied to the host into the yielded list: they stay
    out of the peak memory of the runs that follow."""
    from repro_torch.kernels import bsr_spmm as bs
    ops, calls, wrapped = [], [0], bs.bsr_spmm

    def capture(cols, vals, x):
        if calls[0] in keep:
            ops.append(tuple(t.cpu() for t in (cols, vals, x)))
        calls[0] += 1
        return wrapped(cols, vals, x)

    bs.bsr_spmm = capture
    try:
        yield ops
    finally:
        bs.bsr_spmm = wrapped


@contextlib.contextmanager
def _bsr_hold(keep=()):
    """While open, every ``bsr_spmm`` call is held against the plain version
    on the same operands (``_bsr_close``), and the operands of the calls
    whose index (from 0) is in ``keep`` are copied to the host. The yielded
    dict gets the calls held, their block-row counts R, the max abs error
    and the kept operands (``ops``)."""
    from repro_torch.kernels import bsr_spmm as bs
    rec = dict(calls=0, rows=set(), max_abs_err=0.0, ops=[])
    wrapped = bs.bsr_spmm

    def hold(cols, vals, x):
        out = wrapped(cols, vals, x)
        if rec["calls"] in keep:
            rec["ops"].append(tuple(t.cpu() for t in (cols, vals, x)))
        rec["calls"] += 1
        rec["rows"].add(vals.shape[0])
        err = _bsr_close(out, bs.bsr_spmm_plain(cols, vals, x), cols, vals, x)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return out

    bs.bsr_spmm = hold
    try:
        yield rec
    finally:
        bs.bsr_spmm = wrapped


@contextlib.contextmanager
def _flash_hold(tol=(2.0 ** -7, 2.0 ** -7)):
    """While open, the first ``flash_attention`` call is held against the
    plain version on the same operands (bf16 tolerance of phase 6); the
    yielded dict gets its shape and max abs error."""
    from repro_torch.kernels import flash_attention as fa
    held, wrapped = {}, fa.flash_attention

    def hold(q, k, v, *, causal=True):
        out = wrapped(q, k, v, causal=causal)
        if not held:
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            held["shape"] = (tuple(q.shape), tuple(v.shape), causal)
            held["max_abs_err"] = _close(out, want, *tol,
                                         f"flash_attention {held['shape']}")
        return out

    fa.flash_attention = hold
    try:
        yield held
    finally:
        fa.flash_attention = wrapped


def _first_run_held(run, keep=()):
    """``run`` whose first call keeps the operands of the ``bsr_spmm`` calls
    numbered in ``keep`` (``_bsr_capture``) and holds its first
    ``flash_attention`` call against the plain version (``_flash_hold``).
    Returns (the wrapped run, the kept operands, the held call's record)."""
    ops, held, calls = [], {}, [0]

    def wrapped(hook):
        calls[0] += 1
        if calls[0] > 1:
            return run(hook)
        with _bsr_capture(keep) as got, _flash_hold() as h:
            out = run(hook)
        ops.extend(got)
        held.update(h)
        return out

    return wrapped, ops, held


def _log_held(held):
    if not held:
        raise AssertionError("the cold run made no flash_attention call")
    log(f"the cold run's first flash_attention call (q, v, causal) "
        f"{held['shape']} matches the plain version on the card (max abs err "
        f"{held['max_abs_err']:.3g})")


def _serve_runs(run, mods, B, S, T):
    """A cold run of ``run(on_logits) -> tokens`` (the kernels' first
    launches), then the measured warm run, every launch count set to 0 just
    before it. Prints prefill walls, decode per token, the whole run and
    the peak memory. Returns (the warm run's _Clock, its tokens, the
    launches of the kernels outside ``mods``)."""
    cold = _Clock(mods, keep_logits=False)
    cold.start()
    run(cold)
    torch.cuda.reset_peak_memory_stats()
    clock = _Clock(mods)
    _zero_launches()
    clock.start()
    t0 = time.perf_counter()
    tokens = run(clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    other = _other_launches(mods)
    peak = torch.cuda.max_memory_allocated()
    decode = sorted(clock.walls[1:])
    med = decode[len(decode) // 2]
    log(f"serve {B}x{S} prompt + {T} tokens: prefill cold "
        f"{cold.walls[0] * 1e3:.1f} ms, warm {clock.walls[0] * 1e3:.1f} ms; "
        f"decode per token (median of {len(decode)} steps) {med * 1e3:.2f} ms "
        f"(min {decode[0] * 1e3:.2f}, max {decode[-1] * 1e3:.2f}), "
        f"{B / med:.1f} tokens/s; whole run {wall:.3f} s, "
        f"{B * T / wall:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    return clock, tokens, other


def _check_serve(clock, tokens, other, names, prefill, decode, vp):
    """The warm run's launches per forward (``prefill``, then ``decode`` for
    every step) and nothing of the other kernels; finite logits; tokens in
    [0, vp)."""
    log(f"launches per forward ({', '.join(names)}): prefill "
        f"{clock.launches[0]}, decode steps {sorted(set(clock.launches[1:]))}"
        f"; other kernels {other}")
    tok = tokens.cpu().numpy()
    log(f"tokens (first sequence): {tok[0].tolist()}")
    if clock.launches[0] != prefill:
        raise AssertionError(f"prefill launched {clock.launches[0]}, not "
                             f"{prefill}")
    if any(c != decode for c in clock.launches[1:]) or other:
        raise AssertionError(f"decode steps launched "
                             f"{set(clock.launches[1:])}, not {decode}; "
                             f"{other} launches of other kernels")
    if not all(bool(torch.isfinite(lg).all()) for lg in clock.logits):
        raise AssertionError("non-finite logits")
    if tok.min() < 0 or tok.max() >= vp:
        raise AssertionError(f"tokens out of [0, {vp})")


def _profile_serve(prefill, step):
    with torch.inference_mode():
        log("profile of one warm prefill:")
        profile_breakdown(prefill)
        log("profile of one decode step:")
        profile_breakdown(step, top=12)


def serve_path():
    """Phase 7. Returns (flash_attention launches, bsr_spmm launches) of the
    warm run, and the operands of layer 0's ``we_g`` and ``we_2`` products in
    the prefill and of its ``we_g`` product in the first decode step (for
    6b)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bsr_spmm as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model, init_params
    from repro_torch.models.model import vocab_padded
    from repro_torch.serve import greedy_generate

    cfg = get_config(SERVE_ARCH).scaled(param_dtype="bfloat16")
    model = Model(cfg)
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    max_len = S + T + 1
    vp = vocab_padded(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}x{cfg.hd} heads, {cfg.n_experts} experts (padded "
        f"{params['blocks']['pos0']['router'].shape[-1]}) top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
        f"(padded {vp}); {nparam / 1e9:.3f} B stored parameters in bf16 "
        f"({nparam * 2 / 1e9:.2f} GB), init_params "
        f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))

    # the cold run keeps, for phase 6b, the operands of layer 0's we_g and
    # we_2 products (the first and third bsr_spmm calls) of its prefill and
    # of we_g in its first decode step
    moe_layers = sum(cfg.layer_moe())
    run, ops, held = _first_run_held(
        lambda hook: greedy_generate(model, params, prompt, max_len, T,
                                     device="cuda", on_logits=hook),
        keep=(0, 2, 3 * moe_layers))
    clock, tokens, other = _serve_runs(run, (fa, bs), B, S, T)
    _log_held(held)
    launched = (fa.launches, bs.launches)
    _check_serve(clock, tokens, other, ("flash_attention", "bsr_spmm"),
                 (cfg.n_layers, 3 * moe_layers), (0, 3 * moe_layers), vp)
    if launched != (cfg.n_layers, 3 * moe_layers * T):
        raise AssertionError(f"the run launched {launched}")

    # a teacher-forced forward over prompt + generated tokens, against the
    # decode-step logits: printed, not gated (bf16 routing flips near ties,
    # and capacity drops differ between an 8,192-token prefill, 4-token
    # decode steps and an 8,320-token forward); then the same with a
    # capacity of every token (no drops anywhere)
    _teacher_forced(model, params, prompt, tokens, clock.logits,
                    "capacity_factor 1.25")
    E = params["blocks"]["pos0"]["router"].shape[-1]
    nodrop = Model(cfg.scaled(capacity_factor=E / cfg.top_k))
    nd = _Clock((fa, bs))
    nd.start()
    nd_tokens = greedy_generate(nodrop, params, prompt, max_len, T,
                                device="cuda", on_logits=nd)
    _teacher_forced(nodrop, params, prompt, nd_tokens, nd.logits,
                    f"capacity_factor {E / cfg.top_k:g}, no drops")
    del nd
    _profile_cached(model, params, prompt, tokens, max_len)
    ep_reference(model, params, prompt)
    del params
    torch.cuda.empty_cache()
    return launched, tuple(ops)


def _profile_cached(model, params, prompt, tokens, max_len):
    """Profiles of one warm prefill and one decode step through
    ``make_prefill`` and ``make_serve_step``."""
    from repro_torch.serve import make_prefill, make_serve_step
    prefill, step = make_prefill(model), make_serve_step(model)
    B, S = prompt.shape
    prompt_t = torch.as_tensor(prompt, device="cuda").to(torch.int32)
    with torch.inference_mode():
        _, caches = prefill(params, model.init_cache(B, max_len,
                                                     device="cuda"), prompt_t)
    offset = torch.full((B,), S, dtype=torch.int32, device="cuda")
    _profile_serve(
        lambda: prefill(params, model.init_cache(B, max_len, device="cuda"),
                        prompt_t),
        lambda: step(params, caches, tokens[:, :1], offset))


def _teacher_forced(model, params, prompt, tokens, step_logits, what):
    """One forward without a cache over prompt + generated tokens, held
    against the logits of the greedy run's forwards (prefill, then each
    decode step) at the same positions."""
    full = torch.cat([torch.as_tensor(prompt, device="cuda")
                      .to(torch.int32), tokens], dim=1)
    return _teacher_forced_batch(model, params, dict(tokens=full),
                                 prompt.shape[1], step_logits, what)


def _teacher_forced_batch(model, params, batch, S, step_logits, what):
    """One forward without a cache over ``batch`` (a prompt of S positions
    and the tokens fed to the decode steps), its logits at positions S - 1
    on held against ``step_logits`` (the prefill's, then each step's)."""
    T = len(step_logits)
    with torch.inference_mode():
        tf, _, _ = model(params, batch)
        n = tf.shape[1]
        tf = tf[:, S - 1:S - 1 + T].float().cpu()
    steps = torch.stack(step_logits, dim=1)                  # (B, T, V)
    same = (tf.argmax(-1) == steps.argmax(-1)).float().mean()
    diff = (tf - steps).abs()
    log(f"teacher-forced forward over {n} positions vs the {T} "
        f"logits of the prefill and decode steps ({what}): max |dlogit| "
        f"{float(diff.max()):.4g}, mean {float(diff.mean()):.4g} (logits up "
        f"to {float(steps.abs().max()):.2f}), argmax agrees at "
        f"{100 * float(same):.1f}% of positions")
    return float(diff.max())


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --------------------------------------------------------------------------
# phase 7b: kernels against plain versions, end to end at full width
# --------------------------------------------------------------------------

def kernels_vs_plain_e2e(arch=SERVE_ARCH) -> None:
    """Phases 7b and 23b: ``arch`` cut to E2E_LAYERS layers (every width
    kept) in f32: ``greedy_generate`` on the CPU, where every kernel takes
    its plain version, and on the card, where the kernels run; the device
    alone picks the path. Logits within E2E_LOGIT_TOL, tokens equal. Then,
    on the card with a capacity that drops no token, the decode-step
    logits against a teacher-forced forward, within E2E_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bsr_spmm as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.serve import greedy_generate

    cfg = get_config(arch).scaled(n_layers=E2E_LAYERS, dtype="float32",
                                  param_dtype="float32")
    model = Model(cfg)
    B, S, T = E2E_BATCH, E2E_PROMPT, E2E_TOKENS
    gpu_params, cpu_params = _e2e_params(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    out = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        logits = []
        before = (fa.launches, bs.launches)
        t0 = time.perf_counter()
        tok = greedy_generate(model, p, prompt, S + T + 1, T, device=dev,
                              on_logits=lambda lg: logits.append(
                                  lg.float().cpu()))
        out[dev] = (tok.cpu(), torch.stack(logits))
        n = (fa.launches - before[0], bs.launches - before[1])
        log(f"e2e {dev}: {time.perf_counter() - t0:.2f} s, launches "
            f"(flash_attention, bsr_spmm) {n}")
        if (dev == "cpu") != (n == (0, 0)) or (dev == "cuda" and 0 in n):
            raise AssertionError(f"the {dev} run launched {n}")
    _same_e2e(out)
    # the cached path against a forward without a cache, on the card, with
    # a capacity that drops no token (as phase 7's last comparison, in f32)
    E = gpu_params["blocks"]["pos0"]["router"].shape[-1]
    nodrop = Model(cfg.scaled(capacity_factor=E / cfg.top_k))
    logits = []
    tok = greedy_generate(nodrop, gpu_params, prompt, S + T + 1, T,
                          device="cuda", on_logits=lambda lg: logits.append(
                              lg.float().cpu()))
    err = _teacher_forced(nodrop, gpu_params, prompt, tok, logits,
                          "f32, no drops")
    if not err <= E2E_LOGIT_TOL:
        raise AssertionError(f"decode and teacher-forced logits differ by "
                             f"{err}")


def _e2e_params(cfg):
    """``init_params(seed=0)`` made on the card and copied to the host (the
    card's generator: the same parameters on both sides, in seconds)."""
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    gpu = init_params(cfg, seed=0, device="cuda")
    cpu = _to(gpu, "cpu")
    log(f"e2e: {cfg.name} with {cfg.n_layers} layers in f32, "
        f"{sum(v.numel() for v in _leaves(cpu)) / 1e9:.3f} B parameters "
        f"made on the card and copied to the host "
        f"({time.perf_counter() - t0:.1f} s); "
        f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    return gpu, cpu


def _same_e2e(out):
    """The CPU's and the card's (tokens, logits) of one e2e run: tokens
    equal, logits within E2E_LOGIT_TOL."""
    (tc, lc), (tg, lg) = out["cpu"], out["cuda"]
    err = float((lc - lg).abs().max())
    log(f"e2e: tokens {tg.tolist()} (card) vs {tc.tolist()} (cpu); max "
        f"|dlogit| {err:.3g} (tolerance {E2E_LOGIT_TOL}, logits up to "
        f"{float(lc.abs().max()):.2f})")
    if not torch.equal(tc, tg):
        raise AssertionError("card and CPU tokens differ")
    if not err <= E2E_LOGIT_TOL:
        raise AssertionError(f"card and CPU logits differ by {err}")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# phases 23-25: MLA, qwen2-vl with image patches and hubert at full width
# --------------------------------------------------------------------------

def _full_model(arch):
    """``arch`` at full width and depth with bf16 parameters from
    ``init_params(seed=0)`` on the card: (cfg, Model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    cfg = get_config(arch).scaled(param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}; "
        f"{nparam / 1e9:.3f} B stored parameters in bf16 "
        f"({nparam * 2 / 1e9:.2f} GB), init_params "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, Model(cfg), params


def _cache_bytes(model, B, max_len) -> int:
    caches = model.init_cache(B, max_len, abstract=True)
    return sum(t.numel() * t.element_size() for c in caches.values()
               for k, t in c.items() if k != "offset")


def serve_mla():
    """Phase 23: deepseek-v2-lite-16b through ``greedy_generate`` with phase
    7's traffic. Returns ((flash_attention, bsr_spmm) launches of the warm
    run, the operands of layer 0's ``we_g``/``we_2`` prefill products and
    first-decode ``we_g`` product for 6b)."""
    from repro_torch.kernels import bsr_spmm as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import vocab_padded
    from repro_torch.serve import greedy_generate

    cfg, model, params = _full_model(MLA_ARCH)
    log(f"  MLA: {cfg.n_heads} heads, q/k {cfg.qk_nope_dim} + "
        f"{cfg.qk_rope_dim} (rope), v {cfg.v_head_dim}, kv_lora_rank "
        f"{cfg.kv_lora_rank}; {cfg.n_experts} experts (padded "
        f"{params['blocks']['pos0']['router'].shape[-1]}) top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    max_len = S + T + 1
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    moe_layers = sum(cfg.layer_moe())
    run, ops, held = _first_run_held(
        lambda hook: greedy_generate(model, params, prompt, max_len, T,
                                     device="cuda", on_logits=hook),
        keep=(0, 2, 3 * moe_layers))
    clock, tokens, other = _serve_runs(run, (fa, bs), B, S, T)
    launched = (fa.launches, bs.launches)
    _log_held(held)
    _check_serve(clock, tokens, other, ("flash_attention", "bsr_spmm"),
                 (cfg.n_layers, 3 * moe_layers), (0, 3 * moe_layers),
                 vocab_padded(cfg))
    if held["shape"] != ((B, S, cfg.n_heads, cfg.qk_nope_dim
                          + cfg.qk_rope_dim),
                         (B, S, cfg.n_heads, cfg.v_head_dim), True):
        raise AssertionError(f"MLA's attention ran at {held['shape']}")
    mla = _cache_bytes(model, B, max_len)
    gqa = cfg.n_layers * B * max_len * cfg.n_heads * (
        cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2
    log(f"MLA cache of {B} x {max_len} positions: {mla / 2**20:.1f} MiB "
        f"(c_kv {cfg.kv_lora_rank} + k_rope {cfg.qk_rope_dim} a token a "
        f"layer, bf16); a cache of the same {cfg.n_heads} heads' keys and "
        f"values would hold {gqa / 2**20:.1f} MiB ({gqa / mla:.1f}x)")
    # printed, not gated: bf16 routing flips near ties, and capacity drops
    # differ between the prefill, the decode steps and this forward (23b
    # holds the two in f32 with no drops)
    _teacher_forced(model, params, prompt, tokens, clock.logits,
                    "bf16, capacity_factor 1.25")
    _profile_cached(model, params, prompt, tokens, max_len)
    del params
    torch.cuda.empty_cache()
    return launched, tuple(ops)


def _image_batch(cfg, B, S, steps, seed, device):
    """Tokens, ``VL_GRID`` patches at the first positions of each row, and
    pos3: t = 0 and (h, w) on the patch grid for the image; t = h = w = the
    absolute position for the text, prompt and the ``steps`` decoded tokens
    alike (the decode steps' plain RoPE at their offset is the same
    rotation). Returns the prompt's batch and the pos3 of all S + steps
    positions."""
    gh, gw = VL_GRID
    P = gh * gw
    rng = np.random.default_rng(seed)
    pos3 = np.broadcast_to(np.arange(S + steps), (3, B, S + steps)).copy()
    pos3[0, :, :P] = 0
    pos3[1, :, :P] = np.arange(P) // gw
    pos3[2, :, :P] = np.arange(P) % gw
    vmask = np.zeros((B, S), bool)
    vmask[:, :P] = True
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
    batch = dict(tokens=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32),
                 vision_embeds=t(rng.standard_normal((B, P, cfg.d_model)),
                                 torch.bfloat16),
                 vision_mask=t(vmask, torch.bool),
                 pos3=t(pos3[:, :, :S], torch.int32))
    return batch, t(pos3, torch.int32)


def _image_generate(model, params, batch, steps, max_len, device, hook):
    """The image prompt's prefill through ``Model.forward(batch,
    caches=...)``, then ``steps`` greedy text decode steps through
    ``make_serve_step``; ``hook`` gets every forward's last logits. Returns
    the (B, steps + 1) tokens."""
    from repro_torch.serve import make_serve_step
    step = make_serve_step(model)
    B, S = batch["tokens"].shape
    with torch.inference_mode():
        caches = model.init_cache(B, max_len, device=device)
        logits, _, caches = model(params, dict(batch, offset=torch.zeros(
            B, dtype=torch.int32, device=device)), caches=caches)
        logits = logits[:, -1]
        out = []
        for t in range(steps + 1):
            if t:
                logits, caches = step(params, caches, out[-1], torch.full(
                    (B,), S + t - 1, dtype=torch.int32, device=device))
            hook(logits)
            out.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(out, dim=1)


def _image_teacher_forced(model, params, batch, pos3, tokens, logits, what):
    """``_teacher_forced_batch`` over the image prompt and the tokens fed to
    the decode steps, pos3 continued over them."""
    S, n = batch["tokens"].shape[1], len(logits) - 1
    full = dict(batch, tokens=torch.cat([batch["tokens"], tokens[:, :n]], 1),
                vision_mask=torch.nn.functional.pad(batch["vision_mask"],
                                                    (0, n)),
                pos3=pos3[:, :, :S + n])
    return _teacher_forced_batch(model, params, full, S, logits, what)


def serve_vl():
    """Phase 24: qwen2-vl-7b, an image prompt's prefill through
    ``Model.forward`` with caches and SERVE_TOKENS text decode steps through
    ``make_serve_step``. Returns the warm run's flash_attention launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import vocab_padded

    cfg, model, params = _full_model(VL_ARCH)
    log(f"  {cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.hd}, M-RoPE sections {cfg.mrope_sections}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}")
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    max_len = S + steps + 1
    batch, pos3 = _image_batch(cfg, B, S, steps, seed=0, device="cuda")
    log(f"  image: {VL_GRID[0]} x {VL_GRID[1]} patches at the first "
        f"{VL_GRID[0] * VL_GRID[1]} of {S} prompt positions; {steps} text "
        f"decode steps")
    run, _, held = _first_run_held(lambda hook: _image_generate(
        model, params, batch, steps, max_len, "cuda", hook))
    clock, tokens, other = _serve_runs(run, (fa,), B, S, steps + 1)
    launched = fa.launches
    _log_held(held)
    _check_serve(clock, tokens, other, ("flash_attention",),
                 (cfg.n_layers,), (0,), vocab_padded(cfg))
    kv = _cache_bytes(model, B, max_len)
    mha = kv * cfg.n_heads // cfg.n_kv_heads
    log(f"GQA cache of {B} x {max_len} positions: {kv / 2**20:.1f} MiB; one "
        f"of {cfg.n_heads} KV heads would hold {mha / 2**20:.1f} MiB")
    _image_teacher_forced(model, params, batch, pos3, tokens, clock.logits,
                          "bf16")
    from repro_torch.serve import make_serve_step
    step = make_serve_step(model)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")

    def prefill():
        return model(params, dict(batch, offset=zero),
                     caches=model.init_cache(B, max_len, device="cuda"))

    with torch.inference_mode():
        caches = prefill()[2]
    offset = torch.full((B,), S, dtype=torch.int32, device="cuda")
    _profile_serve(prefill,
                   lambda: step(params, caches, tokens[:, :1], offset))
    del params, caches
    torch.cuda.empty_cache()
    return launched


def vl_vs_plain_e2e() -> None:
    """Phase 24b: qwen2-vl cut to E2E_LAYERS layers in f32, an image prompt
    (phase 24's grid in an E2E_PROMPT + 512 prompt) prefilled and decoded
    E2E_TOKENS - 1 steps on the CPU (plain versions) and on the card (the
    kernel): tokens equal, logits within E2E_LOGIT_TOL; then the card's
    decode logits against a teacher-forced forward, within E2E_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model

    cfg = get_config(VL_ARCH).scaled(n_layers=E2E_LAYERS, dtype="float32",
                                     param_dtype="float32")
    model = Model(cfg)
    gpu_params, cpu_params = _e2e_params(cfg)
    S = E2E_PROMPT + VL_GRID[0] * VL_GRID[1]
    steps = E2E_TOKENS - 1
    batch, pos3 = _image_batch(cfg, E2E_BATCH, S, steps, seed=1,
                               device="cpu")
    batches = {"cpu": (batch, pos3),
               "cuda": (_to(batch, "cuda"), pos3.cuda())}
    out = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        logits = []
        before = fa.launches
        t0 = time.perf_counter()
        tok = _image_generate(model, p, batches[dev][0], steps, S + steps + 1,
                              dev, lambda lg: logits.append(lg.float().cpu()))
        out[dev] = (tok.cpu(), torch.stack(logits))
        n = fa.launches - before
        log(f"e2e {dev}: {time.perf_counter() - t0:.2f} s, flash_attention "
            f"launches {n}")
        if (dev == "cpu") != (n == 0):
            raise AssertionError(f"the {dev} run launched {n}")
    _same_e2e(out)
    batch, pos3 = batches["cuda"]
    err = _image_teacher_forced(model, gpu_params, batch, pos3,
                                out["cuda"][0].cuda(),
                                list(out["cuda"][1].unbind(0)), "f32")
    if not err <= E2E_LOGIT_TOL:
        raise AssertionError(f"decode and teacher-forced logits differ by "
                             f"{err}")


def _frames(cfg, B, F, seed, device):
    feats = np.random.default_rng(seed).standard_normal((B, F, cfg.d_model))
    return dict(features=torch.from_numpy(feats).to(device, torch.bfloat16))


def encode_audio():
    """Phase 25: hubert-xlarge over AUDIO_BATCH clips of AUDIO_FRAMES frames
    through ``Model.forward``. Returns the warm forward's flash_attention
    launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import vocab_padded

    cfg, model, params = _full_model(AUDIO_ARCH)
    log(f"  encoder: {cfg.n_heads} heads of {cfg.hd}, non-causal, gelu MLP "
        f"d_ff {cfg.d_ff}, {cfg.vocab} units (padded {vocab_padded(cfg)})")
    B, F = AUDIO_BATCH, AUDIO_FRAMES
    batch = _frames(cfg, B, F, seed=0, device="cuda")
    with torch.inference_mode(), _flash_hold() as held:
        _, cold = _wall(lambda: model(params, batch))
    _log_held(held)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    with torch.inference_mode():
        (logits, _, _), warm = _wall(lambda: model(params, batch))
    launched, other = fa.launches, _other_launches((fa,))
    peak = torch.cuda.max_memory_allocated()
    units = logits[..., :cfg.vocab].argmax(-1)
    log(f"encode {B} x {F} frames ({F / 50:g} s at 50 frames/s): cold "
        f"{cold * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms "
        f"({B * F / warm:.0f} frames/s); peak device memory "
        f"{peak / 2**30:.3f} GiB; flash_attention launches {launched}, other "
        f"kernels {other}; logits {tuple(logits.shape)}, "
        f"{int(units.unique().numel())} distinct units predicted")
    if held["shape"] != ((B, F, cfg.n_heads, cfg.hd),
                         (B, F, cfg.n_heads, cfg.hd), False):
        raise AssertionError(f"hubert's attention ran at {held['shape']}")
    if tuple(logits.shape) != (B, F, vocab_padded(cfg)) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("hubert's logits are not finite or of shape "
                             f"{tuple(logits.shape)}")
    if launched != cfg.n_layers or other:
        raise AssertionError(f"the forward launched {launched} "
                             f"flash_attention and {other} others")
    del logits
    with torch.inference_mode():
        log("profile of one warm forward:")
        profile_breakdown(lambda: model(params, batch))
    del params
    torch.cuda.empty_cache()
    return launched


def audio_vs_plain_e2e() -> None:
    """Phase 25b: hubert cut to E2E_LAYERS layers in f32 over
    AUDIO_E2E_BATCH clips of AUDIO_FRAMES frames: the forward's logits on
    the CPU (plain versions) and on the card (the kernel) within
    E2E_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model

    cfg = get_config(AUDIO_ARCH).scaled(n_layers=E2E_LAYERS, dtype="float32",
                                        param_dtype="float32")
    model = Model(cfg)
    gpu_params, cpu_params = _e2e_params(cfg)
    out = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        before = fa.launches
        t0 = time.perf_counter()
        with torch.inference_mode():
            out[dev] = model(p, _frames(cfg, AUDIO_E2E_BATCH, AUDIO_FRAMES,
                                        seed=1, device=dev))[0].cpu()
        n = fa.launches - before
        log(f"e2e {dev}: {time.perf_counter() - t0:.2f} s, flash_attention "
            f"launches {n}")
        if (dev == "cpu") != (n == 0):
            raise AssertionError(f"the {dev} run launched {n}")
    err = float((out["cpu"] - out["cuda"]).abs().max())
    log(f"e2e: max |dlogit| {err:.3g} (tolerance {E2E_LOGIT_TOL}, logits up "
        f"to {float(out['cpu'].abs().max()):.2f}); argmax agrees at "
        f"{100 * float((out['cpu'].argmax(-1) == out['cuda'].argmax(-1)).float().mean()):.2f}% "
        f"of frames")
    if not err <= E2E_LOGIT_TOL:
        raise AssertionError(f"card and CPU logits differ by {err}")


# --------------------------------------------------------------------------
# phase 8: ssd_chunk kernel vs plain
# --------------------------------------------------------------------------

def _ssd_inputs(G, q, H, P, N, xdt, ddt, seed):
    """x, B, C ~ N(0, 1) in ``xdt``; dt and A in ``ddt``, drawn as mamba2's
    init and mixer make them: A = -exp(log linspace(1, 16)) and dt =
    softplus(N(0, 1) + dt_bias), dt_bias = softplus^-1 of a log-spaced
    [1e-3, 1e-1]. Over a 128-step chunk the cumsum of dt A then passes 88
    above the diagonal, where exp overflows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(G, q, H, P, generator=g, device="cuda").to(xdt)
    B = torch.randn(G, q, N, generator=g, device="cuda").to(xdt)
    C = torch.randn(G, q, N, generator=g, device="cuda").to(xdt)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    dt0 = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                   device="cuda"))
    bias = torch.log(torch.expm1(dt0))
    dt = torch.nn.functional.softplus(
        torch.randn(G, q, H, generator=g, device="cuda") + bias)
    return x, dt.to(ddt), A.to(ddt), B, C


def _ssd_close(got, want, x, dt, A, B, C, what):
    """Max abs error; raises unless finite and within 2^-10 of the sum of
    the terms' magnitudes (the plain version on |x|, |B|, |C|, which bounds
    sum |C_i . B_k| L dt |x| and sum |x| decay dt |B|), plus 1e-6. Both sum
    in float32 in other orders, and the kernel's cumsum (per-lane runs and a
    shuffle scan) parts from torch.cumsum's by a few ulps of |cA|, which
    reaches a few hundred over a chunk: exp(cA_i - cA_k) then parts by up to
    some 1e-4 relative near the diagonal."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
    bounds = ssd_chunk_plain(x.abs(), dt, A, B.abs(), C.abs())
    err = 0.0
    for name, g, w, b in zip(("y", "states"), got, want, bounds):
        if g.shape != w.shape or g.dtype != torch.float32:
            raise AssertionError(f"ssd_chunk {what} {name}: "
                                 f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_chunk {what} {name}: non-finite")
        e = (g.double() - w.double()).abs()
        if not bool((e <= 2.0 ** -10 * b.double() + 1e-6).all()):
            raise AssertionError(f"ssd_chunk {what} {name}: max err "
                                 f"{float(e.max())} beyond 2^-10 sum|terms|")
        err = max(err, float(e.max()))
    return err


def check_ssd_chunk() -> dict:
    """Phase 8: the kernel against its plain version over the main path's
    shape (in the serving config's bf16, and in f32), the smoke widths, a
    ragged chunk and the longest one; times at the main shape."""
    from repro_torch.kernels import ssd_chunk as sc

    f32, bf16 = torch.float32, torch.bfloat16
    G, q, H, P, N = SSD_MAIN
    # (case, the route it must take)
    cases = [((G, q, H, P, N, bf16, bf16), "wgmma"),
             ((G, q, H, P, N, f32, f32), "fma"),
             ((G, q, H, P, N, bf16, f32), "wgmma"),
             ((6, 16, 16, 8, 16, f32, f32), "fma"),   # mamba2's smoke widths
             ((8, 40, H, P, N, bf16, bf16), "wgmma"),  # a 40-token prompt
             ((4, 256, H, P, N, bf16, bf16), "fma"),   # the longest chunk
             ((3, 77, 5, 72, 200, f32, bf16), "fma"),
             ((2, 1, 3, 4, 5, bf16, f32), "fma"),
             # the tensor-core route's edges: ragged q (77 rows: the second
             # warpgroup's tile ragged; 40: no rows for it), N below and
             # between 64-column boxes, a last group of fewer than 8 heads
             ((2, 77, H, P, N, bf16, bf16), "wgmma"),
             ((4, 77, 8, 64, 40, bf16, bf16), "wgmma"),
             ((3, 40, 12, 64, 64, bf16, f32), "wgmma"),
             ((2, 128, 5, 64, 8, bf16, bf16), "wgmma"),
             # bf16 widths the tensor cores do not take: P = 72, N = 200
             ((3, 77, 5, 72, 200, bf16, bf16), "fma")]
    max_err, overflowed = 0.0, 0
    for i, ((G_, q_, H_, P_, N_, xdt, ddt), want_route) in enumerate(cases):
        x, dt, A, B, C = _ssd_inputs(G_, q_, H_, P_, N_, xdt, ddt, 400 + i)
        cA = torch.cumsum(dt.float() * A.float(), dim=1)
        overflowed += bool(((cA[:, :1] - cA[:, -1:]) > 88.8).any())
        what = f"G={G_} q={q_} H={H_} P={P_} N={N_} x {xdt} dt {ddt}"
        route = sc.route(x, dt, A, B, C)
        if route != want_route:
            raise AssertionError(f"ssd_chunk {what}: route {route}, not "
                                 f"{want_route}")
        got = sc.ssd_chunk(x, dt, A, B, C)
        want = sc.ssd_chunk_plain(x, dt, A, B, C)
        torch.cuda.synchronize()
        err = _ssd_close(got, want, x, dt, A, B, C, what)
        log(f"  ssd_chunk {what}: {route}, max abs err {err:.3g}")
        max_err = max(max_err, err)
    if not overflowed:
        raise AssertionError("no case overflows exp above the diagonal")
    log(f"ssd_chunk: {len(cases)} cases match the plain version (max abs "
        f"err {max_err:.3g}, within 2^-10 sum|terms|; {overflowed} cases "
        f"overflow exp(cA_i - cA_k) above the diagonal, no NaN)")

    x, dt, A, B, C = _ssd_inputs(G, q, H, P, N, bf16, bf16, 7)
    ms = cuda_time_ms(lambda: sc.ssd_chunk(x, dt, A, B, C), iters=20)
    plain_ms = cuda_time_ms(lambda: sc.ssd_chunk_plain(x, dt, A, B, C),
                            iters=3, warmup=1)
    # the work these inputs need: C B^T once per g and w x over the causal
    # pairs, the states over every (k, p, n). On the FMA route these are
    # float32 products at the float32 peak; on the tensor-core route the
    # scores are bf16 products and the other two (one float32 operand,
    # split into three bf16 terms) three bf16 products each, at the bf16
    # peak. Bytes: x, dt, A, B, C read once, y and the states (float32)
    # written once.
    pairs = q * (q + 1) // 2
    f_scores = 2 * G * pairs * N
    f_rest = 2 * G * H * pairs * P + 2 * G * H * q * P * N
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C)) \
        + 4 * (G * q * H * P + G * H * P * N)
    t_f32 = (f_scores + f_rest) / F32_FLOPS * 1e3
    t_tc = (f_scores + 3 * f_rest) / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    route = sc.route(x, dt, A, B, C)
    t_ops = t_tc if route == "wgmma" else t_f32
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"ssd_chunk {SSD_MAIN} (G, q, H, P, N) bf16 ({route} route): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, no one PyTorch call computes "
        f"it; bound {bound:.4f} ms by {by}, {100 * bound / ms:.1f}% of it "
        f"({nbytes / 1e6:.1f} MB: {t_bytes:.4f} ms; "
        f"{(f_scores + 3 * f_rest) / 1e9:.2f} GFLOP of bf16 products at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s: {t_tc:.4f} ms; the FMA route's "
        f"{(f_scores + f_rest) / 1e9:.2f} GFLOP of f32 products at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s: {t_f32:.4f} ms)")
    x32, dt32, A32, B32, C32 = (t.float() for t in (x, dt, A, B, C))
    f32_ms = cuda_time_ms(lambda: sc.ssd_chunk(x32, dt32, A32, B32, C32),
                          iters=10)
    route32 = sc.route(x32, dt32, A32, B32, C32)
    log(f"ssd_chunk {SSD_MAIN} f32 inputs ({route32} route): kernel "
        f"{f32_ms:.4f} ms, bound "
        f"{max(t_f32, t_bytes):.4f} ms by operations, "
        f"{100 * max(t_f32, t_bytes) / f32_ms:.1f}% of it")
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:51",
            "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


# --------------------------------------------------------------------------
# phase 8b: ssd_chunk's backward kernel vs the plain backward
# --------------------------------------------------------------------------

# each route's four launches, as the profiler names them
SSD_BWD_KERNELS = {
    "wgmma": ("ssd_chunk_bwd_wgmma", "ssd_chunk_bwd_reduce",
              "ssd_chunk_bwd_bc", "ssd_chunk_bwd_da"),
    "fma": ("ssd_chunk_bwd_head", "ssd_chunk_bwd_sum", "ssd_chunk_bwd_bc",
            "ssd_chunk_bwd_da")}


def ssd_bwd_bounds(x, dt, A, B, C, dy, dst):
    """Per gradient (dx, ddt, dA, dB, dC), the sum of its terms' magnitudes
    in float64: ``ssd_chunk_backward_plain``'s formula on |x|, |B|, |C|,
    |dy|, |dst| and |A|, dcA's differences taken as sums. Two summation
    orders of the same terms part by a small multiple of it."""
    f = torch.float64
    xa, Ba, Ca, dya, dsta = (t.to(f).abs() for t in (x, B, C, dy, dst))
    dt64, a = dt.to(f), A.to(f)
    q = x.shape[1]
    cA = torch.cumsum(dt64 * a, dim=1)
    seg = cA[:, :, None, :] - cA[:, None, :, :]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[None, :, :, None], seg, -math.inf))
    SL = (Ca @ Ba.transpose(1, 2))[..., None] * L
    W = SL * dt64[:, None]
    E = torch.exp(cA[:, -1:] - cA)
    dec = E * dt64
    dW = torch.einsum("gihp,gkhp->gikh", dya, xa)
    U = torch.einsum("gkn,ghpn->gkhp", Ba, dsta)
    dx = torch.einsum("gikh,gihp->gkhp", W, dya) + dec[..., None] * U
    ddec = (xa * U).sum(-1)
    dS = (dW * L * dt64[:, None]).sum(-1)
    dB = dS.transpose(1, 2) @ Ca + torch.einsum("gkh,gkhp,ghpn->gkn", dec,
                                                xa, dsta)
    dC = dS @ Ba
    M = dW * W
    dcA = M.sum(2) + M.sum(1) + ddec * dec
    dcA[:, -1] += (ddec * dec).sum(1)
    R = torch.flip(torch.cumsum(torch.flip(dcA, [1]), dim=1), [1])
    ddt = (dW * SL).sum(1) + ddec * E + a.abs() * R
    return dx, ddt, (dt64 * R).sum((0, 1)), dB, dC


def ssd_bwd_close(got, want, bounds, what):
    """(max abs error, its largest share of the limit) of the five
    gradients; raises unless each is finite, of the input's type and shape,
    and within 2^-10 of its terms' magnitudes plus 1e-6, plus one rounding
    2^-7 |want| where the type is bf16 (both sides round once). The
    kernel's cumsum parts from torch.cumsum's by a few ulps of |cA| (phase
    8's ``_ssd_close``)."""
    err = share = 0.0
    for name, g, w, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             bounds):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"ssd_chunk backward {what} {name}: "
                                 f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_chunk backward {what} {name}: "
                                 f"non-finite")
        wd = w.double()
        e = (g.double() - wd).abs()
        limit = 2.0 ** -10 * b + 1e-6
        if g.dtype == torch.bfloat16:
            limit = limit + 2.0 ** -7 * wd.abs()
        if not bool((e <= limit).all()):
            raise AssertionError(f"ssd_chunk backward {what} {name}: max err "
                                 f"{float(e.max())} beyond its limit (max "
                                 f"share {float((e / limit).max()):.3g})")
        err = max(err, float(e.max()))
        share = max(share, float((e / limit).max()))
    return err, share


def _ssd_bwd_bound(x, dt, A, B, C):
    """Least time of the backward on these inputs: the float32 products
    the data needs (dW and W^T dy over the causal pairs, U and the states'
    dB term over every (k, p, n), a head; S, dC and dB over the pairs once
    a g) at the CUDA cores' peak, or x, dt, A, B, C, dy and dst (float32)
    read once and the five gradients written once at 3.35 TB/s. Returns
    (ms of operations, ms of bytes, FLOP, bytes)."""
    G, q, H, P = x.shape
    N = B.shape[2]
    pairs = q * (q + 1) // 2
    flops = 2 * G * H * (2 * pairs * P + 2 * q * N * P) + 6 * G * pairs * N
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C))
    nbytes = 2 * ins + 4 * (x.numel() + G * H * P * N)
    return (flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3, flops,
            nbytes)


def _ssd_bwd_wgmma_flops(G, q, H, P, N) -> int:
    """The bf16 wgmma work of the tensor-core route (csrc/ssd_chunk_bwd.cu):
    a head, for each active 64-key half, U = B dst^T and V = x dst (hi and
    lo of dst, V over 128 n), and for each 32-query half at or below the
    key half's diagonal block and below q, S^T, dW^T (two) and W^T dy
    (three); the products over n run over N rounded up to 64."""
    kn = 64 * ((N + 63) // 64)
    flops = 0
    for kh in range((q + 63) // 64):
        flops += 2 * 64 * 64 * kn * 2 + 2 * 64 * 128 * P * 2
        for ih in range(2 * kh, 4):
            if 32 * ih < q:
                flops += (2 * 64 * 32 * kn + 2 * 64 * 32 * P * 2
                          + 2 * 64 * P * 32 * 3)
    return G * H * flops


def check_ssd_backward() -> dict:
    """Phase 8b: the backward kernels against ``ssd_chunk_backward_plain``
    on the same inputs and float32 cotangents ~ N(0, 1): each case on the
    route its inputs select (wgmma in the forward's tensor-core domain, fma
    elsewhere), two calls bitwise equal; both routes timed at the main
    shape."""
    from repro_torch.kernels import ssd_chunk as sc

    f32, bf16 = torch.float32, torch.bfloat16
    G, q, H, P, N = SSD_MAIN
    # (case, the route it must take)
    cases = [((G, q, H, P, N, bf16, f32), "wgmma"),   # as training passes
             ((G, q, H, P, N, f32, f32), "fma"),
             ((6, 16, 16, 8, 16, bf16, f32), "fma"),  # mamba2's, jamba's
             ((6, 16, 16, 8, 16, f32, f32), "fma"),   # smoke widths
             ((8, 40, H, P, N, bf16, f32), "wgmma"),  # a 40-token prompt
             ((4, 256, H, P, N, bf16, bf16), "fma"),  # the longest chunk
             ((2, 1, 3, 4, 5, f32, bf16), "fma"),
             ((3, 77, 5, 72, 200, f32, f32), "fma"),  # P and N past a tile
             ((2, 128, 8, 16, 32, f32, f32), "fma"),  # the overflow chunk
             # the tensor-core route: the overflow chunk, dt bf16, q = 1, 64
             # (no second key half), 77 and 100 (ragged), N of 8, 32, 40
             # and 72 (float32 boxes of dst not loaded, or partly), a last
             # group of one head
             ((2, 128, 8, 64, 32, bf16, f32), "wgmma"),
             ((4, 128, 16, 64, 128, bf16, bf16), "wgmma"),
             ((3, 1, 9, 64, 8, bf16, bf16), "wgmma"),
             ((4, 64, 16, 64, 128, bf16, f32), "wgmma"),
             ((2, 77, 12, 64, 40, bf16, f32), "wgmma"),
             ((2, 100, 8, 64, 72, bf16, bf16), "wgmma"),
             ((2, 128, 5, 64, 8, bf16, f32), "wgmma")]
    max_err = max_share = 0.0
    overflowed = {"wgmma": 0, "fma": 0}
    for i, ((G_, q_, H_, P_, N_, xdt, ddt), want) in enumerate(cases):
        x, dt, A, B, C = _ssd_inputs(G_, q_, H_, P_, N_, xdt, ddt, 700 + i)
        g = torch.Generator(device="cuda").manual_seed(800 + i)
        dy = torch.randn(G_, q_, H_, P_, generator=g, device="cuda")
        dst = torch.randn(G_, H_, P_, N_, generator=g, device="cuda")
        cA = torch.cumsum(dt.float() * A.float(), dim=1)
        over = bool(((cA[:, :1] - cA[:, -1:]) > 88.8).any())
        overflowed[want] += over
        what = (f"G={G_} q={q_} H={H_} P={P_} N={N_} x {xdt} dt {ddt}"
                + (" (exp overflows above the diagonal)" if over else ""))
        route = sc.backward_route(x, dt, A, B, C)
        if route != want:
            raise AssertionError(f"ssd_chunk backward {what}: route {route}, "
                                 f"not {want}")
        got = sc.ssd_chunk_backward(x, dt, A, B, C, dy, dst)
        again = sc.ssd_chunk_backward(x, dt, A, B, C, dy, dst)
        want_g = sc.ssd_chunk_backward_plain(x, dt, A, B, C, dy, dst)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_chunk backward {what}: two calls "
                                 f"differ")
        err, share = ssd_bwd_close(got, want_g,
                                   ssd_bwd_bounds(x, dt, A, B, C, dy, dst),
                                   what)
        log(f"  ssd_chunk backward {what}: {route}, max abs err {err:.3g} "
            f"({share:.3g} of its limit), two calls bitwise equal")
        max_err, max_share = max(max_err, err), max(max_share, share)
        del got, again, want_g
    if not all(overflowed.values()):
        raise AssertionError(f"a route with no case that overflows exp above "
                             f"the diagonal: {overflowed}")
    log(f"ssd_chunk backward: {len(cases)} cases match the plain backward "
        f"(max abs err {max_err:.3g}, at most {max_share:.3g} of the limit; "
        f"cases that overflow exp(cA_i - cA_k) above the diagonal by route "
        f"{overflowed}, every gradient finite; each case twice, bitwise "
        f"equal)")

    out = {}
    for xdt in (bf16, f32):
        x, dt, A, B, C = _ssd_inputs(G, q, H, P, N, xdt, f32, 7)
        g = torch.Generator(device="cuda").manual_seed(8)
        dy = torch.randn(G, q, H, P, generator=g, device="cuda")
        dst = torch.randn(G, H, P, N, generator=g, device="cuda")
        route = sc.backward_route(x, dt, A, B, C)
        run = lambda: sc.ssd_chunk_backward(x, dt, A, B, C, dy, dst)
        ms = cuda_time_ms(run, iters=20)
        parts = [kernel_device_ms(run, name, iters=5)
                 for name in SSD_BWD_KERNELS[route]]
        out[route] = (ms, parts, *_ssd_bwd_bound(x, dt, A, B, C))
        if xdt == bf16:
            plain_ms = cuda_time_ms(lambda: sc.ssd_chunk_backward_plain(
                x, dt, A, B, C, dy, dst), iters=3, warmup=1)

    def launches(route, parts):
        return ", ".join(f"{n[14:]} {t:.4f}" for n, t in
                         zip(SSD_BWD_KERNELS[route], parts))

    ms, parts, t_f32, t_bytes, flops, nbytes = out["wgmma"]
    tc_flops = _ssd_bwd_wgmma_flops(G, q, H, P, N)
    t_tc = tc_flops / BF16_FLOPS * 1e3
    bound = max(t_tc, t_bytes)
    by = "operations" if t_tc >= t_bytes else "bytes"
    ms32, parts32, t_f32_32, t_bytes32, _, nbytes32 = out["fma"]
    log(f"ssd_chunk backward {SSD_MAIN} (G, q, H, P, N), bf16 x/B/C and "
        f"f32 dt/A (wgmma route): kernel {ms:.4f} ms (device time of its "
        f"launches: {launches('wgmma', parts)} ms), plain backward "
        f"{plain_ms:.4f} ms, no one PyTorch call computes it; bound "
        f"{bound:.4f} ms by {by}, {100 * bound / ms:.1f}% of it "
        f"({nbytes / 1e6:.1f} MB: {t_bytes:.4f} ms; its "
        f"{tc_flops / 1e9:.2f} GFLOP of bf16 wgmma at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s: {t_tc:.4f} ms)")
    log(f"ssd_chunk backward {SSD_MAIN} f32 inputs (fma route): kernel "
        f"{ms32:.4f} ms ({launches('fma', parts32)} ms); bound "
        f"{max(t_f32_32, t_bytes32):.4f} ms by operations ({flops / 1e9:.2f} "
        f"GFLOP of f32 products at {F32_FLOPS / 1e12:.0f} TFLOP/s; "
        f"{nbytes32 / 1e6:.1f} MB: {t_bytes32:.4f} ms), "
        f"{100 * max(t_f32_32, t_bytes32) / ms32:.1f}% of it; "
        f"{ms32 / ms:.2f}x the wgmma route's time")
    return {"name": "ssd_chunk_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:51 (its gradient: "
                        "the JAX package differentiates the pure twin)",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "bf16_wgmma_gflop": tc_flops / 1e9,
            "launch_ms": dict(zip(SSD_BWD_KERNELS["wgmma"], parts)),
            "fma_ms": ms32, "fma_bound_ms": max(t_f32_32, t_bytes32),
            "fma_launch_ms": dict(zip(SSD_BWD_KERNELS["fma"], parts32))}


# --------------------------------------------------------------------------
# phase 9: mamba2-2.7b serving at full width and depth
# --------------------------------------------------------------------------

def serve_mamba() -> int:
    """Phase 9. Returns the ``ssd_chunk`` launches of the warm run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import Model, init_params
    from repro_torch.models.model import vocab_padded
    from repro_torch.serve import greedy_generate

    cfg = get_config(MAMBA_ARCH).scaled(param_dtype="bfloat16")
    model = Model(cfg)
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    max_len = S + T + 1
    vp = vocab_padded(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.ssm_heads}x{cfg.ssm_headdim} heads, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, d_conv {cfg.d_conv}, vocab "
        f"{cfg.vocab} (padded {vp}); {nparam / 1e9:.3f} B stored parameters "
        f"in bf16 ({nparam * 2 / 1e9:.2f} GB), init_params "
        f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    clock, tokens, other = _serve_runs(
        lambda hook: greedy_generate(model, params, prompt, max_len, T,
                                     device="cuda", on_logits=hook),
        (sc,), B, S, T)
    launched = sc.launches
    _check_serve(clock, tokens, other, ("ssd_chunk",), (cfg.n_layers,),
                 (0,), vp)
    if launched != cfg.n_layers:
        raise AssertionError(f"the run launched {launched} ssd_chunk")
    # a teacher-forced forward over prompt + generated tokens, against the
    # decode-step logits: printed, not gated (in bf16 the forward without a
    # cache runs the whole scan in bf16, as the reference does, while the
    # cached path keeps a float32 state; phase 9b holds the two in f32)
    _teacher_forced(model, params, prompt, tokens, clock.logits, "bf16")
    _profile_cached(model, params, prompt, tokens, max_len)
    with torch.inference_mode():
        # the cached path's y @ out_proj is a float32 product (y is float32
        # because the state is, as in the reference): one layer's, at the
        # prefill's shape, beside the same product in bf16
        w = params["blocks"]["pos0"]["out_proj"][0]
        y32 = torch.randn(B * S, cfg.d_inner, device="cuda")
        y16 = y32.bfloat16()
        f32_ms = cuda_time_ms(lambda: y32 @ w.float(), iters=10)
        bf16_ms = cuda_time_ms(lambda: y16 @ w, iters=10)
        log(f"y @ out_proj ({B * S} x {cfg.d_inner}) x ({cfg.d_inner} x "
            f"{cfg.d_model}), one layer: float32 {f32_ms:.4f} ms (the "
            f"weight's cast included, as on the path; "
            f"{cfg.n_layers * f32_ms:.1f} ms a prefill), bf16 "
            f"{bf16_ms:.4f} ms ({cfg.n_layers * bf16_ms:.1f} ms a prefill)")
        del y32, y16
    del params
    torch.cuda.empty_cache()
    return launched


# --------------------------------------------------------------------------
# phase 9b: mamba2 kernel against plain versions, end to end at full width
# --------------------------------------------------------------------------

def mamba_vs_plain_e2e() -> None:
    """mamba2-2.7b cut to MAMBA_E2E_LAYERS layers (every width kept) in
    f32: ``greedy_generate`` on the CPU (plain versions) and on the card
    (the kernel) from the same parameters, tokens equal and logits within
    E2E_LOGIT_TOL; then the card's cached decode logits against a
    teacher-forced forward, within E2E_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import Model
    from repro_torch.serve import greedy_generate

    cfg = get_config(MAMBA_ARCH).scaled(
        n_layers=MAMBA_E2E_LAYERS, dtype="float32", param_dtype="float32")
    model = Model(cfg)
    B, S, T = MAMBA_E2E_BATCH, MAMBA_E2E_PROMPT, MAMBA_E2E_TOKENS
    gpu_params, cpu_params = _e2e_params(cfg)
    log(f"e2e: a {S}-token prompt is {-(-S // cfg.ssm_chunk)} chunks of "
        f"{cfg.ssm_chunk}, the last padded")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    out = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        logits = []
        before = sc.launches
        t0 = time.perf_counter()
        tok = greedy_generate(model, p, prompt, S + T + 1, T, device=dev,
                              on_logits=lambda lg: logits.append(
                                  lg.float().cpu()))
        out[dev] = (tok.cpu(), torch.stack(logits))
        log(f"e2e {dev}: {time.perf_counter() - t0:.2f} s, ssd_chunk "
            f"launches {sc.launches - before}")
        if (dev == "cpu") != (sc.launches == before):
            raise AssertionError(f"the {dev} run launched "
                                 f"{sc.launches - before} ssd_chunk")
    _same_e2e(out)
    tg, lg = out["cuda"]
    err = _teacher_forced(model, gpu_params, prompt, tg.cuda(),
                          list(lg.unbind(0)), "f32")
    if not err <= E2E_LOGIT_TOL:
        raise AssertionError(f"decode and teacher-forced logits differ by "
                             f"{err}")


# --------------------------------------------------------------------------
# phases 26-26c: training qwen2-moe-a2.7b on one card
# --------------------------------------------------------------------------

def _train_launches():
    """(flash forward, flash backward, bsr_spmm forward products, bsr_spmm
    backward products, ssd_chunk forward, ssd_chunk backward, segreduce,
    semiring_matmul) launches since the last ``_zero_train_launches``."""
    from repro_torch.kernels import (bsr_spmm, flash_attention, segreduce,
                                     semiring_matmul, ssd_chunk)
    return (flash_attention.launches, flash_attention.backward_launches,
            bsr_spmm.launches - bsr_spmm.backward_launches,
            bsr_spmm.backward_launches, ssd_chunk.launches,
            ssd_chunk.backward_launches, segreduce.launches,
            semiring_matmul.launches)


TRAIN_LAUNCH_NAMES = ("flash fwd", "flash bwd", "bsr fwd", "bsr bwd",
                      "ssd fwd", "ssd bwd", "segreduce", "semiring_matmul")


def _zero_train_launches():
    from repro_torch.kernels import bsr_spmm, flash_attention, ssd_chunk
    _zero_launches()
    flash_attention.backward_launches = bsr_spmm.backward_launches = 0
    ssd_chunk.backward_launches = 0
    for route in ssd_chunk.backward_route_launches:
        ssd_chunk.backward_route_launches[route] = 0


def _want_train_launches(cfg) -> tuple:
    """``_train_launches`` of one training step (remat on: each period's
    forward runs twice, each backward kernel once): flash 2 and 1 an
    attention layer, bsr_spmm 6 and 6 a MoE layer (three products, each
    with two gradient products), ssd_chunk 2 and 1 a mamba layer."""
    kinds = cfg.layer_kinds()
    a, s, m = kinds.count("attn"), kinds.count("mamba"), sum(cfg.layer_moe())
    return (2 * a, a, 6 * m, 6 * m, 2 * s, s, 0, 0)


def _train_run(cfg, describe, phase) -> dict:
    """``cfg`` with float32 parameters from ``init_params(seed=0)`` and
    AdamW's float32 state on the card; ``SyntheticLM(seed=11)`` batches of
    TRAIN_BATCH x TRAIN_SEQ through a ``Prefetcher``; TRAIN_STEPS steps of
    ``make_train_step`` with the launcher's ``AdamWConfig``. Prints
    ``describe(params, nparam)``, each step's loss, grad_norm and lr
    (finite, or the phase fails), the cold and warm step wall, tokens/s,
    the peak memory, the launches of each kernel a step (every step
    ``_want_train_launches``), then one more step profiled by operator
    with the device's busy share. Returns the launches of the measured run
    by kernel, the warm step's ms and the peak GiB."""
    from repro_torch.models import Model, init_params
    from repro_torch.train import (AdamWConfig, Prefetcher, SyntheticLM,
                                   init_opt_state, make_train_step)

    model = Model(cfg)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in _leaves(params))
    log(f"{describe(params, nparam)}; batch {B} x {S} ({B * S} tokens a "
        f"step); init {time.perf_counter() - t0:.2f} s")
    step_fn = make_train_step(model, AdamWConfig(warmup_steps=20,
                                                 decay_steps=100))
    pf = Prefetcher(SyntheticLM(cfg.vocab, S, B, seed=11))
    walls, per_step, rows = [], [], []
    torch.cuda.reset_peak_memory_stats()
    _zero_train_launches()
    try:
        for step in range(TRAIN_STEPS):
            before = _train_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = {k: v.cuda() for k, v in pf.next().items()}
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append(tuple(a - b for a, b in zip(_train_launches(),
                                                        before)))
            row = [float(m[k]) for k in ("loss", "grad_norm", "lr", "aux")]
            rows.append(row)
            log(f"  step {step}: loss {row[0]:.4f}, grad_norm {row[1]:.4f}, "
                f"lr {row[2]:.3e}, aux {row[3]:.4f}, wall "
                f"{walls[-1] * 1e3:.1f} ms")
        launches = _train_launches()
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for r in rows for x in r):
            raise AssertionError("a non-finite loss, grad_norm or lr")
        warm = sorted(walls[2:])
        med = warm[len(warm) // 2]
        log(f"phase {phase}: cold step {walls[0] * 1e3:.1f} ms, warm step "
            f"{med * 1e3:.1f} ms (median of the last {len(warm)}; min "
            f"{warm[0] * 1e3:.1f}, max {warm[-1] * 1e3:.1f}), "
            f"{B * S / med:.1f} tokens/s; peak device memory "
            f"{peak / 2**30:.3f} GiB; loss {rows[0][0]:.4f} -> "
            f"{rows[-1][0]:.4f}")
        log(f"launches a step ({', '.join(TRAIN_LAUNCH_NAMES)}): "
            f"{sorted(set(per_step))}; the run: {launches}")
        want = _want_train_launches(cfg)
        if set(per_step) != {want}:
            raise AssertionError(f"launches a step {set(per_step)}, not "
                                 f"{want}")
        log("profile of one more warm step:")
        batch = {k: v.cuda() for k, v in pf.next().items()}
        profile_breakdown(lambda: step_fn(params, opt, batch), top=14)
    finally:
        pf.close()
    del params, opt, step_fn
    torch.cuda.empty_cache()
    names = ("flash_attention", "flash_attention_backward", "bsr_spmm",
             "bsr_spmm_backward", "ssd_chunk", "ssd_chunk_backward",
             "segreduce", "semiring_matmul")
    return dict(zip(names, launches), step_ms=med * 1e3,
                peak_gib=peak / 2**30)


def train_path() -> dict:
    """Phase 26: qwen2-moe-a2.7b at full width, TRAIN_LAYERS of its 24
    layers, through ``_train_run``: flash forward 8 (remat) and backward 4
    a step, bsr_spmm 24 forward and 24 backward products."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import experts_padded, vocab_padded

    cfg = get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    E = experts_padded(cfg)
    cap = max(8, min(int(cfg.capacity_factor * B * S * cfg.top_k / E
                         + 0.999), B * S))

    def describe(params, nparam):
        return (f"{cfg.name} training, {cfg.n_layers} of 24 layers, every "
                f"width kept (d_model {cfg.d_model}, {cfg.n_heads}x{cfg.hd} "
                f"heads, {cfg.n_experts} experts padded to {E} of d_ff "
                f"{cfg.d_ff}, top-{cfg.top_k} + {cfg.n_shared_experts} "
                f"shared, vocab {vocab_padded(cfg)}): {nparam / 1e9:.3f} B "
                f"float32 parameters, {16 * nparam / 1e9:.1f} GB with "
                f"gradients and AdamW's m and v; C = {cap} an expert")
    return _train_run(cfg, describe, "26")


def mamba_train_path() -> dict:
    """Phase 27: mamba2-2.7b at full width and depth through ``_train_run``
    (phase 26's batches, steps and optimizer): ssd_chunk's forward 128
    (remat) and its backward kernel 64 a step, every backward launch on
    the tensor-core route ("wgmma"), the other kernels 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models.model import vocab_padded

    cfg = get_config(MAMBA_ARCH)
    G = TRAIN_BATCH * TRAIN_SEQ // cfg.ssm_chunk

    def describe(params, nparam):
        return (f"{cfg.name} training at full width and depth ({cfg.n_layers} "
                f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
                f"{cfg.ssm_heads}x{cfg.ssm_headdim} heads, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
                f"{vocab_padded(cfg)}, compute {cfg.dtype}): "
                f"{nparam / 1e9:.3f} B float32 parameters, "
                f"{16 * nparam / 1e9:.1f} GB with gradients and AdamW's m "
                f"and v; ssd_chunk at (G, q, H, P, N) = ({G}, "
                f"{cfg.ssm_chunk}, "
                f"{cfg.ssm_heads}, {cfg.ssm_headdim}, {cfg.ssm_state})")
    rec = _train_run(cfg, describe, "27")
    routes = dict(sc.backward_route_launches)  # the profiled step's too
    log(f"phase 27: the SSD backward's launches by route {routes}")
    if routes["fma"] or routes["wgmma"] < rec["ssd_chunk_backward"]:
        raise AssertionError(f"the training shape's SSD backward left the "
                             f"wgmma route: {routes}")
    return rec


@contextlib.contextmanager
def _routes(replay=None):
    """While open, every ``router_top_k`` choice is appended to the yielded
    list (on the host); with ``replay`` (a list of such choices) each call
    also counts the choices that differ from it and then takes it, its
    probabilities gathered from this run's."""
    from repro_torch.models import layers as L
    got, wrapped, calls = [], L.router_top_k, [0]

    def hook(probs, k):
        vals, idx = wrapped(probs, k)
        got.append(idx.cpu())
        if replay is not None:
            want = replay[calls[0]].to(idx.device)
            calls[0] += 1
            return probs.gather(-1, want), want
        return vals, idx

    L.router_top_k = hook
    try:
        yield got
    finally:
        L.router_top_k = wrapped


def train_vs_plain_e2e(arch=TRAIN_ARCH, phase="26b") -> None:
    """Phases 26b (qwen2-moe-a2.7b) and 27b (mamba2-2.7b): ``arch`` cut to
    E2E_LAYERS layers (every width kept) in float32, batch TRAIN_E2E_BATCH x
    TRAIN_E2E_SEQ: the loss and every gradient leaf (``value_and_grad``,
    remat on) on the card, where the kernels and their backward kernels
    run, against the CPU, where the plain versions run, from the same
    parameters (made on the card and copied). The card's recomputed periods
    must route as its forward did; the CPU run takes the card's routing
    choices, call for call (the ones that differ are counted first); loss
    and aux within 1e-5 relative, each leaf within TRAIN_E2E_TOL of its
    largest |g| on the CPU (two float32 summation orders, through softmax,
    the router, the SSD scan and 2 layers)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import SyntheticLM, value_and_grad
    from repro_torch.dist.compression import _flatten

    cfg = get_config(arch).scaled(n_layers=E2E_LAYERS, dtype="float32",
                                  param_dtype="float32")
    model = Model(cfg)
    gpu_params, cpu_params = _e2e_params(cfg)
    batch = SyntheticLM(cfg.vocab, TRAIN_E2E_SEQ, TRAIN_E2E_BATCH,
                        seed=11).batch_at(0)
    _zero_train_launches()
    t0 = time.perf_counter()
    with _routes() as card_routes:
        lg, mg, gg = value_and_grad(model, gpu_params,
                                    {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    n = _train_launches()
    gg = [t.cpu() for t in _flatten(gg)]
    del gpu_params
    t0 = time.perf_counter()
    with _routes(replay=card_routes) as cpu_routes:
        lc, mc, gc = value_and_grad(model, cpu_params, batch)
    t_cpu = time.perf_counter() - t0
    moe = sum(cfg.layer_moe())
    L = len(card_routes) // 2           # forward, then remat in reverse
    if len(card_routes) != 2 * moe or not all(
            torch.equal(card_routes[i], card_routes[2 * L - 1 - i])
            for i in range(L)):
        raise AssertionError(f"{phase}: the card's recomputed periods routed "
                             f"otherwise than its forward")
    differ = sum(int((a != b).sum()) for a, b in zip(cpu_routes, card_routes))
    total = sum(a.numel() for a in card_routes)
    log(f"{phase}: {cfg.name} with {cfg.n_layers} layers in f32, batch "
        f"{TRAIN_E2E_BATCH} x {TRAIN_E2E_SEQ}: card {t_gpu:.2f} s, CPU "
        f"{t_cpu:.2f} s; launches on the card "
        f"({', '.join(TRAIN_LAUNCH_NAMES)}) {n}; routing choices that "
        f"differ {differ} of {total} (forward and recompute; the CPU run "
        f"takes the card's, and the card's recompute routed as its forward)")
    if n != _want_train_launches(cfg):
        raise AssertionError(f"{phase} launched {n}, not "
                             f"{_want_train_launches(cfg)}")
    for name, a, b in (("loss", lg, lc), ("aux", mg["aux"], mc["aux"])):
        a, b = float(a), float(b)
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"{phase}: {name} {a} on the card, {b} on "
                                 f"the CPU")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, _flatten(gc))):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not err <= TRAIN_E2E_TOL * scale:
            raise AssertionError(f"{phase}: gradient leaf {i} "
                                 f"{tuple(b.shape)} differs by {err} (its "
                                 f"max |g| {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"{phase}: loss {float(lg):.6f} (card) vs {float(lc):.6f} (CPU), aux "
        f"{float(mg['aux']):.6f} vs {float(mc['aux']):.6f}; all {len(gg)} "
        f"gradient leaves within {worst:.3g} of their largest |g| "
        f"(tolerance {TRAIN_E2E_TOL})")


def launcher_train(arch=TRAIN_ARCH, phase="26c") -> None:
    """Phases 26c and 27c: ``python -m repro_torch.launch.train --arch
    <arch> --smoke --steps 30`` on the card, in its own process; the last
    step's loss must be below the first step's."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         arch, "--smoke", "--steps", "30"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the training launcher exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    losses = [float(x) for x in
              re.findall(r"^step\s+\d+ loss (\S+)", proc.stdout, re.M)]
    log(f"{phase}: the launcher, {arch} --smoke --steps 30, in "
        f"{time.perf_counter() - t0:.1f} s (the process's start included): "
        f"losses {losses}")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")


def main() -> int:
    t_start = time.perf_counter()
    smi = setup()
    seg_record = check_segreduce()
    smm_record = check_semiring_matmul()
    from repro_torch.kernels import segreduce
    from repro_torch.kernels import semiring_matmul as smm
    # each path runs with the launch counts set to 0 just before it and
    # read just after; the records keep phases 3 and 4 (their kernel's path)
    segreduce.launches = smm.launches = 0
    (seg_record["launches"], seg_record["main_path_ms"],
     seg_record["main_path_bound_ms"]), dist_a = main_path()
    segreduce.launches = smm.launches = 0
    smm_record["launches"] = dense_path()
    if segreduce.launches < 1:
        raise AssertionError("phase 4's ESC cross-check launched no "
                             "segreduce")
    segreduce.launches = smm.launches = 0
    if spmv_path(dist_a) < 1 or smm.launches:
        raise AssertionError("phase 5 launched no segreduce, or a matmul")
    del dist_a
    graph, mesh, csr, _ = graph500_graph()
    _routes_zero()
    seg_record["bfs_launches_by_route"] = bfs_phase(graph, mesh, csr)
    _routes_zero()
    seg_record["pagerank_launches_by_route"] = pagerank_phase(graph, mesh,
                                                              csr)
    _routes_zero()
    seg_record["fastsv_launches_by_route"] = fastsv_phase(graph, mesh, csr)
    _routes_zero()
    seg_record["matching_launches_by_route"] = matching_phase(graph, mesh,
                                                              csr)
    _routes_zero()
    seg_record["spmm_launches_by_route"] = spmm_phase(graph, mesh, csr)
    ONE_BY_ONE["csr"] = csr
    del csr                           # phase 21 runs BFS and PageRank again
    torch.cuda.empty_cache()
    _routes_zero()
    seg_record["hipmcl_launches_by_route"] = hipmcl_phase(mesh)
    torch.cuda.empty_cache()
    fa_record = check_flash_attention()
    (fa_record["launches"], bsr_launches), ops = serve_path()
    torch.cuda.empty_cache()          # phase 7's 30 GB went with its params
    (mla_fa, mla_bs), mla_ops = serve_mla()
    with torch.inference_mode():      # the operands are inference tensors
        bsr_record = check_bsr_spmm({
            arch: tuple(tuple(t.cuda() for t in op) for op in o)
            for arch, o in ((SERVE_ARCH, ops), (MLA_ARCH, mla_ops))})
    bsr_record["launches"] = bsr_launches
    bsr_record["launches_by_path"] = {SERVE_ARCH: bsr_launches,
                                      MLA_ARCH: mla_bs}
    fa_record["backward"] = check_flash_backward()
    bsr_record["backward"] = check_bsr_backward()
    del ops, mla_ops
    kernels_vs_plain_e2e()
    kernels_vs_plain_e2e(MLA_ARCH)
    torch.cuda.empty_cache()
    vl_fa = serve_vl()
    vl_vs_plain_e2e()
    audio_fa = encode_audio()
    audio_vs_plain_e2e()
    fa_record["launches_by_path"] = {SERVE_ARCH: fa_record["launches"],
                                     MLA_ARCH: mla_fa, VL_ARCH: vl_fa,
                                     AUDIO_ARCH: audio_fa}
    torch.cuda.empty_cache()          # phases 7 and 23-25 freed theirs
    train = train_path()
    train_vs_plain_e2e()
    launcher_train()
    fa_record["backward"]["launches"] = train["flash_attention_backward"]
    bsr_record["backward"]["launches"] = train["bsr_spmm_backward"]
    fa_record["launches_by_path"][f"{TRAIN_ARCH} training"] = \
        train["flash_attention"]
    bsr_record["launches_by_path"][f"{TRAIN_ARCH} training"] = \
        train["bsr_spmm"]
    torch.cuda.empty_cache()
    log(f"device memory before phase 8: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    ssd_record = check_ssd_chunk()
    ssd_record["backward"] = check_ssd_backward()
    ssd_record["launches"] = serve_mamba()
    mamba_vs_plain_e2e()
    torch.cuda.empty_cache()
    mamba_train = mamba_train_path()
    train_vs_plain_e2e(MAMBA_ARCH, "27b")
    launcher_train(MAMBA_ARCH, "27c")
    launcher_train(HYBRID_ARCH, "27c")
    ssd_record["backward"]["launches"] = mamba_train["ssd_chunk_backward"]
    ssd_record["launches_by_path"] = {
        f"{MAMBA_ARCH} serving": ssd_record["launches"],
        f"{MAMBA_ARCH} training": mamba_train["ssd_chunk"]}
    seg_record["grid_2x2_launches_by_route"], errs = grid_phases()
    seg_record["grid_2x2x2_launches_by_route"], errs3 = grid3_phase()
    _routes_zero()
    robust = robust_phase(graph, mesh)
    seg_record["robust_launches_by_route"] = robust
    elastic = elastic_phase(graph, mesh)
    seg_record["elastic_launches_by_route"] = elastic
    del graph
    torch.cuda.empty_cache()
    ep = ep_phase()
    path = f"{SERVE_ARCH} on the {EP_MESH} mesh, (a) and (b), by rank"
    fa_record["launches_by_path"][path] = ep["flash_attention"]
    bsr_record["launches_by_path"][path] = ep["bsr_spmm"]
    bsr_record["ep_shape"] = ep["ep_shape"]
    fa_record["max_abs_err"] = max(fa_record["max_abs_err"],
                                   ep["flash_max_abs_err"])
    bsr_record["max_abs_err"] = max(bsr_record["max_abs_err"],
                                    ep["bsr_max_abs_err"])
    for rec in (seg_record, smm_record):
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[rec["name"]],
                                 errs3[rec["name"]])
    seg_record["max_abs_err"] = max(seg_record["max_abs_err"],
                                    robust["max_abs_err"],
                                    elastic["max_abs_err"])
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of wall")
    log(json.dumps({"kernels": [seg_record, smm_record, fa_record,
                                bsr_record, ssd_record]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
