#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

``python3 chip_smoke.py --phase-x`` runs phase (x) alone (on a host with
several cards, where its lane mesh takes four distinct ones).

Drives the port's paths end to end on the card: expressions
(``repro_torch.core.torch_backend.compile_expr`` -> ``CompiledExpr``,
``TiledExpr`` under a memory budget, or ``BsrEngine``; ``schedule="auto"``
through the autoscheduler) and fused programs (``compile_program`` ->
``CompiledProgram``), and checks every result against a float64
numpy/scipy oracle. Operands are integer valued
(1-8) from a fixed numpy seed, so every float32 partial sum is an exact
integer and results must EQUAL the oracle whatever order the atomics take.

Phases:
  (a) build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  (b) the 14 Table-1 expressions at i=6, j=5, k=4, l=3, plus the
      multi-fiber locate case;
  (c) SpMV  x(i) = B(i,j) * c(j), B cc 16384 x 16384 (~1.07M nonzeros);
  (d) Gustavson SpMSpM X(i,j) = B(i,k) * C(k,j), order ikj, 4096^3 at
      0.5% density each (key bound above the dense-workspace limit, so the
      sort-merge runs with segment_reduce as its inner sum);
      then the same loop at 1024^3 and 1% density, whose 2**20-key result
      keeps the collapse on scatter_workspace in mul_pair mode;
  (e) Plus3 X(i,j) = B + C + D, 1024 x 1024 at 5% density each;
  (m) (d)'s product with split {i: 4} and parallelize {i: 4}: four lanes
      run one after another and merge in one keyed reduce (segment_reduce,
      the key space being 4096^2); the result must equal (d)'s bit for bit;
  (n) a batch of 16 SpMSpM 1024 at 1% (d2's shape, a seed a member)
      through execute_batch on one plan: each member must equal its own
      single call and the oracle, and scatter_workspace must run in
      mul_pair mode;
  (o) out-of-core SpMM X(i,j) = B(i,k) * C(k,j), B cc 16384 x 16384 at
      0.2%, C dd 16384 x 1024, order ikj, under mem_budget="4GB" with the
      density hint {B: 0.002, C: 1}: auto_tile=False must refuse with the
      untiled estimate 16,282,246,691 bytes; the tiled call must be a
      TiledExpr of 4 tiles ({i: 2, k: 2}, 4,104,153,287 estimated bytes a
      tile), each run in L pieces (lanes over i; L and the per-piece
      capacity are printed), equal to the oracle, record 1 plan miss and 3
      hits, then 4 hits warm, one lane dispatch a tile, free every tile's
      tensors, launch segment_reduce, and peak
      (torch.cuda.max_memory_allocated) within the budget on the first
      and on the warm call; the host stages are timed under cProfile;
  (p) schedule="auto": (d)'s product resolved through the autoscheduler
      (sparsity 0.005, one device, a schedule cache in a temporary
      directory), run through compile_expr and equal to (d)'s oracle; a
      second resolve must be a cache hit; then (o) with "auto" under its
      budget: a tiled pick whose tiles fit, equal to (o)'s oracle (run
      only where the compile cache does not hand back (o)'s own engine);
  (g)-(j) the block-sparse (b-format) path at the full widths of
      llama3.2-3b-bsr (d_model 3072, d_ff 8192, 24 heads of 128, window
      4096 = 32 blocks of 128), through compile_expr -> BsrEngine:
  (g) SpMM x(i,k) = B(i,j) * C(j,k): B = W1^T 8192 x 3072 with 25% of its
      128-blocks kept, C = X^T 3072 x 4096 tokens (spmm_bsr);
  (h) SDDMM X(i,j) = M(i,j) * A(i,k) * C(j,k): M the 8192 x 8192 causal
      sliding-window block mask, A = Q and C = K 8192 x 128 (sddmm_bsr);
      (g) and (h) hold integers |v| <= 3, so they must EQUAL the oracle;
  (i) attention O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d), one head,
      S = 8192, E = D = 128, the mask of (h), standard normal data
      (bsr_attention), within ATTN_TOL of a float64 oracle;
  (j) bsr_flash_attention called directly on all 24 heads, with
      kv_idx = sliding_window_kv_idx(64, 64, 32), causal off and on;
  (k) the fused program of graph attention at ogbn-arxiv's widths (128
      features; 16384 nodes, 14 edges a row drawn uniformly), through
      compile_program -> CompiledProgram:
        T(i,j) = B(i,j) * C(i,f) * D(j,f)   (SDDMM: scores on the edges)
        A(i,g) = T(i,j) * E(j,g)            (SpMM: aggregate neighbours)
      B and T cc, C, D, E and A dd; T fuses, so its COO result becomes
      on-device (seg, crd) levels through coo_to_levels; integers |v| <= 3,
      so A must EQUAL a sparse float64 oracle;
  (k2) the same program with fuse=False: T is materialized on the host
      between two CompiledExpr units; A must equal (k)'s bit for bit;
  (l) coo_to_levels called directly on a 3-level COO, dims
      [4096, 2**25, 8], 2**24 unique sorted keys plus 1024 pad rows, at the
      engine's bucketed capacities and with every capacity half the
      level's count (overflow), and on an empty and a one-row input;
  (l2) the same at extents that are not powers of two, dims
      [4099, 33554393, 7] (the kernel's multiply-shift quotients);
  (s) the pruned transformer (models.pruned_transformer.PrunedTransformer)
      at qwen3-0.6b's widths (d_model 1024, 16 heads and 8 kv heads of
      128, d_ff 3072), 2 of its 28 layers, 128 tokens, attention blocks of
      32 in a window of 2, FFN density 0.5, seed 0: FFN up and down through
      compile_program("auto") (about 201M products each), each head's
      attention a request to a sync SamServer; the forward within 1e-5 of
      reference() (relative to its largest magnitude), 32 requests in 2
      dispatches, one FFN call a layer, bsr_attention launched at least 32
      times on its tensor-core route and a reduce kernel at least once;
      a first and a warm call, then one that records the largest input
      of each kernel for (f); its profiles run after (f);
  (t) the MoE layer at Moonlight's widths (moonshot-v1-16b-a3b: 64
      experts, top-6, d_model 2048, expert d_ff 1408, 2 shared experts):
      apply_moe on a (1, 4096, 2048) prefill in float32 and bfloat16, sam
      at capacity factors 1.0 (pairs drop) and 1.25 against the dense
      one-hot dispatch with the same keep-mask, then at E/k (nothing
      drops) against dense (1e-5 relative in float32, also against a
      float64 oracle, 1e-2 in bfloat16); MoEBlock(64, 2, 8, 2048,
      1408), a decode step of 8 tokens at capacity 2, within 1e-5 of
      moe_swiglu_reference with the same drops (its down stage streams
      369M products), one call, which copies the largest input of each
      kernel to the host for (f); compile_moe_block at the same shape,
      fused and fuse=False, one call each, on integer data in {-1, 0, 1},
      equal to moe_linear_reference exactly, with decisions [True, True,
      False] fused, coo_to_levels launched by the fused cascades and a
      reduce kernel in each; (t)(1)'s profile runs after (f);
  (f) every kernel against its plain PyTorch version at the shapes (c)-(k)
      gave it and at the largest calls of (s) and (t)(2) (float data:
      kernel and plain version each within the float32 summation bound of
      the float64 sum, gamma_n * sum|x| a slot, and equal on the same ids
      with integer values in {-1, 0, 1}; the kernels line carries the
      largest of each kernel's shapes), and fused_imr
      through the intersect_mul_reduce entry on sorted streams with
      NA = 4M, NB = 1M, num_slots = 2**20. The block-sparse kernels are
      also held on a fully masked q block (zeros)
      and in bfloat16; coo_to_levels also at (l)'s shape. sddmm_bsr is also
      held on standard-normal float32 at (h)'s shape, and spmm_bsr at
      (g)'s, each element within the worst case of 3xTF32 against
      float64; spmm_bsr and bsr_attention are timed in bfloat16 at (g) and
      (j); the CUDA-core kernels that the tensor-core route replaced at
      (g), (h) and (j) are timed in turns with it (new, old, old, new); and
      coo_to_levels is timed at (k), (l) and (l2). segment_reduce is held
      and timed at the general entry's calls of (c), (e) and (k) (one
      column), its [a*b, 1] mode's calls of (d), (m) and (o) (a lane of a
      tile), and the general entry at the two shapes PR 17 timed it at,
      rebuilt from (o)'s first tile and (d)'s product streams (2^28 rows
      into 2^23 segments, 4,194,304 into 2^24), with scatter_workspace on
      the same inputs beside them. Before scatter_workspace is held at an
      input, the input's key structure is printed: the distinct ids and
      the id span a tile of 4096 and of 1024 rows, the share of dropped
      rows and where they sit; its library time is index_add_ of the
      kernel's own output rows, staged outside the timed call ([a*b*hit,
      hit] in mul_pair mode). fused_imr's bound counts a's value and
      output key and b's value only at the hits, and the reduce kernels'
      bounds the values of the rows whose id is in range only, in 32-byte
      sectors.
  (q) after (f), last: serving (core.serving.SamServer, threaded,
      max_batch=8): four submitter threads at once, each 16 requests of
      (d2)'s product (a density each, uniform in [0.005, 0.02], a seed each)
      and 4 of (e)'s Plus3, with a b-format SpMM at (g)'s shape and the
      fused GAT program at (k)'s shape on the same server: every result
      equal to its float64 oracle, the 64 (d2) results equal to the same
      engine's execute_batch bit for bit, submitted == completed, no failed
      or rejected request, four sam-serve-* threads while it runs;
      requests/s, latency percentiles, the card's idle share over one served
      burst (profiled; its requests/s too) and a sequential loop (execute
      one (d2) request at a time on a fresh engine) are printed; then (o)
      under a 4 GB budget is refused
      with reason "over-budget" (admission="reject") and served tiled once
      (admission="tile"), equal to (o)'s oracle, its peak above what was
      live before it within the budget;
  (r) distributed tiles: (o)'s TiledExpr through DistTiledExpr with two
      workers, overlap on, tile 1 failing on its first attempt: 4 tiles, a
      retry, the result bit-identical to (o)'s TiledExpr and equal to the
      oracle, peak (above what was live) within the budget, one call;
      then ``python -m repro_torch.launch.serve --sam ...
      --mem-budget B --workers 2`` in a subprocess, B a third of the
      request's untiled estimate, must exit 0 and print its OUT-OF-CORE and
      DISTRIBUTED lines;
  (u) after (s)'s and (t)'s profiles, before (q): the language-model
      serving path (models.model, launch.serve.generate), no hand-written
      kernel on it. (1) qwen3-0.6b at its full configuration (28 layers,
      parameters from init_params on the card, bfloat16 compute):
      generate with batch 4, prompt 32 and 16 greedy tokens, first and
      warm, then its prefill and each decode step timed one by one
      (every logit finite), one decode step profiled (the card's idle
      share), the model FLOP rate 2·N_active·B over the median decode
      step against 989 TFLOP/s, the peak above what was live, and
      ``serve.main(["--arch", "qwen3-0.6b", ...])`` once; in float32, a
      cached prefill and 16 decode steps must equal forward over the 48
      tokens, and the card's forward at 2 of the 28 layers the CPU's,
      within U_TOL. (2) paligemma-3b (2 of 18 layers), musicgen-large (2
      of 48), moonshot-v1-16b-a3b (2 of 48: one dense, one MoE),
      deepseek-v3-671b (1 of 61, first_dense_layers=1: one MLA layer, an
      empty MoE stack), xlstm-125m (all 12), zamba2-2.7b (6 of 54: one
      mamba group and the shared block), at full width: forward on (4, 32)
      and two decode steps (finite; ms and peak), the card's float32
      forward on one row against the CPU's, and for deepseek, xlstm and
      zamba2 a cached prefill and two decode steps against forward,
      within U_TOL;
  (v) after (u), before (q): the language-model training path
      (models.model.loss_fn, train.optimizer, train.train_step,
      data.pipeline, distributed.checkpoint and fault_tolerance,
      launch.train), no hand-written kernel on it. (1) qwen3-0.6b at its
      full configuration (float32 parameters from init_params on the card,
      bfloat16 compute, AdamW with bfloat16 moments, remat "dots"), batch 8
      x 256 from batch_for_step, through launch.train.build and
      TrainingRunner: 6 steps uninterrupted (each step timed; the median
      of steps 2-6, tokens/s, the peak above what was live, the model FLOP
      rate 6·N·2048 over the median step against 989 TFLOP/s), then a run
      with ckpt_every=3 that fails at step 4 and a runner that resumes from
      the step-3 checkpoint: it must run exactly 3 steps with the
      uninterrupted run's losses bit for bit (the checkpoints' host copy,
      write and restore seconds printed); one step profiled (the idle
      share); one step's forward and backward from the same state and
      batch under each of "none", "dots" and "full": the same loss, peaks
      full <= dots <= none.
      (2) qwen3-0.6b at full width, 2 of 28 layers, float32 compute: one
      make_train_step step on (2, 32) on the card and on the CPU from the
      same parameters and batch: the loss within 1e-5 relative, grad_norm
      within 1e-4, each gradient leaf within 1e-4 of its largest
      magnitude, the new parameters within 2 lr. (3) (u)(2)'s six
      families at (u)(2)'s depths and full widths: loss and gradients and
      a plain SGD step at lr 0.05, twice on one (4, 32) batch; the losses
      finite and falling (ms and peak printed);
  (w) after (r), last: the launch tools and the examples. (1)
      ``python -m repro_torch.launch.dryrun --sam`` on the card, in a
      subprocess: X(i,j) = B(i,k) * C(k,j) at 48^3, density 0.1, all 16
      level-format cells through the engine, each equal to the numpy
      oracle, cycles under every simulator.HW_PRESETS entry; (2) the LM
      dry-run on meta tensors (no device) for qwen3-0.6b's four shapes and
      deepseek-v3-671b x train_4k on both production meshes, and
      xlstm-125m x train_4k and zamba2-2.7b x train_4k on both and
      zamba2-2.7b x decode_32k on (16, 16) in three host processes of
      their own (``--w-ssm``, read at the end of (x)): FLOPs, the
      useful ratio model_flops / flops, per-device argument bytes against
      80 GB, the compute and memory terms at the H100's rates and the
      collective term (the step placed on the mesh's shape over a fake
      process group: t_collective and the wire bytes a device by op and
      axis, or the op that refused placement); (3)
      ``roofline_sweep --arch qwen3-0.6b --shape train_4k``, whose probe
      extrapolation must equal (2)'s direct count; (4) the four
      ``examples/torch_*.py`` as subprocesses on the card, each exiting 0
      with its OK line; (1) and (4) start first and overlap (2) and (3);
  (x) after (w), last: lanes and placement over several devices. (1)
      (m)'s product (4096^3 at 0.5%) and (d2)'s (1024^3 at 1%), each with
      split {i: 4} and parallelize {i: 4}, through compile_expr(...,
      shard_lanes=4): the lanes over a lane mesh of four (four distinct
      cards where the host has them, else cuda:0 repeated four times
      through $SAM_LANE_DEVICES, which the log names), each result equal
      to (m)'s and (d2)'s and to the float64 oracle, sharded_dispatches
      >= 1, segment_reduce and scatter_workspace launched, the warm median
      of 3 beside (m)'s and (d2)'s; (2) ``python -m torch.distributed.run
      --standalone --nproc-per-node N -m repro_torch.launch.train --arch
      qwen3-0.6b --batch 8 --seq 256 --steps 3 --model-parallel M`` (N the
      host's cards, M 1, or 2 on four cards): qwen3-0.6b whole on DTensors
      over NCCL, its losses within 1e-5 (relative) of a plain one-process
      run of the same steps (run beside it; with a data axis over 1 card,
      the second and third within 1e-4: each shard's bfloat16 gradients
      round before their sum), and this script with ``--x2-ranks``
      under the same launch (beside them on four cards, after them on
      fewer): one train step of qwen3-0.6b whole (8 x 256,
      bfloat16 compute, remat "dots", AdamW) on its placed parameters
      under ``launch.dryrun.CollectiveCounter``, whose collective bytes by
      op and mesh axis must equal ``launch.dryrun.count_collectives`` of
      the same step on the same mesh (its projections split over the
      model axis on four cards), each card's peak allocated bytes
      printed; then one float32 step of moonshot-v1-16b-a3b at 2
      of 48 layers at full width (one dense layer, one MoE layer of 64
      experts, top-6) on (4, 32), the loss within 1e-5 and every gradient
      leaf within 1e-4 of its largest magnitude against the plain step,
      and one counted train step of it (AdamW): each card's local shard
      of the expert stacks while the MoE layer runs must be the rules'
      (16 of 64 experts on (2, 2): the experts stay on their
      expert-parallel shards and the tokens move to them), its
      collectives must equal ``count_collectives`` of the same step and
      mesh call for call and byte for byte, each card's peak printed;
      (3) deepseek-v3-671b at 2 of 61 layers at full width (one dense
      layer with its MLA and d_ff 18,432, one MoE layer of 256 experts,
      top-8, and its shared expert; 13.9e9 parameters, 56 GB in
      float32), batch (4, 32): on four cards first its placed step under
      ``torch.distributed.run`` (``--x3-ranks``, mesh (2, 2), 64 experts
      a card, each card drawing the whole tree and keeping its shards
      leaf by leaf), every gradient leaf finite, each card's peak
      printed; then, the cards released, the plain forward in a process
      of its own (``--x3-plain``) on the last card, whose loss the
      placed step's must equal within 1e-5; on fewer cards the plain
      forward alone (a plain step's gradients do not fit beside its
      parameters), on a one-card host run right after (a), before this
      process holds the earlier phases' tensors, and reported in (x);
      (4) the SSM and hybrid families split on whole heads: ``python -m
      torch.distributed.run ... -m repro_torch.launch.train --arch
      xlstm-125m --batch 8 --seq 256 --steps 3 --model-parallel M``
      (whole: 12 layers, sLSTM at 3 and 11) beside a plain run, the losses
      equal on one card and within bfloat16's unit roundoff on four
      (``X4_BF16_TOL``), then this script with ``--x4-ranks`` under the
      same launch (beside them on four cards, after them on fewer): a
      float32 xlstm-125m step on (4, 32) against the plain step
      (``X4_XLSTM_TOL``: this model's own reassociation noise, measured
      by ``tools/reassociation_noise.py``, exceeds (2)'s tolerances), a
      counted xlstm-125m train step (bf16, dots, AdamW) and a second one
      timed beside the plain step; zamba2-2.7b at 12 of 54 layers at full width
      (the shared block applied twice), float32, one step on (4, 32)
      within 1e-5 (loss) and 1e-4 (gradients) of the plain step, each
      card's out_proj holding the rules' rows (half on four cards) while
      its layer runs, each card's peak printed, and a counted train step
      of it; both counted steps' collectives must equal
      ``count_collectives`` of the same step and mesh call for call and
      byte for byte; then a placed float32 prefill of (4, 32) and two
      decode steps of each against the plain ones (1e-5, xlstm-125m's
      ``X4_XLSTM_TOL``), no collective issued while an mLSTM or mamba
      state is redistributed;

Launch counters are zeroed before (b) and read after (e): scatter_workspace
and segment_reduce must have launched there. They are zeroed again before
(m), (n), (o) and (p) and read after each: segment_reduce must have
launched in (m) and (o) and scatter_workspace in (n) (the two reduce
kernels' launches in the kernels line are those of (b)-(e) and (m)-(r)).
They are zeroed before (q) and read after it: scatter_workspace,
segment_reduce, spmm_bsr and coo_to_levels must have launched there (their
serving launches are added to the kernels line's); and before (r):
segment_reduce must have launched. They are zeroed again
before each of (g)-(j) and read after it: its kernel must have launched there,
(g)-(i) must report block size 128 and no fallback call, and spmm_bsr,
sddmm_bsr and bsr_attention must have launched only their tensor-core
kernels (the launches by route are printed). They are zeroed
before (k), (k2), (l) and (l2) too: coo_to_levels and a reduce kernel must have
launched in (k), and no call of (k) may regrow its recorded capacities.
They are zeroed before (u) and read after it (no kernel launches there),
and so before and after (v).
(w)'s launches are those its subprocesses print, each counted from 0
in its own process ((1) and the examples; a reduce kernel and spmm_bsr
must have launched); they join the kernels line's. They are zeroed
before (x)(1) and read after it: segment_reduce and scatter_workspace
must have launched there, and their launches join the kernels line's.
They are zeroed before (s)'s first forward and read after it, and before
the call of each of (t)'s MoEBlock and two compile_moe_block builds and
read after it; their launches join the kernels line's.
fused_imr's counter is zeroed before its own entry call in (f) and read
after it. Any mismatch or error exits non-zero. The last lines printed are
the ``kernels`` JSON line (with ``bound_ms`` from ``kernel_roofline``
and ``fp32_bound_ms`` beside it), the card's name
and power limit from nvidia-smi, and the ``ok`` JSON line.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260
# A kernel's bound is repro_torch.roofline.analysis.kernel_roofline:
# max(bytes / HBM rate, operations / rate) at the H100's data-sheet rates.
# For a matrix product on float32 data the rate is three TF32 passes
# (3xTF32 keeps the float32 tolerances below; one pass does not), for
# bfloat16 data the bf16 rate, and for anything else the FP32 rate.
# fp32_bound_ms keeps the earlier rule (every operation at the FP32 rate)
# beside it.
# (i) against its float64 oracle: float32 scores and float32 sums over up
# to 4096 keys a row leave errors near 1e-6; 1e-4 leaves room for that
ATTN_TOL = 1e-4
# a block-sparse kernel against its plain version on the same inputs:
# float32 differs only in summation order (the tolerance of the
# reference's own kernel tests); bfloat16 also rounds the output once
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# (u): float32 logits on the card against float32 logits computed another
# way (the CPU, or a cached prefill and decode steps against one forward),
# relative to the largest: sums of up to 18,432 float32 terms in other
# orders and splits, through up to 28 layers. The bfloat16 runs are held
# to finite logits here; their agreement with the reference is held on the
# CPU (tests/test_torch_lm_model.py, 3e-2 of the largest logit).
U_TOL = 1e-4
# (u)(2): (arch, layers kept, other fields replaced, whether a cached
# prefill and decode must equal the whole-sequence forward: not for the
# MoE, whose capacity drops depend on the token count, nor for the stubs,
# whose patches come with every step)
U_FAMILIES = [
    ("paligemma-3b", 2, {}, False),
    ("musicgen-large", 2, {}, False),
    ("moonshot-v1-16b-a3b", 2, {}, False),
    ("deepseek-v3-671b", 1, {"first_dense_layers": 1}, True),
    ("xlstm-125m", 12, {}, True),
    ("zamba2-2.7b", 6, {}, True),
]

TABLE1 = [
    ("SpMV", "x(i) = B(i,j) * c(j)", "ij", {"B": "cc", "c": "c"}),
    ("SpMSpM_lc", "X(i,j) = B(i,k) * C(k,j)", "ikj", {"B": "cc", "C": "cc"}),
    ("SpMSpM_ip", "X(i,j) = B(i,k) * C(k,j)", "ijk", {"B": "cc", "C": "cc"}),
    ("SpMSpM_op", "X(i,j) = B(i,k) * C(k,j)", "kij", {"B": "cc", "C": "cc"}),
    ("SDDMM", "X(i,j) = B(i,j) * C(i,k) * D(j,k)", "ijk",
     {"B": "cc", "C": "cc", "D": "cc"}),
    ("InnerProd", "x = B(i,j,k) * C(i,j,k)", "ijk", {"B": "ccc", "C": "ccc"}),
    ("TTV", "X(i,j) = B(i,j,k) * c(k)", "ijk", {"B": "ccc", "c": "c"}),
    ("TTM", "X(i,j,k) = B(i,j,l) * C(k,l)", "ijkl", {"B": "ccc", "C": "cc"}),
    ("MTTKRP", "X(i,j) = B(i,k,l) * C(j,k) * D(j,l)", "ijkl",
     {"B": "ccc", "C": "cc", "D": "cc"}),
    ("Residual", "x(i) = b(i) - C(i,j) * d(j)", "ij",
     {"b": "c", "C": "cc", "d": "c"}),
    ("MatTransMul", "x(i) = alpha * Bt(i,j) * c(j) + beta * d(i)", "ij",
     {"Bt": "cc", "c": "c", "d": "c", "alpha": "", "beta": ""}),
    ("MMAdd", "X(i,j) = B(i,j) + C(i,j)", "ij", {"B": "cc", "C": "cc"}),
    ("Plus3", "X(i,j) = B(i,j) + C(i,j) + D(i,j)", "ij",
     {"B": "cc", "C": "cc", "D": "cc"}),
    ("Plus2", "X(i,j,k) = B(i,j,k) + C(i,j,k)", "ijk",
     {"B": "ccc", "C": "ccc"}),
]
TABLE1_DIMS = {"i": 6, "j": 5, "k": 4, "l": 3}
KERNEL_META = {
    "scatter_workspace": (
        "src/repro_torch/kernels/csrc/scatter_workspace.cu",
        "src/repro/kernels/scatter_workspace.py:87"),
    "segment_reduce": (
        "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "src/repro/kernels/segment_reduce.py:67"),
    "fused_imr": (
        "src/repro_torch/kernels/csrc/fused_stream.cu",
        "src/repro/kernels/fused_stream.py:98"),
    "spmm_bsr": (
        "src/repro_torch/kernels/csrc/spmm_bsr.cu",
        "src/repro/kernels/spmm_bsr.py:71"),
    "sddmm_bsr": (
        "src/repro_torch/kernels/csrc/sddmm_bsr.cu",
        "src/repro/kernels/sddmm_bsr.py:61"),
    "bsr_attention": (
        "src/repro_torch/kernels/csrc/bsr_attention.cu",
        "src/repro/kernels/bsr_attention.py:108"),
    "coo_to_levels": (
        "src/repro_torch/kernels/csrc/coo_levels.cu",
        "src/repro/kernels/coo_levels.py:33"),
}
# (k): graph attention as a fused SDDMM -> SpMM program (GAT-style)
GAT = "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)"
GAT_FMT = {"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd", "A": "dd"}
GAT_ORDER = {"T": ("i", "j", "f"), "A": ("i", "j", "g")}


# (w): the dry-run's SAM cells (16 level-format cells at 48^3 take about
# 20 s of simulator cycles on the host) and the examples
X_BATCH, X_SEQ, X_STEPS = 8, 256, 3    # (x)(2)'s qwen3-0.6b run
# (x)(4): xlstm-125m placed against plain. The plain model alone moves
# further than (2)'s tolerances when only its row-parallel products are
# summed as a model axis of 2 sums them (tools/reassociation_noise.py,
# (4, 32) on the CPU: float32 loss 8.4e-8, gradients 1.5e-4 of the
# largest, prefill logits 1.9e-5; bfloat16 loss 4.3e-4), where
# qwen3-0.6b's placed loss moves by about 7e-6. So its float32 step and
# logits are held to about five times that floor, and its bfloat16 CLI
# losses to bfloat16's unit roundoff
X4_XLSTM_TOL = {"loss": 1e-5, "grad": 1e-3, "logits": 1e-4}
X4_BF16_TOL = 2.0 ** -8
W_LM_JSON = ROOT / "chiprun_out" / "w_lm.json"   # (w)(2) and (3)'s records
W_LM_PROC = []              # (w)(2) and (3)'s process, while it runs
W_SSM_PROCS = {}            # (w)(2)'s SSM cells' processes and records
X3_PLAIN = []               # (x)(3)'s plain forward, where it ran early
W_SAM = "X(i,j) = B(i,k) * C(k,j)"
W_SAM_N = 48
W_SAM_DENSITY = 0.1
W_EXAMPLES = ("torch_quickstart.py", "torch_spmm_gustavson.py",
              "torch_serve_batch.py", "torch_autotune.py")


_START = time.perf_counter()
PHASE_END_S = {}            # seconds since start at each phase's last line


def log(*parts):
    text = " ".join(str(p) for p in parts)
    if text.startswith("[") and "]" in text:
        PHASE_END_S[text[1:text.index("]")]] = round(
            time.perf_counter() - _START, 1)
    print(text, flush=True)


def sparse_int(rng, shape, density):
    """Dense float64 array with ~density nonzeros, values in 1..8."""
    n = int(np.prod(shape))
    flat = np.unique(rng.integers(0, n, int(n * density)))
    arr = np.zeros(n)
    arr[flat] = rng.integers(1, 9, flat.size)
    return arr.reshape(shape)


def tree_to_dense(ft) -> np.ndarray:
    """Vectorized dense expansion of a d/c FiberTree (original axes)."""
    if ft.order == 0:
        return np.asarray(ft.vals[0])
    coords = np.zeros((1, 0), dtype=np.int64)
    for lv in ft.levels:
        if lv.format == "dense":
            c = np.arange(lv.dim)
            coords = np.concatenate(
                [np.repeat(coords, lv.dim, axis=0),
                 np.tile(c, len(coords))[:, None]], axis=1)
        else:
            counts = np.diff(np.asarray(lv.seg))[:len(coords)]
            coords = np.concatenate(
                [np.repeat(coords, counts, axis=0),
                 np.asarray(lv.crd)[:, None]], axis=1)
    out = np.zeros(ft.shape)
    out[tuple(coords.T)] = ft.vals
    return np.transpose(out, np.argsort(ft.mode_order))


def check_equal(name, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.abs(got - want).max() if got.shape == want.shape
               else f"shape {got.shape} != {want.shape}")
        raise AssertionError(f"{name}: result differs from oracle ({bad})")


def check_close(name, got, want, tol):
    err = (np.abs(got - want).max() if got.shape == want.shape and got.size
           else 0.0)
    if got.shape != want.shape or not np.isfinite(got).all() or err > tol:
        raise AssertionError(f"{name}: result differs from oracle (max abs "
                             f"err {err}, tolerance {tol})")
    log(f"  {name}: max abs err {err:.3e} against the float64 oracle "
        f"(tolerance {tol})")


def attention_oracle(q, k, v, allow):
    """float64 block-masked softmax attention (no fully masked rows)."""
    sc = (q.astype(np.float64) @ k.astype(np.float64).T) / np.sqrt(q.shape[1])
    sc = np.where(allow, sc, -np.inf)
    p = np.exp(sc - sc.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def attention_pairs(kv_idx, bq, bkv, n_kvblk, causal):
    """Allowed (query, key) pairs of one head under ``kv_idx``."""
    pairs = 0
    r = np.arange(bq)[:, None]
    c = np.arange(bkv)[None, :]
    for qi, row in enumerate(kv_idx):
        for kb in row:
            if 0 <= kb < n_kvblk:
                pairs += (int((qi * bq + r >= kb * bkv + c).sum()) if causal
                          else bq * bkv)
    return pairs


def oracle(expr, arrays):
    """numpy einsum evaluation of a sum-of-products assignment."""
    from repro_torch.core.einsum import parse

    assign = parse(expr)
    out_subs = "".join(assign.lhs.vars)
    total = None
    for t in assign.terms:
        spec = ",".join("".join(f.vars) for f in t.factors)
        val = np.einsum(spec + "->" + out_subs,
                        *[arrays[f.tensor] for f in t.factors])
        total = t.sign * val if total is None else total + t.sign * val
    return total


def warm_ms(fn, reps=5, warmup=True):
    """Median host-clock ms over ``reps`` calls, after one warm-up unless
    the caller's own first call was it (each call ends in a device-to-host
    copy of the result, which synchronizes)."""
    import torch

    if warmup:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps=20):
    """Device time per call from CUDA events around ``reps`` calls, or
    around fewer (at least 3) where ``reps`` would take over a second (a
    plain version or a library call at 2^28 rows takes 0.3-0.6 s)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(reps, int(1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_warmup():
    """Launch a few spin kernels inside a fresh profile before the work it
    measures: the profiler may miss the first device activities of a
    session (call 3, PR 12, recorded no kernel of one profiled call).
    Their events carry the name ``spin_kernel`` and are left out."""
    import torch

    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiled_device_ms(fn, match, reps=20, per_call=1):
    """Per-call device time of ``fn`` from torch.profiler's kernel events:
    (all kernels, the kernels whose name contains ``match``), or
    (None, None) when the profiler recorded no such kernel. Sums are
    divided by the number of calls the profiler recorded (``match``
    kernels over the ``per_call`` of them one call launches), not by
    ``reps``: it does not always record every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a session may record none of the launches (several sessions of one
    # process have): up to three sessions, the first that records any
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = mine = 0.0
        recorded = 0
        split = {}
        for evt in prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or "spin_kernel" in evt.key):
                continue
            total += evt.self_device_time_total
            if match in evt.key:
                mine += evt.self_device_time_total
                recorded += evt.count
                name = re.search(rf"\w*{match}\w*", evt.key).group(0)
                split[name] = (split.get(name, 0.0)
                               + evt.self_device_time_total)
        if recorded:
            break
        log(f"  profiler recorded no {match} launch in session "
            f"{attempt + 1} of 3")
    if not recorded:
        return None, None
    if recorded != reps * per_call:
        log(f"  profiler recorded {recorded} of {reps * per_call} {match} "
            f"launches")
    calls = recorded / per_call
    if per_call > 1:     # a wrapper of several kernels: each one's share
        log("  per call: " + ", ".join(
            f"{k} {v / calls / 1e3:.4f} ms" for k, v in sorted(split.items())))
    return total / calls / 1e3, mine / calls / 1e3


def main() -> int:
    import faulthandler

    import torch

    # a fatal signal (a crash in native code, on any thread) prints every
    # thread's Python stack
    faulthandler.enable(all_threads=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import coord_ops as co
    from repro_torch.core import tiling
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import (CompiledExpr, TiledExpr,
                                                _bucket_cap,
                                                clear_compile_cache,
                                                clear_program_cache,
                                                compile_expr, compile_program)
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_stream import (fused_imr_workspace,
                                                  fused_imr_workspace_plain)
    from repro_torch.kernels.scatter_workspace import scatter_workspace_plain
    from repro_torch.kernels.segment_reduce import (
        segment_reduce_mul, segment_reduce_mul_plain, segment_reduce_plain)
    from repro_torch.kernels.bsr_attention import (bsr_flash_attention,
                                                   bsr_flash_attention_plain)
    from repro_torch.kernels.coo_levels import (coo_to_levels,
                                                coo_to_levels_plain)
    from repro_torch.kernels.sddmm_bsr import sddmm_bsr, sddmm_bsr_plain
    from repro_torch.kernels.spmm_bsr import spmm_bsr, spmm_bsr_plain
    from repro_torch.roofline.analysis import (H100_3XTF32_FLOPS,
                                               H100_BF16_FLOPS,
                                               H100_FP32_FLOPS,
                                               kernel_roofline)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- (a) build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[a] kernels built in {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.name}")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[a] {src}: {line.strip()}")
    log(f"[a] {smi}")
    # (w)(2) and (3) count on meta tensors on the host, with no device:
    # they run in a process of their own beside (b)-(v)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    W_LM_PROC.append(subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--w-lm",
         str(W_LM_JSON)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    for group in W_SSM_CELLS:
        path = ROOT / "chiprun_out" / f"w_ssm_{group}.json"
        W_SSM_PROCS[group] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--w-ssm", group,
             str(path)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), path)
    if torch.cuda.device_count() == 1:
        # (x)(3)'s plain forward draws 56 GB (about 65 GiB at its peak):
        # on one card it runs now, before this process holds the earlier
        # phases' tensors; (x) reports it
        t0 = time.perf_counter()
        X3_PLAIN.append(x3_plain_run())
        log(f"[a] (x)(3)'s plain forward ran in a process of its own "
            f"({time.perf_counter() - t0:.1f} s); (x) reports it")

    from repro_torch.kernels.scatter_workspace import scatter_workspace
    from repro_torch.kernels.segment_reduce import segment_reduce

    # the tensors the main path hands each kernel wrapper, by phase, so (f)
    # can hold each kernel against its plain version at those shapes
    seen = {}
    wrappers = {scatter_workspace.__code__: "scatter_workspace",
                segment_reduce.__code__: "segment_reduce",
                segment_reduce_mul.__code__: "segment_reduce_mul",
                spmm_bsr.__code__: "spmm_bsr",
                sddmm_bsr.__code__: "sddmm_bsr",
                bsr_flash_attention.__code__: "bsr_attention",
                coo_to_levels.__code__: "coo_to_levels"}

    def tensor_elements(kw):
        return sum(v.numel() for v in kw.values() if torch.is_tensor(v))

    def record_kernel_inputs(tag, fn, largest=False, to=None):
        """Run ``fn`` once, keeping a copy of the arguments of every call
        to a kernel wrapper, observed through ``sys.monitoring`` on the
        wrappers' code alone: nothing in the package is rebound, no other
        function pays for it, and it runs beside cProfile, so a profiled
        call can record. ``largest`` keeps, per kernel, only the call with
        the most tensor elements; ``to="cpu"`` copies to the host, so the
        call's own peak on the card is untouched. Returns ``fn``'s result
        and the seconds the host copies took."""
        mon = sys.monitoring
        tool = next(i for i in range(6) if mon.get_tool(i) is None)
        copy_s = [0.0]

        def on_start(code, offset):
            calls = seen.setdefault(tag, {}).setdefault(wrappers[code], [])
            kw = sys._getframe(1).f_locals
            if largest and calls and (tensor_elements(kw)
                                      <= tensor_elements(calls[0])):
                return
            if to:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept = {k: (v.to(to) if to else v.clone())
                    if torch.is_tensor(v) else v for k, v in kw.items()}
            copy_s[0] += time.perf_counter() - t0 if to else 0.0
            calls[:] = [kept] if largest else calls + [kept]
        mon.use_tool_id(tool, "chip_smoke")
        mon.register_callback(tool, mon.events.PY_START, on_start)
        for code in wrappers:
            mon.set_local_events(tool, code, mon.events.PY_START)
        try:
            out = fn()
        finally:
            for code in wrappers:
                mon.set_local_events(tool, code, 0)
            mon.register_callback(tool, mon.events.PY_START, None)
            mon.free_tool_id(tool)
        return out, copy_s[0]

    def on_card(kw):
        return {k: v.cuda() if torch.is_tensor(v) else v
                for k, v in kw.items()}

    rng = np.random.default_rng(SEED)
    kops.reset_launch_counts()
    per_phase = {}

    # -- (b) Table 1 -------------------------------------------------------
    for name, expr, order, fmts in TABLE1:
        from repro_torch.core.einsum import parse
        arrays = {}
        for t in parse(expr).terms:
            for f in t.factors:
                if f.tensor not in arrays:
                    arrays[f.tensor] = (
                        np.asarray(float(rng.integers(1, 5))) if not f.vars
                        else sparse_int(rng, tuple(TABLE1_DIMS[v]
                                                   for v in f.vars), 0.4))
        eng = compile_expr(expr, Format(dict(fmts)),
                           Schedule(loop_order=tuple(order)), TABLE1_DIMS)
        check_equal(name, tree_to_dense(eng(arrays)), oracle(expr, arrays))
    B = sparse_int(rng, (6, 7), 0.5)
    C = sparse_int(rng, (6, 7), 0.5)
    for cf in ("dd", "dc", "cc"):
        eng = compile_expr(
            "X(i,j) = B(i,j) * C(i,j)", Format({"B": "cc", "C": cf}),
            Schedule(loop_order=("i", "j"), locate=frozenset({("C", "j")})),
            {"i": 6, "j": 7})
        check_equal(f"locate-{cf}", tree_to_dense(eng({"B": B, "C": C})),
                    B * C)
    per_phase["b"] = kops.launch_counts()
    log(f"[b] 14 Table-1 cases + 3 multi-fiber locate cases equal numpy; "
        f"launches {per_phase['b']}")

    workloads = {}

    def host_profile(fn, top=6):
        """Where one warm call spends its host time: the functions of the
        package with the most cumulative time under cProfile (which slows
        Python-heavy stages, so these are shares, not latencies)."""
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.runcall(fn)
        rows = []
        for (path, _, func), (_, _, _, cum, _) in pstats.Stats(
                prof).stats.items():
            if "repro_torch" in path and func != "__call__":
                rows.append((cum * 1e3, f"{pathlib.Path(path).stem}.{func}"))
        rows.sort(reverse=True)
        return [{"cum_ms": ms, "name": name} for ms, name in rows[:top]]

    def device_profile(fn):
        """Kernel time on the card during one warm call (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = []
        for evt in prof.key_averages():
            # kernel events only: the host ops that launched them report
            # the same device time again
            dev_us = evt.self_device_time_total
            if (evt.device_type == torch.autograd.DeviceType.CUDA and dev_us
                    and "spin_kernel" not in evt.key):
                rows.append((dev_us / 1e3, evt.count, evt.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        return {"wall_ms": wall, "device_busy_ms": busy,
                "idle_share": (1 - busy / wall) if busy else None,
                "top_kernels": [{"ms": ms, "count": n, "name": k[:80]}
                                for ms, n, k in rows[:8]]}

    def expr_engine(expr, fmts, order, dims):
        return compile_expr(expr, Format(fmts), Schedule(loop_order=order),
                            dims)

    def run_workload(tag, label, eng, arrays, want, check=check_equal,
                     reps=3, result=lambda out: out):
        """Drive one engine on one operand set: first call, warm median,
        recorded kernel inputs, host and device profiles. ``result`` picks
        the checked FiberTree out of what the engine returns; the first
        call's dense result is returned."""
        before = kops.launch_counts()
        t0 = time.perf_counter()
        got = eng(arrays)
        first_ms = (time.perf_counter() - t0) * 1e3
        dense = tree_to_dense(result(got))
        check(label, dense, want)
        ms = warm_ms(lambda: eng(arrays), reps, warmup=False)
        # the host-profiled call records the kernels' inputs, and is checked
        outs = []
        host = host_profile(lambda: outs.append(record_kernel_inputs(
            tag, lambda: eng(arrays))[0]))
        check(label + " (warm)", tree_to_dense(result(outs.pop())), want)
        prof = device_profile(lambda: eng(arrays))
        after = kops.launch_counts()
        per_phase[tag] = {k: after[k] - before[k] for k in after}
        workloads[label] = {"first_ms": first_ms, "warm_ms": ms,
                            "result_nnz": int(np.count_nonzero(want)),
                            "host_profile": host, "profile": prof,
                            "stats": dict(eng.stats)}
        idle = prof["idle_share"]
        log(f"[{tag}] {label}: first call {first_ms:.1f} ms, warm median "
            f"{ms:.1f} ms over {reps} calls; result nnz "
            f"{workloads[label]['result_nnz']}; launches {per_phase[tag]}")
        log(f"[{tag}] {label}: host (cProfile cumulative ms) " + ", ".join(
            f"{r['name']} {r['cum_ms']:.1f}" for r in host))
        log(f"[{tag}] {label}: profiled call {prof['wall_ms']:.1f} ms with "
            f"{prof['device_busy_ms']:.3f} ms of kernels on the card, idle "
            f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
        for row in prof["top_kernels"][:4]:
            log(f"[{tag}]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
        log(f"[{tag}] engine stats {eng.stats}")
        return dense

    # -- (c) SpMV ------------------------------------------------------------
    import scipy.sparse as sp

    n = 16384
    B = sparse_int(rng, (n, n), 0.004)
    c = rng.integers(1, 9, n).astype(float)
    log(f"[c] B nnz {np.count_nonzero(B)}")
    run_workload("c", "SpMV 16384",
                 expr_engine("x(i) = B(i,j) * c(j)", {"B": "cc", "c": "c"},
                             ("i", "j"), {"i": n, "j": n}),
                 {"B": B, "c": c}, sp.csr_matrix(B) @ c)
    del B

    # -- (d) Gustavson SpMSpM ----------------------------------------------
    n = 4096
    B = sparse_int(rng, (n, n), 0.005)
    C = sparse_int(rng, (n, n), 0.005)
    Bs, Cs = sp.csr_matrix(B), sp.csr_matrix(C)
    products = int(np.diff(Cs.indptr)[Bs.indices].sum())
    log(f"[d] B nnz {Bs.nnz}, C nnz {Cs.nnz}, products {products}")
    spmspm_d = {"B": B, "C": C}           # (m) splits the same product
    want_d = (Bs @ Cs).toarray()
    # (f) rebuilds the product stream PR 17 timed segment_reduce on
    Bo = Bs.tocoo()
    d_csr = {"b": [torch.as_tensor(a, device="cuda") for a in (
                 Bo.row.astype(np.int64), Bo.col.astype(np.int64),
                 Bo.data.astype(np.float32))],
             "c": [torch.as_tensor(a, device="cuda") for a in (
                 Cs.indptr.astype(np.int64), Cs.indices.astype(np.int64),
                 Cs.data.astype(np.float32))]}
    del Bo
    got_d = run_workload("d", "SpMSpM 4096 ikj",
                         expr_engine("X(i,j) = B(i,k) * C(k,j)",
                                     {"B": "cc", "C": "cc"}, ("i", "k", "j"),
                                     {"i": n, "j": n, "k": n}),
                         spmspm_d, want_d)
    del B, C, Bs, Cs

    # the same loop with a result of 1024 x 1024 = 2**20 keys: the collapse
    # stays inside the dense-workspace bound, so mul_reduce runs
    # scatter_workspace in mul_pair mode
    n = 1024
    B = sparse_int(rng, (n, n), 0.01)
    C = sparse_int(rng, (n, n), 0.01)
    want_d2 = (sp.csr_matrix(B) @ sp.csr_matrix(C)).toarray()
    got_d2 = run_workload("d2", "SpMSpM 1024 ikj",
                          expr_engine("X(i,j) = B(i,k) * C(k,j)",
                                      {"B": "cc", "C": "cc"},
                                      ("i", "k", "j"),
                                      {"i": n, "j": n, "k": n}),
                          {"B": B, "C": C}, want_d2)
    x_d2 = ({"B": B, "C": C}, want_d2, got_d2)      # (x) runs them again
    del B, C, want_d2, got_d2

    # -- (e) Plus3 -------------------------------------------------------------
    n = 1024
    arrays = {t: sparse_int(rng, (n, n), 0.05) for t in "BCD"}
    run_workload("e", "Plus3 1024",
                 expr_engine("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
                             {"B": "cc", "C": "cc", "D": "cc"}, ("i", "j"),
                             {"i": n, "j": n}),
                 arrays, arrays["B"] + arrays["C"] + arrays["D"])

    main_counts = kops.launch_counts()
    log(f"[b-e] launches on the main path: {main_counts}")
    for name in ("scatter_workspace", "segment_reduce"):
        for tag in ("c", "d", "d2", "e"):
            if name in seen.get(tag, {}) and per_phase[tag][name] == 0:
                raise AssertionError(f"{name} was called in ({tag}) but "
                                     f"never launched")
        if not any(per_phase[t][name] for t in ("c", "d", "d2", "e")):
            raise AssertionError(f"{name} never launched in (c)-(e)")

    # -- (m) (d)'s product, split and parallelized over 4 lanes --------------
    n = 4096
    kops.reset_launch_counts()
    got_m = run_workload(
        "m", "SpMSpM 4096 lanes",
        compile_expr("X(i,j) = B(i,k) * C(k,j)",
                     Format({"B": "cc", "C": "cc"}),
                     Schedule(loop_order=("i", "k", "j"), split={"i": 4},
                              parallelize={"i": 4}),
                     {"i": n, "j": n, "k": n}),
        spmspm_d, want_d)
    lanes_m = workloads["SpMSpM 4096 lanes"]
    if (not np.array_equal(got_m, got_d)
            or per_phase["m"]["segment_reduce"] < 1
            or lanes_m["stats"]["lane_dispatches"] < 1):
        raise AssertionError(f"(m) differs from (d) or launched "
                             f"{per_phase['m']} with stats "
                             f"{lanes_m['stats']}")
    log(f"[m] equals (d) bit for bit; warm {lanes_m['warm_ms']:.3f} ms "
        f"against (d)'s {workloads['SpMSpM 4096 ikj']['warm_ms']:.3f} "
        f"({lanes_m['warm_ms'] / workloads['SpMSpM 4096 ikj']['warm_ms']:.3f}"
        f"x); lane_dispatches {lanes_m['stats']['lane_dispatches']}")
    x_m = (spmspm_d, want_d, got_m)   # (x) runs them again
    del got_d, got_m                  # (p) runs (d)'s operands again

    # -- (n) a batch of 16 SpMSpM 1024, one seed a member ---------------------
    n, members = 1024, 16
    batch, wants = [], []
    for m in range(members):
        rm = np.random.default_rng(SEED + 1 + m)
        Bm, Cm = sparse_int(rm, (n, n), 0.01), sparse_int(rm, (n, n), 0.01)
        batch.append({"B": Bm, "C": Cm})
        wants.append((sp.csr_matrix(Bm) @ sp.csr_matrix(Cm)).toarray())
    dims_n = {"i": n, "j": n, "k": n}
    beng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                        Format({"B": "cc", "C": "cc"}),
                        Schedule(loop_order=("i", "k", "j")), dims_n)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = beng.execute_batch(batch)
    first_n = (time.perf_counter() - t0) * 1e3
    if beng.stats["plan_misses"] != 1:
        raise AssertionError(f"(n) warm-up batch stats {beng.stats}")
    batch_ms = warm_ms(lambda: beng.execute_batch(batch), reps=3)
    record_kernel_inputs("n", lambda: beng.execute_batch(batch))
    prof_n = device_profile(lambda: beng.execute_batch(batch))
    per_phase["n"] = kops.launch_counts()
    single = expr_engine("X(i,j) = B(i,k) * C(k,j)", {"B": "cc", "C": "cc"},
                         ("i", "k", "j"), dims_n)        # (d2)'s engine
    for m, (out, arrays, want) in enumerate(zip(
            beng.execute_batch(batch), batch, wants)):
        dense = tree_to_dense(out)
        check_equal(f"(n) member {m}", dense, want)
        check_equal(f"(n) member {m} against its single call",
                    dense, tree_to_dense(single(arrays)))
    mul_pair = [kw["mul_pair"] for kw in
                seen.get("n", {}).get("scatter_workspace", [])]
    if (beng.stats["plan_misses"] != 1 or not any(mul_pair)
            or per_phase["n"]["scatter_workspace"] < 1):
        raise AssertionError(f"(n) stats {beng.stats}, launches "
                             f"{per_phase['n']}, mul_pair calls {mul_pair}")
    d2_ms = workloads["SpMSpM 1024 ikj"]["warm_ms"]
    workloads["SpMSpM 1024 batch of 16"] = {
        "first_ms": first_n, "warm_ms": batch_ms,
        "member_warm_ms": batch_ms / members, "profile": prof_n,
        "stats": dict(beng.stats),
        "result_nnz": [int(np.count_nonzero(w)) for w in wants]}
    idle = prof_n["idle_share"]
    log(f"[n] {members} members equal their single calls and the oracle on "
        f"one plan; first batch {first_n:.1f} ms, warm batch {batch_ms:.1f} "
        f"ms = {batch_ms / members:.3f} ms a member against (d2)'s single "
        f"warm {d2_ms:.3f} ({batch_ms / members / d2_ms:.3f}x); launches "
        f"{per_phase['n']}")
    log(f"[n] profiled batch {prof_n['wall_ms']:.1f} ms with "
        f"{prof_n['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
    for row in prof_n["top_kernels"][:4]:
        log(f"[n]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    log(f"[n] engine stats {beng.stats}")
    del batch, wants, outs

    # -- (o) out-of-core SpMM under a memory budget -------------------------
    # the repo's own out-of-core case (benchmarks/tiled_oob.py): B 16384^2 at
    # 0.2% (about 33 a row), C 16384 x 1024 dense, under a 4 GB budget
    n, nj = 16384, 1024
    o_expr, o_fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "dd"})
    o_sch = Schedule(loop_order=("i", "k", "j"))
    o_dims, o_dens = {"i": n, "j": nj, "k": n}, {"B": 0.002, "C": 1.0}
    o_budget = tiling.parse_budget("4GB")
    o_arrays = {"B": sparse_int(rng, (n, n), 0.002),
                "C": rng.integers(1, 9, (n, nj)).astype(float)}
    want_o = sp.csr_matrix(o_arrays["B"]) @ o_arrays["C"]
    log(f"[o] B nnz {np.count_nonzero(o_arrays['B'])}, C {n} x {nj} dense; "
        f"result nnz {np.count_nonzero(want_o)}")
    try:
        compile_expr(o_expr, o_fmt, o_sch, o_dims, mem_budget="4GB",
                     sparsity=o_dens, auto_tile=False)
        raise AssertionError("(o) the untiled call was not refused")
    except tiling.MemoryBudgetExceeded as exc:
        o_untiled = exc.estimate
    if o_untiled != 16282246691:
        raise AssertionError(f"(o) untiled estimate {o_untiled}")
    teng = compile_expr(o_expr, o_fmt, o_sch, o_dims, mem_budget="4GB",
                        sparsity=o_dens)
    if not isinstance(teng, TiledExpr) or teng.n_tiles != 4:
        raise AssertionError(f"(o) engine {type(teng).__name__}")
    log(f"[o] refused untiled at {o_untiled} bytes; tiled {teng.tile_of}, "
        f"{teng.n_tiles} tiles of {teng.tile_bytes} estimated bytes")
    if (teng.tile_of != {"i": 2, "k": 2} or teng.tile_bytes != 4104153287
            or teng.pieces < 2 or teng.engine.par_n != teng.pieces):
        raise AssertionError(f"(o) plan {teng.tile_of}, {teng.tile_bytes} "
                             f"bytes a tile, {teng.pieces} pieces")

    def peak_call(label):
        """One tiled call: host ms, peak allocated bytes over it, and the
        per-tile engine's plan misses and hits and lane dispatches (one a
        tile run in pieces) it added."""
        st0 = dict(teng.engine.stats)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = teng(o_arrays)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check_equal(f"(o) {label}", tree_to_dense(out), want_o)
        after = torch.cuda.memory_allocated()
        if after != base:
            raise AssertionError(f"(o) {label}: {after - base} bytes "
                                 f"outlive the call")
        return ms, peak, {k: teng.engine.stats[k] - st0[k]
                          for k in ("plan_misses", "plan_hits",
                                    "lane_dispatches")}, out

    kops.reset_launch_counts()
    first_o, peak_first, st_first, _ = peak_call("first call")
    # (r) holds its distributed calls against this result
    warm_o, peak_warm, st_warm, o_result = peak_call("warm call")
    per_phase["o"] = kops.launch_counts()
    # one plan for the four tiles, each run in pieces: one lane dispatch
    # a tile
    if (st_first != {"plan_misses": 1, "plan_hits": 3, "lane_dispatches": 4}
            or st_warm != {"plan_misses": 0, "plan_hits": 4,
                           "lane_dispatches": 4}
            or per_phase["o"]["segment_reduce"] < 1):
        raise AssertionError(f"(o) plan stats {st_first} then {st_warm}, "
                             f"launches {per_phase['o']}")
    caps_o = next(iter(teng.engine._plans.values())).caps
    piece_cap = max(caps_o.values())
    log(f"[o] each tile in L = {teng.pieces} pieces (lanes over "
        f"{o_sch.loop_order[0]}); per-piece capacity {piece_cap} rows "
        f"(caps {caps_o})")
    log(f"[o] equals the oracle exactly; first call {first_o:.1f} ms, warm "
        f"{warm_o:.1f} ms; plans {st_first} then {st_warm}; launches "
        f"{per_phase['o']}")
    log(f"[o] peak allocated {peak_first} bytes (first call), {peak_warm} "
        f"(warm), {max(peak_first, peak_warm) / piece_cap:.1f} bytes a row "
        f"of the per-piece capacity; tile_bytes {teng.tile_bytes}, budget "
        f"{o_budget}, untiled estimate {o_untiled}")
    if peak_first > o_budget or peak_warm > o_budget:
        raise AssertionError(f"(o) peak {peak_first} (first call), "
                             f"{peak_warm} (warm) above the budget "
                             f"{o_budget}")
    o_peak = max(peak_first, peak_warm)

    # (f) holds segment_reduce at the largest shape the pieces gave it (the
    # host-profiled call below records it), and rebuilds the first tile's
    # product stream PR 17 timed it on
    # (C's dense tile as a CSR whose every row holds all nj columns)
    ti, tk = np.nonzero(o_arrays["B"][:n // 2, :n // 2])
    o_tile = {"b": [torch.as_tensor(ti, device="cuda"),
                    torch.as_tensor(tk, device="cuda"),
                    torch.as_tensor(o_arrays["B"][ti, tk], device="cuda",
                                    dtype=torch.float32)],
              "c": [torch.arange(0, n // 2 * nj + 1, nj, device="cuda"),
                    torch.arange(nj, device="cuda").repeat(n // 2),
                    torch.as_tensor(o_arrays["C"][:n // 2], device="cuda",
                                    dtype=torch.float32).reshape(-1)]}
    del ti, tk

    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(record_kernel_inputs, "o", lambda: teng(o_arrays),
                 largest=True)
    seen["o"] = {k: v for k, v in seen["o"].items()
                 if k == "segment_reduce_mul"}
    stages = {}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(
            prof).stats.items():
        if func in ("_measure_hints", "slice_operands", "accumulate_coo",
                    "_finalize", "execute_coo") and "repro_torch" in path:
            stages[func] = stages.get(func, 0.0) + cum * 1e3
    prof_o = device_profile(lambda: teng(o_arrays))
    idle = prof_o["idle_share"]
    workloads["SpMM 16384 x 1024 tiled"] = {
        "first_ms": first_o, "warm_ms": warm_o,
        "result_nnz": int(np.count_nonzero(want_o)), "peak_bytes": o_peak,
        "peak_first_bytes": peak_first, "peak_warm_bytes": peak_warm,
        "tile_bytes": teng.tile_bytes, "budget": o_budget,
        "pieces": teng.pieces, "piece_caps": caps_o,
        "untiled_estimate": o_untiled, "host_stages_ms": stages,
        "profile": prof_o, "stats": dict(teng.stats),
        "engine_stats": dict(teng.engine.stats)}
    log("[o] host (cProfile cumulative ms) " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(stages.items(),
                                          key=lambda kv: -kv[1])))
    log(f"[o] profiled call {prof_o['wall_ms']:.1f} ms with "
        f"{prof_o['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
    for row in prof_o["top_kernels"][:4]:
        log(f"[o]   {row['ms']:.3f} ms x{row['count']} {row['name']}")

    # -- (p) schedule="auto" ------------------------------------------------
    # (d)'s product searched, then (o)'s under its budget; a cache file of
    # its own in a temporary directory
    import os
    import tempfile

    from repro_torch.core.autoschedule import resolve_schedule

    kops.reset_launch_counts()
    saved_cache = os.environ.get("SAM_SCHEDULE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SAM_SCHEDULE_CACHE"] = os.path.join(tmp, "s.json")
        try:
            d_fmt = Format({"B": "cc", "C": "cc"})
            d_dims = {"i": 4096, "j": 4096, "k": 4096}
            # compile_expr searches for one device (lanes run on one card)
            t0 = time.perf_counter()
            res = resolve_schedule(o_expr, d_fmt, d_dims, sparsity=0.005,
                                   device_count=1)
            search_s = time.perf_counter() - t0
            peng = compile_expr(o_expr, d_fmt, "auto", d_dims,
                                sparsity=0.005)
            again = resolve_schedule(o_expr, d_fmt, d_dims, sparsity=0.005,
                                     device_count=1)
            if (res.cache_hit or res.report is None or not again.cache_hit
                    or again.report is not None
                    or peng.schedule != res.schedule
                    or again.schedule != res.schedule):
                raise AssertionError("(p) the pick was not searched once "
                                     "and then served from the cache")
            t0 = time.perf_counter()
            check_equal("(p) SpMSpM 4096 auto", tree_to_dense(peng(spmspm_d)),
                        want_d)
            p_ms = (time.perf_counter() - t0) * 1e3
            p_warm = warm_ms(lambda: peng(spmspm_d), reps=3)
            log(f"[p] SpMSpM 4096 auto: pick {res.report.best.spec.key()} "
                f"(cycles {res.report.best.cycles}); search {search_s:.3f} s, "
                f"enumerated {res.report.enumerated}, simulated "
                f"{res.report.simulated}; the second resolve a cache hit; "
                f"equals (d)'s oracle, first call {p_ms:.1f} ms, warm "
                f"median {p_warm:.1f} ms over 3 calls")
            t0 = time.perf_counter()
            po = compile_expr(o_expr, o_fmt, "auto", o_dims,
                              mem_budget="4GB", sparsity=o_dens)
            po_s = time.perf_counter() - t0
            if (not isinstance(po, TiledExpr) or not po.schedule.tile
                    or po.tile_bytes > o_budget):
                raise AssertionError(f"(p) budgeted pick {po.schedule}")
            # the compile cache may hand back (o)'s own engine, whose
            # result (o) checked; any other pick runs here
            ran = ""
            if po is not teng:
                t0 = time.perf_counter()
                check_equal("(p) (o) auto", tree_to_dense(po(o_arrays)),
                            want_o)
                ran = (f"; equals (o)'s oracle, "
                       f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            log(f"[p] (o) auto under 4GB: pick {po.schedule.loop_order} tile "
                f"{po.schedule.tile} ({po.n_tiles} tiles of "
                f"{po.tile_bytes} estimated bytes, search and build "
                f"{po_s:.3f} s; the engine of (o): {po is teng}){ran}")
        finally:
            if saved_cache is None:
                os.environ.pop("SAM_SCHEDULE_CACHE", None)
            else:
                os.environ["SAM_SCHEDULE_CACHE"] = saved_cache
    per_phase["p"] = kops.launch_counts()
    workloads["SpMSpM 4096 auto"] = {
        "pick": res.report.best.spec.key(), "search_s": search_s,
        "enumerated": res.report.enumerated,
        "simulated": res.report.simulated, "first_ms": p_ms,
        "warm_ms": p_warm}
    log(f"[p] launches {per_phase['p']}")
    del peng, po

    # -- (g)-(j) the block-sparse path at llama3.2-3b-bsr's widths ------------
    # d_model 3072, d_ff 8192, 24 heads of 128, window 4096 tokens
    bs, d_model, d_ff, tokens = 128, 3072, 8192, 4096
    s_len, hd, heads, win = 8192, 128, 24, 32

    per_route = {}

    def check_routes(tag, kernel):
        """The phase's calls of a two-route kernel all took the tensor
        cores (no CUDA-core launch)."""
        per_route[tag] = kops.route_counts()
        got = per_route[tag].get(kernel)
        if got is not None and (got["tensor_cores"] < 1
                                or got["cuda_cores"]):
            raise AssertionError(f"({tag}) {kernel} routes {got}")
        log(f"[{tag}] launches by route {per_route[tag]}")

    def run_bsr(tag, label, kind, kernel, expr, fmts, dims, arrays, want,
                check=check_equal):
        kops.reset_launch_counts()
        run_workload(tag, label, expr_engine(expr, fmts, tuple(dims), dims),
                     arrays, want, check=check, reps=3)
        st = workloads[label]["stats"]
        if (st["kernel"] != kind or st["block_size"] != bs
                or st["fallback_calls"] or per_phase[tag][kernel] < 1):
            raise AssertionError(f"({tag}) {label}: stats {st}, launches "
                                 f"{per_phase[tag]}")
        check_routes(tag, kernel)

    # (g) block-pruned FFN up-projection: W1^T (d_ff x d_model) @ X^T
    nbr, nbc = d_ff // bs, d_model // bs
    keep = np.zeros(nbr * nbc, bool)
    keep[rng.choice(nbr * nbc, nbr * nbc // 4, replace=False)] = True
    w1t = (np.kron(keep.reshape(nbr, nbc), np.ones((bs, bs), np.int8))
           * rng.integers(-3, 4, (d_ff, d_model), dtype=np.int8)
           ).astype(np.float32)
    xt = rng.integers(-3, 4, (d_model, tokens)).astype(np.float32)
    want = w1t.astype(np.float64) @ xt.astype(np.float64)
    log(f"[g] W1^T {d_ff} x {d_model}: {int(keep.sum())} of {keep.size} "
        f"blocks kept; X^T {d_model} x {tokens}")
    run_bsr("g", "SpMM W1^T X^T", "spmm", "spmm_bsr",
            "x(i,k) = B(i,j) * C(j,k)", {"B": "bb", "C": "dd", "x": "dd"},
            {"i": d_ff, "j": d_model, "k": tokens}, {"B": w1t, "C": xt},
            want)
    del w1t, xt, want

    # (h) sampled attention scores under the causal sliding-window mask
    n_win = s_len // bs
    kv_win = kops.sliding_window_kv_idx(n_win, n_win, win)
    allow_blk = np.zeros((n_win, n_win), bool)
    qb = np.repeat(np.arange(n_win), win)
    live = kv_win.ravel() < n_win
    allow_blk[qb[live], kv_win.ravel()[live]] = True
    mask = (np.kron(allow_blk, np.ones((bs, bs), np.int8))
            * rng.integers(1, 4, (s_len, s_len), dtype=np.int8)
            ).astype(np.float32)
    a_q = rng.integers(-3, 4, (s_len, hd)).astype(np.float32)
    c_k = rng.integers(-3, 4, (s_len, hd)).astype(np.float32)
    want = mask.astype(np.float64) * (a_q.astype(np.float64)
                                      @ c_k.astype(np.float64).T)
    log(f"[h] M {s_len} x {s_len}: {int(allow_blk.sum())} of "
        f"{allow_blk.size} blocks")
    run_bsr("h", "SDDMM M*(Q K^T)", "sddmm", "sddmm_bsr",
            "X(i,j) = M(i,j) * A(i,k) * C(j,k)", {"M": "bb", "X": "dd"},
            {"i": s_len, "j": s_len, "k": hd},
            {"M": mask, "A": a_q, "C": c_k}, want)
    del a_q, c_k, want

    # (i) one head of llama3.2-3b-bsr through the attention pattern
    qkv = {t: rng.standard_normal((s_len, hd)).astype(np.float32)
           for t in "QKV"}
    allow = np.kron(allow_blk, np.ones((bs, bs), bool))
    want = attention_oracle(qkv["Q"], qkv["K"], qkv["V"], allow)
    del allow
    run_bsr("i", "attention 1 head", "attention", "bsr_attention",
            "O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)",
            {"M": "bb", "Q": "dd", "K": "dd", "V": "dd", "O": "dd"},
            {"i": s_len, "j": s_len, "e": hd, "d": hd},
            {"M": mask, **qkv}, want,
            check=lambda n, got, w: check_close(n, got, w, ATTN_TOL))
    del mask, qkv, want

    # (j) the attention kernel on all heads, called directly
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q_all, k_all, v_all = (torch.randn((heads, s_len, hd), device="cuda",
                                       generator=g) for _ in range(3))
    kv_all = torch.as_tensor(kv_win, device="cuda")
    kops.reset_launch_counts()
    outs = {c: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                   bkv=bs, causal=c) for c in (False, True)}
    torch.cuda.synchronize()
    per_phase["j"] = kops.launch_counts()
    if per_phase["j"]["bsr_attention"] != 2:
        raise AssertionError(f"(j) launches {per_phase['j']}")
    check_routes("j", "bsr_attention")
    for causal, out in outs.items():
        if out.shape != q_all.shape or not torch.isfinite(out).all():
            raise AssertionError(f"(j) causal={causal}: not finite")
    log(f"[j] bsr_flash_attention on {heads} heads x {s_len} x {hd}, "
        f"causal off and on: finite; launches {per_phase['j']}")
    del outs

    # -- (k), (k2) the fused GAT-style program -------------------------------
    # ogbn-arxiv's widths: 128 node features, mean degree about 13.7 once
    # symmetrized; the node count is cut to 16384 (the entry point takes
    # dense operands) and the degree is uniform (14 distinct neighbours a row)
    n_nodes, deg, feat = 16384, 14, 128
    src = np.repeat(np.arange(n_nodes), deg)
    dst = np.concatenate([rng.choice(n_nodes, deg, replace=False)
                          for _ in range(n_nodes)])
    edge = rng.integers(1, 4, src.size) * rng.choice([-1, 1], src.size)
    adj = np.zeros((n_nodes, n_nodes))
    adj[src, dst] = edge
    feats = {t: rng.integers(-3, 4, (n_nodes, feat)).astype(float)
             for t in "CDE"}
    gat_arrays = {"B": adj, **feats}
    scores = edge * np.einsum("ef,ef->e", feats["C"][src], feats["D"][dst])
    gat_want = sp.csr_matrix((scores, (src, dst)),
                             shape=(n_nodes, n_nodes)) @ feats["E"]
    gat_dims = {"i": n_nodes, "j": n_nodes, "f": feat, "g": feat}
    log(f"[k] B {n_nodes} x {n_nodes}: {src.size} edges; C, D, E "
        f"{n_nodes} x {feat}")
    gat_out = {}

    def run_program(tag, label, fuse):
        kops.reset_launch_counts()
        cp = compile_program(
            GAT, Format(GAT_FMT),
            {k: Schedule(loop_order=o) for k, o in GAT_ORDER.items()},
            gat_dims, fuse=fuse)
        gat_out[tag] = run_workload(tag, label, cp, gat_arrays, gat_want,
                                    reps=3, result=lambda out: out["A"])
        units = [dict(u.stats) for _, _, u in cp.units]
        workloads[label]["unit_stats"] = units
        log(f"[{tag}] units {units}")
        return cp, units

    # the first call records capacities, so no call of (k) may regrow them
    cp, units = run_program("k", "GAT fused", True)
    reduces = (per_phase["k"]["segment_reduce"]
               + per_phase["k"]["scatter_workspace"])
    if (cp.stats["fused_stages"] != 2 or cp.stats["fused_intermediates"] != 1
            or cp.stats["materialized_handoffs"] != 0
            or per_phase["k"]["coo_to_levels"] < 1 or reduces < 1
            or any(u["overflow_retries"] for u in units)):
        raise AssertionError(f"(k) stats {cp.stats}, launches "
                             f"{per_phase['k']}, units {units}")
    cp, _ = run_program("k2", "GAT unfused", False)
    if (cp.stats["fused_stages"] != 0
            or cp.stats["materialized_handoffs"] != 1
            or not np.array_equal(gat_out["k2"], gat_out["k"])):
        raise AssertionError(f"(k2) stats {cp.stats}, or A differs from (k)")
    log(f"[k2] A is bit-identical to (k)'s; warm median fused "
        f"{workloads['GAT fused']['warm_ms']:.1f} ms, unfused "
        f"{workloads['GAT unfused']['warm_ms']:.1f} ms")
    clear_program_cache()
    del adj, gat_arrays, gat_out, cp

    # -- (l) coo_to_levels alone at 2**24 keys -------------------------------
    dims_l = [4096, 1 << 25, 8]
    n_l = 1 << 24
    g = torch.Generator(device="cuda").manual_seed(SEED)
    space = 4096 * (1 << 25) * 8
    raw = torch.unique(torch.randint(0, space, (n_l + (1 << 16),),
                                     device="cuda", generator=g))
    pick = torch.randperm(raw.numel(), device="cuda", generator=g)[:n_l]
    keys_l = torch.cat([raw[pick.sort().values],
                        torch.full((1024,), co.PAD_KEY, device="cuda")])
    valid_l = keys_l != co.PAD_KEY
    del raw, pick
    counts_l, pref = [], keys_l[:n_l]
    for d in reversed(dims_l):
        counts_l.insert(0, int(torch.unique(pref).numel()))
        pref = pref // d
    caps_l = [_bucket_cap(c) for c in counts_l]

    def coo_equal(got, want, where):
        for part, dtype in enumerate((torch.int32, torch.int32,
                                      torch.int64)):
            for lvl, (a, b) in enumerate(zip(got[part], want[part])):
                if a.dtype != dtype or not torch.equal(a, b):
                    raise AssertionError(f"coo_to_levels differs from its "
                                         f"plain version at {where}: part "
                                         f"{part}, level {lvl}")

    kops.reset_launch_counts()
    for caps in (caps_l, [c // 2 for c in counts_l]):
        got = coo_to_levels(keys_l, valid_l, dims_l, caps)
        coo_equal(got, coo_to_levels_plain(keys_l, valid_l, dims_l, caps),
                  f"(l) caps {caps}")
        if [int(c) for c in got[2]] != counts_l:
            raise AssertionError(f"(l) counts {got[2]} != {counts_l}")
    for keys_e in (torch.zeros(0, dtype=torch.int64, device="cuda"),
                   torch.tensor([12345], device="cuda")):
        valid_e = torch.ones_like(keys_e, dtype=torch.bool)
        coo_equal(coo_to_levels(keys_e, valid_e, dims_l, [8, 8, 8]),
                  coo_to_levels_plain(keys_e, valid_e, dims_l, [8, 8, 8]),
                  f"(l) N={keys_e.numel()}")
    torch.cuda.synchronize()
    per_phase["l"] = kops.launch_counts()
    if per_phase["l"]["coo_to_levels"] != 4:
        raise AssertionError(f"(l) launches {per_phase['l']}")
    log(f"[l] coo_to_levels on N={keys_l.numel()} dims {dims_l}: counts "
        f"{counts_l} exact and equal to the plain version at caps {caps_l} "
        f"and at half the counts (overflow); N=0 and N=1 equal too")

    # -- (l2) the same at extents that are not powers of two ----------------
    dims_l2 = [4099, 33554393, 7]
    space = 4099 * 33554393 * 7
    raw = torch.unique(torch.randint(0, space, (n_l + (1 << 16),),
                                     device="cuda", generator=g))
    pick = torch.randperm(raw.numel(), device="cuda", generator=g)[:n_l]
    keys_l2 = torch.cat([raw[pick.sort().values],
                         torch.full((1024,), co.PAD_KEY, device="cuda")])
    valid_l2 = keys_l2 != co.PAD_KEY
    del raw, pick
    counts_l2, pref = [], keys_l2[:n_l]
    for d in reversed(dims_l2):
        counts_l2.insert(0, int(torch.unique(pref).numel()))
        pref = pref // d
    caps_l2 = [_bucket_cap(c) for c in counts_l2]
    kops.reset_launch_counts()
    for caps in (caps_l2, [c // 2 for c in counts_l2]):
        got = coo_to_levels(keys_l2, valid_l2, dims_l2, caps)
        coo_equal(got, coo_to_levels_plain(keys_l2, valid_l2, dims_l2, caps),
                  f"(l2) caps {caps}")
        if [int(c) for c in got[2]] != counts_l2:
            raise AssertionError(f"(l2) counts {got[2]} != {counts_l2}")
    torch.cuda.synchronize()
    per_phase["l2"] = kops.launch_counts()
    if per_phase["l2"]["coo_to_levels"] != 2:
        raise AssertionError(f"(l2) launches {per_phase['l2']}")
    log(f"[l2] coo_to_levels on N={keys_l2.numel()} dims {dims_l2}: counts "
        f"{counts_l2} exact and equal to the plain version at caps "
        f"{caps_l2} and at half the counts (overflow)")

    # -- (s) the pruned transformer at qwen3-0.6b's widths -------------------
    # configs/qwen3_0_6b.py: d_model 1024, 16 heads and 8 kv heads of 128,
    # d_ff 3072; depth cut from 28 layers to 2, 128 tokens. Its profiles
    # run after (f): a profile that spans the server leaves later sessions
    # missing device events
    import dataclasses
    import tempfile

    from repro_torch.configs.qwen3_0_6b import CFG as QWEN
    from repro_torch.models.pruned_transformer import PrunedTransformer

    s_cfg = dataclasses.replace(QWEN, n_layers=2)
    s_x = np.random.default_rng(SEED + 700).standard_normal(
        (128, s_cfg.d_model)).astype(np.float32)
    saved_cache = os.environ.get("SAM_SCHEDULE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SAM_SCHEDULE_CACHE"] = os.path.join(tmp, "s.json")
        try:
            t0 = time.perf_counter()
            model = PrunedTransformer(s_cfg, seq_len=128, block=32,
                                      window_blocks=2, ffn_density=0.5,
                                      seed=0)
            s_build_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if saved_cache is None:
                os.environ.pop("SAM_SCHEDULE_CACHE", None)
            else:
                os.environ["SAM_SCHEDULE_CACHE"] = saved_cache
    s_want = model.reference(s_x)

    def peak_call(fn):
        """One call: its host ms and its peak allocated bytes above what
        was live before it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - base)

    def rel_err(got, want):
        got = np.asarray(got, np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            return np.inf
        return float(np.abs(got - want).max() / np.abs(want).max())

    kops.reset_launch_counts()
    s_y, s_first, s_peak_first = peak_call(lambda: model(s_x))
    per_phase["s"] = kops.launch_counts()
    check_routes("s", "bsr_attention")
    s_stats = model.stats()
    s_err = rel_err(s_y, s_want)
    if (s_err > 1e-5 or s_stats["server"]["completed"] != 32
            or s_stats["server"]["dispatches"] != 2
            or s_stats["ffn_up_calls"] != 2
            or per_phase["s"]["bsr_attention"] < 32
            or per_phase["s"]["scatter_workspace"]
            + per_phase["s"]["segment_reduce"] < 1):
        raise AssertionError(f"(s) rel err {s_err}, stats {s_stats}, "
                             f"launches {per_phase['s']}")
    _, s_warm, s_peak_warm = peak_call(lambda: model(s_x))
    # (f) holds each kernel at the largest call a forward makes of it
    record_kernel_inputs("s", lambda: model(s_x), largest=True)
    workloads["pruned transformer (s)"] = {
        "build_ms": s_build_ms, "first_ms": s_first, "warm_ms": s_warm,
        "peak_first_bytes": s_peak_first, "peak_warm_bytes": s_peak_warm,
        "rel_err": s_err, "stats": s_stats, "ffn_loop_orders": [
            list(st.schedule.loop_order) for cp in (model.ffn_up,
                                                    model.ffn_down)
            for st in cp.lp.stages]}
    log(f"[s] PrunedTransformer(qwen3-0.6b, 2 of 28 layers, 128 tokens, "
        f"blocks of 32, window 2, FFN density 0.5): built in "
        f"{s_build_ms:.1f} ms; first call {s_first:.1f} ms, warm "
        f"{s_warm:.1f} ms; peak {s_peak_first} and {s_peak_warm} bytes; rel "
        f"err {s_err:.3e} against reference() (tolerance 1e-5); "
        f"{s_stats['server']['completed']} attention requests in "
        f"{s_stats['server']['dispatches']} dispatches, ffn_up_calls "
        f"{s_stats['ffn_up_calls']}; the \"auto\" FFN loop orders "
        f"{workloads['pruned transformer (s)']['ffn_loop_orders']}; launches "
        f"{per_phase['s']}")
    del s_y

    # -- (t) the MoE layer at Moonlight's widths -----------------------------
    # configs/moonshot_v1_16b_a3b.py: 64 experts, top-6, d_model 2048,
    # expert d_ff 1408, 2 shared experts; one layer of 48. (t)(1)'s profile
    # runs after (f), as (s)'s do
    from repro_torch.configs.moonshot_v1_16b_a3b import CFG as MOON
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import apply_mlp
    from repro_torch.models.moe_blocks import (MoEBlock, compile_moe_block,
                                               moe_linear_reference,
                                               moe_swiglu_reference,
                                               routing_tensors)

    n_exp, top_k = MOON.n_experts, MOON.top_k
    dm, dff = MOON.d_model, MOON.moe_d_ff
    g = torch.Generator(device="cuda").manual_seed(SEED)
    moe_p = moe_mod.init_moe(g, dm, dff, n_exp,
                             n_shared=MOON.n_shared_experts)
    t_x = torch.randn((1, 4096, dm), device="cuda", generator=g)

    def masked_dense(x, gate, dtype):
        """The dense one-hot dispatch with the kept gate in the compute
        dtype: every expert on every token, combined by ``gate``, plus the
        shared experts (it rounds where sam rounds)."""
        xf = x.reshape(-1, dm).to(dtype)
        ye = moe_mod._expert_ffn(moe_p, xf.expand(n_exp, *xf.shape), dtype)
        out = torch.einsum("et,etd->td", torch.as_tensor(
            gate, device="cuda").to(dtype), ye)
        return (out + apply_mlp(moe_p["shared"], xf, compute_dtype=dtype)
                ).float().cpu().numpy()

    def moe_oracle(x, gate):
        """float64 on the card: each expert on the tokens it keeps,
        combined by the kept gate, plus the shared experts."""
        x64 = x.reshape(-1, dm).double()
        out = torch.zeros_like(x64)
        gate = torch.as_tensor(gate, device="cuda")
        for e in range(n_exp):
            live = gate[e].nonzero().squeeze(1)
            if live.numel():
                h = (torch.nn.functional.silu(
                    x64[live] @ moe_p["w_gate"][e].double())
                     * (x64[live] @ moe_p["w_up"][e].double()))
                out[live] += gate[e, live, None] * (
                    h @ moe_p["w_down"][e].double())
        sh = moe_p["shared"]
        out += (torch.nn.functional.silu(x64 @ sh["w_gate"].double())
                * (x64 @ sh["w_up"].double())) @ sh["w_down"].double()
        return out.cpu().numpy()

    w_t, ids_t = moe_mod.route_topk(moe_p["router"], t_x.reshape(-1, dm),
                                    top_k)
    w_t, ids_t = w_t.cpu().numpy(), ids_t.cpu().numpy()
    # the largest load an expert takes: capacities above it keep every pair
    t_load = int(np.bincount(ids_t.ravel(), minlength=n_exp).max())
    t1 = {}

    def prefill(name, dtype, disp, cf):
        """One apply_moe configuration: first call, warm (CUDA events),
        peak; returns the output as float32 numpy (T, D)."""
        def run():
            return moe_mod.apply_moe(moe_p, t_x, k=top_k, dispatch=disp,
                                     capacity_factor=cf, compute_dtype=dtype)
        out, first, peak = peak_call(run)
        t1[(name, disp, cf)] = {"first_ms": first,
                                "warm_ms": event_ms(run, reps=5),
                                "peak_bytes": peak}
        return out.float().cpu().numpy().reshape(-1, dm)

    # capacity factor 1.0 (384 slots an expert, the mean load) drops pairs;
    # 1.25 is the default; E / k gives T slots, so nothing drops. The kept
    # gate (E, T) is routing_tensors' combine tensor summed over the slots
    gates = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        name = str(dtype).split(".")[1]
        dense_out = prefill(name, dtype, "dense", None)
        for cf in (1.0, 1.25, n_exp / top_k):
            cap = max(8, int(cf * 4096 * top_k / n_exp))
            sam_out = prefill(name, dtype, "sam", cf)
            kept = min(cap, t_load)
            if kept not in gates:
                _, S_t, dropped = routing_tensors(w_t, ids_t, n_exp, kept)
                gates[kept] = (S_t.sum(2).T, dropped)
                del S_t
            gate, dropped = gates[kept]
            if cf < n_exp / top_k:
                # sam crops each expert to its capacity: hold it against the
                # dense one-hot dispatch with the same keep-mask
                err = rel_err(sam_out, masked_dense(t_x, gate, dtype))
                what = "the masked dense dispatch"
            else:
                err = rel_err(sam_out, dense_out.astype(np.float64))
                what = "dense"
            err64 = rel_err(sam_out, moe_oracle(t_x, gate))
            log(f"[t] apply_moe {name}, capacity_factor {cf:.4f} (cap {cap}):"
                f" {dropped} of {ids_t.size} pairs dropped; sam against "
                f"{what}: rel err {err:.3e} (tolerance {tol}); against the "
                f"masked float64 oracle {err64:.3e}")
            t1[(name, "rel_err", cf)] = {"err": err, "err64": err64,
                                         "dropped": dropped, "cap": cap}
            if (err > tol or (dtype == torch.float32 and err64 > tol)
                    or (cf == 1.0) != (dropped > 0)):
                raise AssertionError(f"(t) apply_moe {name} cf {cf}: rel "
                                     f"err {err} ({err64} from float64) "
                                     f"above {tol}, or {dropped} dropped")
    for (name, disp, cf), row in t1.items():
        if disp != "rel_err":
            log(f"[t] apply_moe (1, 4096, {dm}) {name} {disp}"
                + ("" if cf is None else f" cf {cf:.4f}") + ": first "
                f"{row['first_ms']:.3f} ms, warm {row['warm_ms']:.3f} ms "
                f"(CUDA events), peak {row['peak_bytes']} bytes")
    workloads["MoE prefill (t)"] = {
        "runs": {f"{n} {d} {c}": v for (n, d, c), v in t1.items()},
        "warm_ms": t1[("float32", "sam", 1.25)]["warm_ms"]}
    del sam_out, dense_out, gates

    # (t)(2) MoEBlock: one decode step of 8 tokens at capacity 2; the
    # reference's interface takes float64 numpy weights, which a call
    # encodes (about 50 s on the host), so the phase makes one call: timed,
    # its peak read, and the inputs of each kernel's largest call copied to
    # the host for (f) (the copies' seconds are taken off its time)
    p64 = {k: moe_p[k].double().cpu().numpy()
           for k in ("router", "w_gate", "w_up", "w_down")}
    x8 = np.random.default_rng(SEED + 800).standard_normal((8, dm))
    block = MoEBlock(n_exp, 2, 8, dm, dff)
    kops.reset_launch_counts()
    (got8, t2_copy_s), t2_ms, t2_peak = peak_call(
        lambda: record_kernel_inputs("t", lambda: block(p64, x8, k=top_k),
                                     largest=True, to="cpu"))
    t2_first = t2_ms - t2_copy_s * 1e3
    per_phase["t2"] = kops.launch_counts()
    w8, ids8 = moe_mod.route_topk(moe_p["router"],
                                  torch.as_tensor(x8, dtype=torch.float32,
                                                  device="cuda"), top_k)
    G8, S8, dropped8 = routing_tensors(w8.cpu().numpy(), ids8.cpu().numpy(),
                                       n_exp, 2)
    t0 = time.perf_counter()
    want8 = moe_swiglu_reference(p64, x8, G8, S8)
    t2_oracle_s = time.perf_counter() - t0
    t2_err = rel_err(got8, want8)
    if (t2_err > 1e-5 or block.last_dropped != dropped8
            or per_phase["t2"]["coo_to_levels"] < 1
            or per_phase["t2"]["scatter_workspace"]
            + per_phase["t2"]["segment_reduce"] < 1):
        raise AssertionError(f"(t) MoEBlock rel err {t2_err}, dropped "
                             f"{block.last_dropped} ({dropped8}), launches "
                             f"{per_phase['t2']}")
    log(f"[t] MoEBlock({n_exp}, 2, 8, {dm}, {dff}), top-{top_k}: "
        f"last_dropped {block.last_dropped}; one call {t2_first:.1f} ms "
        f"({t2_ms:.1f} with {t2_copy_s * 1e3:.1f} of host copies of the "
        f"kernels' inputs); peak {t2_peak} bytes (the down stage streams "
        f"{n_exp * 2 * dff * dm} products); rel err {t2_err:.3e} against "
        f"moe_swiglu_reference (tolerance 1e-5, {t2_oracle_s:.1f} s in "
        f"numpy); launches {per_phase['t2']}")
    workloads["MoEBlock decode (t)"] = {
        "first_ms": t2_first, "copy_ms": t2_copy_s * 1e3,
        "peak_bytes": t2_peak, "rel_err": t2_err,
        "last_dropped": block.last_dropped, "oracle_s": t2_oracle_s}
    del got8, block, p64

    # (t)(3) the linear MoE chain on integer data in {-1, 0, 1}: every
    # partial sum stays far below 2**24, so both builds must equal the
    # float64 oracle exactly; one call each (two float weights of 184.5M
    # entries are encoded a call)
    rt = np.random.default_rng(SEED + 900)
    G8, S8, _ = routing_tensors(np.ones_like(w8.cpu().numpy()),
                                ids8.cpu().numpy(), n_exp, 2)
    lin_arrays = {"G": G8, "S": S8,
                  "X": rt.integers(-1, 2, (8, dm)).astype(float),
                  "Wu": rt.integers(-1, 2, (n_exp, dm, dff)).astype(float),
                  "Wd": rt.integers(-1, 2, (n_exp, dff, dm)).astype(float)}
    t0 = time.perf_counter()
    lin_want = moe_linear_reference(**lin_arrays)["O"]
    t3_oracle_s = time.perf_counter() - t0
    for tag, fuse in (("t3", True), ("t3s", False)):
        cp = compile_moe_block(n_exp, 2, 8, dm, dff, fuse=fuse)
        decisions = [d.fused for d in cp.decisions]
        kops.reset_launch_counts()
        out, ms, peak = peak_call(lambda: cp(lin_arrays))
        per_phase[tag] = kops.launch_counts()
        check_equal(f"({tag}) compile_moe_block fuse={fuse}",
                    out["O"].to_dense(), lin_want)
        if (decisions != ([True, True, False] if fuse else [False] * 3)
                or (fuse and per_phase[tag]["coo_to_levels"] < 1)
                or per_phase[tag]["scatter_workspace"]
                + per_phase[tag]["segment_reduce"] < 1):
            raise AssertionError(f"({tag}) decisions {decisions}, launches "
                                 f"{per_phase[tag]}")
        workloads["MoE chain " + ("fused" if fuse else "staged") + " (t)"] = {
            "first_ms": ms, "peak_bytes": peak, "decisions": decisions}
        log(f"[t] compile_moe_block({n_exp}, 2, 8, {dm}, {dff}, fuse={fuse})"
            f": decisions {decisions}; O equals moe_linear_reference "
            f"({t3_oracle_s:.1f} s in numpy) exactly; one call {ms:.1f} ms, "
            f"peak {peak} bytes; launches {per_phase[tag]}")
        clear_program_cache()
        del cp, out
    del lin_arrays

    # -- (f) kernels against their plain versions ----------------------------
    # each kernel is timed at the last input a warm (plan-cached) call of
    # each workload handed it; the kernels line carries the largest of
    # those shapes
    kernels, measured = [], []

    def held(name, out_k, out_p, where, tol=0.0):
        """Max abs error of a kernel's output against its plain version's;
        raises unless every element is within tol + tol * |plain|."""
        torch.cuda.synchronize()
        diff = (out_k.double() - out_p.double()).abs()
        err = float(diff.max()) if out_k.numel() else 0.0
        if (out_k.shape != out_p.shape or not torch.isfinite(out_k).all()
                or bool((diff > tol + tol * out_p.double().abs()).any())):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at {where} (max abs err {err}, "
                                 f"tolerance {tol})")
        return err

    def paired_ms(new, old):
        """The kernel and the CUDA-core kernel its route replaced, timed in
        turns on the same inputs: new, old, old, new."""
        return [event_ms(fn) for fn in (new, old, old, new)]

    def timed_library(name, library):
        """Time one PyTorch library call, or None where there is none or it
        does not run."""
        if library is None:
            return None
        try:
            library()
            return event_ms(library)
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            log(f"[f] {name}: library call not timed ({exc})"[:300])
            return None

    def report(name, launches, kernel, plain, library, nbytes, nops, where,
               tol=0.0, flat=lambda out: out, per_call=1,
               rate=H100_FP32_FLOPS, check=None):
        """Hold a kernel against its plain version and time both; ``rate``
        is the operation rate of its bound (``H100_3XTF32_FLOPS`` for the
        float32 matrix products). ``check(kernel_out, plain_out)``, where
        given, replaces the elementwise tolerance and returns the max abs
        error."""
        if check is None:
            err = held(name, flat(kernel()), flat(plain()), where, tol)
        else:
            err = check(kernel(), plain())
        roof = kernel_roofline(nops, nbytes, peak_flops=rate)
        fp32_roof = kernel_roofline(nops, nbytes, peak_flops=H100_FP32_FLOPS)
        t_bytes, t_ops = roof["t_memory"], roof["t_compute"]
        row = {"name": name, "route": "cuda",
               "source": KERNEL_META[name][0],
               "replaces": KERNEL_META[name][1], "launches": launches,
               "max_abs_err": err, "ms": event_ms(kernel),
               "plain_ms": event_ms(plain), "bound_ms": max(t_bytes, t_ops)
               * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else
               "operations", "library_ms": timed_library(name, library),
               "fp32_bound_ms": max(t_bytes, fp32_roof["t_compute"]) * 1e3,
               "shape": where, "bytes": nbytes}
        # CUDA events time the wrapper call as the engine pays it, host
        # launch gaps included; the profiler splits out device time
        row["device_ms"], row["kernel_device_ms"] = profiled_device_ms(
            kernel, name,          # each kernel's symbol contains its name
            per_call=per_call)
        # the same events again, after the profiled run: a spread between
        # the two readings is the card's, not the kernel's
        row["ms_again"] = event_ms(kernel)
        measured.append(row)
        dev = ("device not measured" if row["device_ms"] is None else
               f"device {row['device_ms']:.4f}, of it the kernel "
               f"{row['kernel_device_ms']:.4f}")
        lib = ("not timed" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"[f] {name} at {where}: ms {row['ms']:.4f} (again after the "
            f"profile {row['ms_again']:.4f}; {dev}) plain_ms "
            f"{row['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; fp32_bound_ms "
            f"{row['fp32_bound_ms']:.4f}) max_abs_err {err}")
        return row

    def sector_bytes(rows, row_bytes):
        """Bytes of the 32-byte sectors that hold the given rows of an
        array of ``row_bytes``-byte rows (a row of up to 32 bytes spans at
        most two sectors)."""
        if not rows.numel():
            return 0
        first = rows * row_bytes // 32
        last = (rows * row_bytes + row_bytes - 1) // 32
        touched = torch.zeros(int(last.max()) + 1, dtype=torch.bool,
                              device=rows.device)
        touched[first] = True
        touched[last] = True
        return int(touched.sum()) * 32

    # the reduce kernels skip a row whose id lies outside [0, slots) before
    # they read its values, so their bound counts every id, the values of
    # the live rows in the sectors that hold them, and the output once
    def reduce_launches(name):
        return sum(per_phase[t][name] for t in "mnop") + main_counts[name]

    def integer_valued(*tensors):
        return all(t is None or bool(torch.equal(t, t.round()))
                   for t in tensors)

    def sum_bound_check(name, where, ids, terms, nslots, product):
        """The check for float data, whose sums the kernel's atomics and
        the plain version's ``index_add_`` take in different orders: each
        output within gamma_n * sum|x| of its slot's float64 sum, n the
        slot's row count plus one where each term is a product rounded to
        float32 first (float32 summation in any order; the float64 sums'
        own error, at most n * 2^-52 * sum|x|, is added to the bound).
        ``terms``: the (N, C) exact float64 terms, zero where a row adds
        nothing."""
        ids64 = ids.long()
        ids64 = torch.where((ids64 >= 0) & (ids64 < nslots), ids64, nslots)

        def slot_sum(x):
            return torch.zeros((nslots + 1,) + tuple(x.shape[1:]),
                               dtype=torch.float64, device="cuda"
                               ).index_add_(0, ids64, x)[:nslots]
        exact, mag = slot_sum(terms), slot_sum(terms.abs())
        n = slot_sum(torch.ones(ids64.numel(), dtype=torch.float64,
                                device="cuda")) + (1 if product else 0)
        nu = n * 2.0 ** -24
        if bool((nu >= 0.5).any()):
            raise AssertionError(f"{name} at {where}: a slot of "
                                 f"{int(n.max())} rows has no float32 bound")
        tol = ((nu / (1 - nu) + n * 2.0 ** -52)[:, None] * mag)
        del ids64, mag, n, nu

        def check(out_k, out_p):
            torch.cuda.synchronize()
            for who, out in (("kernel", out_k), ("plain version", out_p)):
                if out.shape != exact.shape or not torch.isfinite(out).all():
                    raise AssertionError(f"{name}: the {who} gives "
                                         f"{tuple(out.shape)} or non-finite "
                                         f"values at {where}")
                over = float(((out.double() - exact).abs() - tol).max())
                if over > 0:
                    raise AssertionError(
                        f"{name}: the {who} leaves the float32 summation "
                        f"bound of the float64 sum at {where} by {over}")
            err = float((out_k.double() - out_p.double()).abs().max())
            log(f"  {name} at {where}: float data; kernel and plain version "
                f"each within gamma_n * sum|x| of the float64 sum of every "
                f"slot (largest bound {float(tol.max()):.3e}); they differ "
                f"by at most {err:.3e}")
            return err
        return check

    def equal_on_integers(name, where, run, values, keep_last=False):
        """``run(values) -> (kernel out, plain out)`` on the same ids with
        the values redrawn as integers in {-1, 0, 1} (``keep_last`` keeps
        the last column, a hit mask): every float32 partial sum is then an
        exact integer (a slot holds fewer than 2^23 rows, which the bound
        check asserts), so the two must be equal."""
        g = torch.Generator(device="cuda").manual_seed(SEED)
        ints = [torch.randint(-1, 2, v.shape, device="cuda", generator=g
                              ).to(v.dtype) for v in values]
        if keep_last:
            ints[0][:, -1] = values[0][:, -1]
        out_k, out_p = run(*ints)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version on integer values at {where}")
        log(f"  {name} at {where}: the same ids with integer values in "
            f"{{-1, 0, 1}}: kernel equals its plain version")

    def id_figures(where, ids, slots, tile=4096):
        """The key structure of a scatter_workspace input, by tiles of
        ``tile`` rows: the distinct live ids and their span (max - min + 1)
        a tile (largest and median over the tiles that hold a live row),
        the share of dropped rows (ids outside [0, slots)) and where they
        sit (their runs, and whether they are one run at the end)."""
        n = ids.numel()
        live = (ids >= 0) & (ids < slots)
        distinct, span = [], []
        for t0 in range(0, n, tile * 8192):      # 2^25 rows at a time
            blk = ids[t0:t0 + tile * 8192].long()
            ok = live[t0:t0 + tile * 8192]
            pad = -blk.numel() % tile
            blk = torch.nn.functional.pad(torch.where(ok, blk, -1), (0, pad),
                                          value=-1).view(-1, tile)
            srt = blk.sort(dim=1).values
            has = srt[:, -1] >= 0
            lo = torch.where(srt >= 0, srt, 1 << 40).min(dim=1).values
            span.append((srt[:, -1] - lo + 1)[has])
            distinct.append((((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0))
                             .sum(dim=1) + (srt[:, 0] >= 0).long())[has])
            del blk, ok, srt, has, lo
        distinct, span = torch.cat(distinct), torch.cat(span)
        n_dead = n - int(live.sum())
        dead_runs = (int(~live[0]) + int((live[:-1] & ~live[1:]).sum())
                     if n_dead else 0)
        at_end = bool(n_dead and not live[n - n_dead:].any())
        first_dead = (int((~live).nonzero()[0]) if n_dead else None)
        log(f"  ids at {where}: tiles of {tile} rows with a live id "
            f"{span.numel()}; distinct ids a tile max "
            f"{int(distinct.max()) if distinct.numel() else 0} median "
            f"{int(distinct.median()) if distinct.numel() else 0}; span a "
            f"tile max {int(span.max()) if span.numel() else 0} median "
            f"{int(span.median()) if span.numel() else 0}; dropped "
            f"{n_dead} of {n} ({n_dead / max(n, 1):.4f}) in "
            f"{dead_runs} runs, first at row {first_dead}, "
            + ("all at the end" if at_end else "not only at the end"))
        return {"tile": tile, "distinct_max": int(distinct.max())
                if distinct.numel() else 0, "span_max": int(span.max())
                if span.numel() else 0, "dropped": n_dead,
                "dropped_at_end": at_end}

    def workspace_row(tag, ids, cols, slots, mp):
        n_live = int(((ids >= 0) & (ids < slots)).sum())
        where = (f"({tag}) N={ids.numel()} live={n_live} "
                 f"C={cols.shape[1]} slots={slots} mul_pair={mp}")
        figures = [id_figures(where, ids, slots, tile)
                   for tile in (4096, 1024)]
        check = None
        if not integer_valued(cols):
            if mp:
                hit = cols[:, 2] > 0
                c64 = torch.where(hit, cols[:, 0].double()
                                  * cols[:, 1].double(), 0.0)
                c64 = torch.stack([c64, hit.double()], 1)
                del hit
            else:
                c64 = cols.double()
            check = sum_bound_check("scatter_workspace", where, ids, c64,
                                    slots, mp)
            del c64
            equal_on_integers(
                "scatter_workspace", where, lambda c: (
                    scatter_workspace(ids, c, num_slots=slots, mul_pair=mp),
                    scatter_workspace_plain(ids, c, num_slots=slots,
                                            mul_pair=mp)),
                [cols], keep_last=mp)
        ids64 = ids.long()
        ids64 = torch.where((ids64 >= 0) & (ids64 < slots), ids64, slots)
        c_out = 2 if mp else cols.shape[1]
        if mp:
            # the library call's input is the kernel's own [a*b*hit, hit],
            # staged here, outside the timed call
            hit = cols[:, 2] > 0
            lib_cols = torch.stack([torch.where(hit, cols[:, 0] * cols[:, 1],
                                                0.0), hit.float()], 1)
            del hit
        else:
            lib_cols = cols.contiguous()
        live = ((ids >= 0) & (ids < slots)).nonzero().squeeze(1)
        row = report(
            "scatter_workspace", reduce_launches("scatter_workspace"),
            lambda: scatter_workspace(ids, cols, num_slots=slots,
                                      mul_pair=mp),
            lambda: scatter_workspace_plain(ids, cols, num_slots=slots,
                                            mul_pair=mp),
            lambda: torch.zeros((slots + 1, c_out), device="cuda"
                                ).index_add_(0, ids64, lib_cols),
            ids.numel() * ids.element_size()
            + sector_bytes(live, cols.shape[1] * 4) + slots * c_out * 4,
            live.numel() * c_out, where, check=check)
        row["ids"] = figures
        return row

    def segment_row(tag, vals, sids, nseg):
        """The general entry: (N, D) values by int32 id."""
        sids64 = sids.long().clamp(0, nseg)
        live = ((sids >= 0) & (sids < nseg)).nonzero().squeeze(1)
        where = (f"({tag}) N={vals.shape[0]} live={live.numel()} "
                 f"D={vals.shape[1]} S={nseg}")
        check = None
        if not integer_valued(vals):
            check = sum_bound_check("segment_reduce", where, sids,
                                    vals.double(), nseg, False)
            equal_on_integers(
                "segment_reduce", where, lambda v: (
                    segment_reduce(v, sids, num_segments=nseg),
                    segment_reduce_plain(v, sids, num_segments=nseg)),
                [vals])
        return report(
            "segment_reduce", reduce_launches("segment_reduce"),
            lambda: segment_reduce(vals, sids, num_segments=nseg),
            lambda: segment_reduce_plain(vals, sids, num_segments=nseg),
            lambda: torch.zeros((nseg + 1, vals.shape[1]), device="cuda",
                                dtype=vals.dtype
                                ).index_add_(0, sids64, vals),
            sids.numel() * sids.element_size()
            + sector_bytes(live, vals.shape[1] * vals.element_size())
            + nseg * vals.shape[1] * vals.element_size(),
            live.numel() * vals.shape[1], where, check=check)

    def segment_mul_row(tag, kw):
        """The [a*b, 1] mode at the inputs the engine handed it. Its bound
        counts every key and mask byte (the kernel reads both for every
        row), a and b of the live rows in their sectors, and the output;
        no single PyTorch call computes it (a product, a mask and a
        scatter), so it has no library time."""
        keys, a, b, valid = kw["keys"], kw["a"], kw["b"], kw["valid"]
        nseg = kw["num_segments"]
        live_mask = valid & (keys >= 0) & (keys < nseg)
        live = live_mask.nonzero().squeeze(1)
        where = (f"({tag}) [a*b, 1] mode N={keys.numel()} "
                 f"live={live.numel()} S={nseg}")
        check = None
        if not integer_valued(a, b):
            prod = a.double() if b is None else a.double() * b.double()
            check = sum_bound_check(
                "segment_reduce", where, torch.where(live_mask, keys, nseg),
                torch.stack([torch.where(live_mask, prod, 0.0),
                             live_mask.double()], 1), nseg, b is not None)
            del prod
            equal_on_integers(
                "segment_reduce", where, lambda a2, b2=None: (
                    segment_reduce_mul(keys, a2, b2, valid,
                                       num_segments=nseg),
                    segment_reduce_mul_plain(keys, a2, b2, valid,
                                             num_segments=nseg)),
                [a] if b is None else [a, b])
        return report(
            "segment_reduce", reduce_launches("segment_reduce"),
            lambda: segment_reduce_mul(keys, a, b, valid, num_segments=nseg),
            lambda: segment_reduce_mul_plain(keys, a, b, valid,
                                             num_segments=nseg), None,
            keys.numel() * 9 + sector_bytes(live, 4)
            * (1 if b is None else 2) + nseg * 2 * 4,
            live.numel() * (3 if b is not None else 2), where, check=check)

    # (s) and (t)(2) recorded the largest call of each kernel (float data:
    # held against float64 within the float32 summation bound, and on the
    # same ids with integer values, exactly)
    rows = []
    for tag in ("c", "d", "d2", "e", "s", "t"):
        for kw in seen.get(tag, {}).get("scatter_workspace", [])[-1:]:
            kw = on_card(kw)
            rows.append(workspace_row(tag, kw["ids"], kw["cols"],
                                      kw["num_slots"], kw["mul_pair"]))
            del kw
    kernels.append(max(rows, key=lambda r: r["bytes"]))

    # segment_reduce on the main path: the general entry's D = 1 calls
    # ((c)'s and (e)'s collapses, the sort-merge's inner sum in (k)) and
    # the [a*b, 1] mode over a key space ((d), (m), each lane of (o)'s
    # tiles); the kernels line carries the largest of those
    rows = []
    for tag in ("c", "e", "k", "s", "t"):
        for kw in seen.get(tag, {}).get("segment_reduce", [])[-1:]:
            kw = on_card(kw)
            rows.append(segment_row(tag, kw["vals"], kw["seg_ids"],
                                    kw["num_segments"]))
    for tag in ("d", "m", "o", "s", "t"):
        for kw in seen.get(tag, {}).get("segment_reduce_mul", [])[-1:]:
            rows.append(segment_mul_row(tag, on_card(kw)))
    kernels.append(max(rows, key=lambda r: r["bytes"]))
    # the model blocks' reduce inputs are done with; the float64 checks at
    # 2^29 rows leave the allocator holding memory a library call (Triton
    # allocates outside it) then cannot get
    for tag in ("s", "t"):
        for name in ("scatter_workspace", "segment_reduce",
                     "segment_reduce_mul"):
            seen.get(tag, {}).pop(name, None)
    torch.cuda.empty_cache()

    # the general entry at the two shapes PR 17 timed it at, rebuilt with
    # the key structure its recorded inputs had: a [value, 1] stream whose
    # live rows are a prefix in (i, k, j) order, the rest the dropped id S.
    # (o): the first tile's 137M products (j-contiguous keys under each
    # (i, k)) at a capacity of 2^28 into 2^23 segments; (d): 1.7M products
    # at a capacity of 4,194,304 into 2^24
    def product_stream(b_coo, c_csr, width, cap, nseg):
        """The [b * c, 1] rows of the products B[i, k] * C[k, j] over C's
        row k in (i, k, j) order, keys i * width + j, padded to ``cap``
        rows of the dropped id ``nseg``. ``b_coo``: B's (i, k, value) in
        row-major order; ``c_csr``: C's (indptr, indices, data)."""
        ii, kk, bv = b_coo
        indptr, indices, data = c_csr
        cnt = indptr[kk + 1] - indptr[kk]
        pos = (torch.repeat_interleave(indptr[kk] - torch.cumsum(cnt, 0)
                                       + cnt, cnt)
               + torch.arange(int(cnt.sum()), device="cuda"))
        n_live = pos.numel()
        sids = torch.full((cap,), nseg, dtype=torch.int32, device="cuda")
        sids[:n_live] = (torch.repeat_interleave(ii, cnt) * width
                         + indices[pos]).int()
        vals = torch.zeros((cap, 2), device="cuda")
        vals[:n_live, 0] = torch.repeat_interleave(bv, cnt) * data[pos]
        vals[:n_live, 1] = 1.0
        return vals, sids

    pr17_shapes = (("o", o_tile["b"], o_tile["c"], nj, 1 << 28, 1 << 23),
                   ("d", d_csr["b"], d_csr["c"], 4096, 1 << 22, 1 << 24))
    for tag, b_coo, c_csr, width, cap, nseg in pr17_shapes:
        vals, sids = product_stream(b_coo, c_csr, width, cap, nseg)
        row = segment_row(f"{tag}, PR 17's shape", vals, sids, nseg)
        # a [value, 1] reduce over the key space: the workspace kernel
        # computes the same function on the same inputs
        if not torch.equal(scatter_workspace(sids, vals, num_slots=nseg),
                           segment_reduce(vals, sids, num_segments=nseg)):
            raise AssertionError(f"({tag}) scatter_workspace differs from "
                                 "segment_reduce")
        row["workspace_route_ms"] = event_ms(
            lambda: scatter_workspace(sids, vals, num_slots=nseg))
        log(f"[f] segment_reduce at ({tag}, PR 17's shape): "
            f"scatter_workspace on the same inputs, equal, ms "
            f"{row['workspace_route_ms']:.4f}")
        del vals, sids

    # fused_imr: its own phase through the intersect_mul_reduce entry
    na, nb, slots = 4 << 20, 1 << 20, 1 << 20
    g = torch.Generator(device="cuda").manual_seed(SEED)
    space = 16 << 20
    a_key = torch.unique(torch.randint(0, space, (int(na * 1.1),),
                                       device="cuda", generator=g))[:na]
    b_key = torch.unique(torch.randint(0, space, (int(nb * 1.1),),
                                       device="cuda", generator=g))[:nb]
    a_key = a_key.long()
    b_key = b_key.long()
    na, nb = a_key.numel(), b_key.numel()
    a_valid = torch.ones(na, dtype=torch.bool, device="cuda")
    b_valid = torch.arange(nb, device="cuda") < nb - 4096    # prefix-valid
    b_key = torch.where(b_valid, b_key, co.PAD_KEY)
    a_vals = torch.randint(1, 9, (na,), device="cuda", generator=g).float()
    b_vals = torch.randint(1, 9, (nb,), device="cuda", generator=g).float()
    out_key = torch.randint(0, slots, (na,), device="cuda", generator=g)
    imr = kops.sam_primitive("intersect_mul_reduce", "cuda")
    fused_imr_workspace.launches = 0
    uk, uv, uvalid, count = imr(a_key, a_valid, a_vals, b_key, b_valid,
                                b_vals, out_key, slots, key_bound=slots)
    imr_launches = fused_imr_workspace.launches
    if imr_launches < 1:
        raise AssertionError("intersect_mul_reduce never launched fused_imr")
    fk, fv, fvalid, fcount = co.fused_intersect_mul_reduce(
        a_key, a_valid, a_vals, b_key, b_valid, b_vals, out_key, slots,
        key_bound=slots)
    if (int(count) != int(fcount) or not torch.equal(uk, fk)
            or not torch.equal(uv, fv) or not torch.equal(uvalid, fvalid)):
        raise AssertionError("intersect_mul_reduce entry differs from the "
                             "coord_ops composition")
    hits = int((uvalid & (uv != 0)).sum())
    log(f"[f] intersect_mul_reduce entry equals coord_ops on NA={na} "
        f"NB={nb} slots={slots}: {int(count)} slots appeared, {hits} live")
    bk_in = torch.where(b_valid, b_key, co.PAD_KEY)
    bv_in = torch.where(b_valid, b_vals, 0.0)
    idx = torch.searchsorted(bk_in, a_key).clamp(max=nb - 1)
    hit = bk_in[idx] == a_key
    # the bytes the function needs: every key of a and of b once, the
    # workspace once, and a's value and output key and b's value only at
    # the hits, counted in the 32-byte sectors that hold them
    hit_a = hit.nonzero().squeeze(1)
    n_hit = hit_a.numel()

    n_hit_bytes = (sector_bytes(hit_a, 4) + sector_bytes(hit_a, 8)
                   + sector_bytes(idx[hit_a], 4))
    log(f"[f] fused_imr: {n_hit} of {na} elements of a hit; the hits' "
        f"gathers touch {n_hit_bytes} bytes")
    lib_ids = torch.where(hit, out_key, slots)
    lib_cols = torch.stack([a_vals * bv_in[idx], hit.float()], 1)
    kernels.append(report("fused_imr", imr_launches,
           lambda: fused_imr_workspace(a_key, a_vals, out_key, bk_in, bv_in,
                                       num_slots=slots),
           lambda: fused_imr_workspace_plain(a_key, a_vals, out_key, bk_in,
                                             bv_in, num_slots=slots),
           lambda: torch.zeros((slots + 1, 2), device="cuda"
                               ).index_add_(0, lib_ids, lib_cols),
           na * 8 + nb * 8 + slots * 2 * 4 + n_hit_bytes,
           n_hit * 3,
           f"NA={na} NB={nb} slots={slots}"))

    # the block-sparse kernels, at the inputs (g)-(j) gave them
    kw = seen["g"]["spmm_bsr"][-1]
    bm, ci, bp, cc = kw["blk_map"], kw["col_idx"], kw["blocks"], kw["c"]
    n_brow, bsz, nnzb = bm.shape[0], bp.shape[1], bp.shape[0] - 1
    live = bm < nnzb
    crow = torch.zeros(n_brow + 1, dtype=torch.int64, device="cuda")
    crow[1:] = live.sum(1).cumsum(0)
    bsr_w = torch.sparse_bsr_tensor(crow, ci[live].long(),
                                    bp[bm[live].long()],
                                    size=(n_brow * bsz, cc.shape[0]))
    n_live = int(live.sum())
    kernels.append(report(
        "spmm_bsr", per_phase["g"]["spmm_bsr"],
        lambda: spmm_bsr(bm, ci, bp, cc),
        lambda: spmm_bsr_plain(bm, ci, bp, cc),
        lambda: torch.sparse.mm(bsr_w, cc),
        2 * bm.numel() * 4 + bp.numel() * 4 + cc.numel() * 4
        + n_brow * bsz * cc.shape[1] * 4,
        2 * n_live * bsz * bsz * cc.shape[1],
        f"(g) n_brow={n_brow} max_nnz={bm.shape[1]} nnzb={nnzb} bs={bsz} "
        f"K={cc.shape[0]} N={cc.shape[1]}",
        rate=H100_3XTF32_FLOPS))
    del bsr_w
    bm32, ci32 = (x.to(torch.int32).contiguous() for x in (bm, ci))
    out_cc = torch.empty((n_brow * bsz, cc.shape[1]), device="cuda")
    turns = paired_ms(
        lambda: spmm_bsr(bm, ci, bp, cc),
        lambda: _build.call("sam_spmm_bsr_f32", cc.device, bm32.data_ptr(),
                            ci32.data_ptr(), bp.data_ptr(), cc.data_ptr(),
                            out_cc.data_ptr(), n_brow, bm.shape[1], nnzb,
                            bsz, cc.shape[0], cc.shape[1]))
    log("[f] spmm_bsr at (g), tensor cores against the CUDA-core kernel "
        "in turns (new, old, old, new): " + ", ".join(
            f"{t:.4f}" for t in turns) + " ms")
    held("spmm_bsr", out_cc, spmm_bsr_plain(bm, ci, bp, cc),
         "(g), the CUDA-core kernel")
    del out_cc

    # (g)'s shape on standard-normal float32: every element against the
    # float64 product, within (3 * 2^-22 + K * 2^-24) * sum_k |a_k c_k|,
    # K the row's live slots times bs (the bound sddmm_bsr is held to)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bn = torch.randn(bp.shape, device="cuda", generator=g)
    bn[-1] = 0
    cn = torch.randn(cc.shape, device="cuda", generator=g)
    got_n = spmm_bsr(bm, ci, bn, cn)
    n_bcol = -(-cc.shape[0] // bsz)
    w64 = torch.zeros((n_brow, n_bcol, bsz, bsz), dtype=torch.float64,
                      device="cuda")
    w64[torch.arange(n_brow, device="cuda").repeat_interleave(
        bm.shape[1])[live.reshape(-1)], ci[live].long()] = bn[
            bm[live].long()].double()
    w64 = w64.permute(0, 2, 1, 3).reshape(n_brow * bsz, n_bcol * bsz)[
        :, :cc.shape[0]]
    err_n = (got_n.double() - w64 @ cn.double()).abs()
    k_row = (live.sum(1).double() * bsz).repeat_interleave(bsz)[:, None]
    limit = (3 * 2.0 ** -22 + k_row * 2.0 ** -24) * (w64.abs()
                                                     @ cn.double().abs())
    worst = float((err_n / limit.clamp_min(1e-300)).max())
    plain_err = float((got_n - spmm_bsr_plain(bm, ci, bn, cn)).abs().max())
    if not torch.isfinite(got_n).all() or bool((err_n > limit).any()):
        raise AssertionError(f"spmm_bsr on normal data: error reaches "
                             f"{worst} of its 3xTF32 bound")
    log(f"[f] spmm_bsr at (g) on standard-normal float32: largest error "
        f"{float(err_n.max()):.3e} against float64, {worst:.4f} of the "
        f"per-element 3xTF32 bound; max abs diff from the plain version "
        f"{plain_err:.3e}")
    del bn, cn, got_n, w64, err_n, k_row, limit

    kw = seen["h"]["sddmm_bsr"][-1]
    sr, sc, sa, sb, sbs = kw["rows"], kw["cols"], kw["a"], kw["b"], kw["bs"]
    a3 = sa.view(-1, sbs, sa.shape[1])
    b3 = sb.view(-1, sbs, sb.shape[1])
    nnzb = sr.numel()
    kernels.append(report(
        "sddmm_bsr", per_phase["h"]["sddmm_bsr"],
        lambda: sddmm_bsr(sr, sc, sa, sb, sbs),
        lambda: sddmm_bsr_plain(sr, sc, sa, sb, sbs),
        lambda: torch.bmm(a3[sr], b3[sc].transpose(1, 2)),
        2 * nnzb * 4 + (sa.numel() + sb.numel() + nnzb * sbs * sbs) * 4,
        2 * nnzb * sbs * sbs * sa.shape[1],
        f"(h) nnzb={nnzb} bs={sbs} K={sa.shape[1]}",
        rate=H100_3XTF32_FLOPS))

    out_cc = torch.empty((nnzb, sbs, sbs), device="cuda")
    turns = paired_ms(
        lambda: sddmm_bsr(sr, sc, sa, sb, sbs),
        lambda: _build.call("sam_sddmm_bsr_f32", sa.device, sr.data_ptr(),
                            sc.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                            out_cc.data_ptr(), nnzb, sbs, sa.shape[1],
                            sa.shape[0], sb.shape[0]))
    log("[f] sddmm_bsr at (h), tensor cores against the CUDA-core kernel "
        "in turns (new, old, old, new): " + ", ".join(
            f"{t:.4f}" for t in turns) + " ms")
    del out_cc

    # (h)'s shape on standard-normal float32: every element against the
    # float64 product, within the worst case of 3xTF32 (the dropped lo*lo
    # term and two residual roundings, 3 * 2^-22 a product) plus float32
    # summation (K * 2^-24), times sum_k |a_k b_k|; one TF32 pass would
    # fail it many times over
    g = torch.Generator(device="cuda").manual_seed(SEED)
    an, bn = (torch.randn(x.shape, device="cuda", generator=g)
              for x in (sa, sb))
    got_n = sddmm_bsr(sr, sc, an, bn, sbs)
    a64 = an.double().view(-1, sbs, an.shape[1])[sr.long()]
    b64 = bn.double().view(-1, sbs, bn.shape[1])[sc.long()].transpose(1, 2)
    err_n = (got_n.double() - torch.bmm(a64, b64)).abs()
    limit = ((3 * 2.0 ** -22 + an.shape[1] * 2.0 ** -24)
             * torch.bmm(a64.abs(), b64.abs()))
    worst = float((err_n / limit).max())
    plain_err = float((got_n - sddmm_bsr_plain(sr, sc, an, bn, sbs)).abs()
                      .max())
    if not torch.isfinite(got_n).all() or worst > 1.0:
        raise AssertionError(f"sddmm_bsr on normal data: error reaches "
                             f"{worst} of its 3xTF32 bound")
    log(f"[f] sddmm_bsr at (h) on standard-normal float32: largest error "
        f"{float(err_n.max()):.3e} against float64, {worst:.4f} of the "
        f"per-element 3xTF32 bound; max abs diff from the plain version "
        f"{plain_err:.3e}")
    del an, bn, got_n, a64, b64, err_n, limit

    def attention_mask(kv, n_q, n_kv, causal):
        """Dense boolean (S_q, S_kv) mask of a kv_idx (for the library)."""
        blk = torch.zeros((n_q, n_kv + 1), dtype=torch.bool, device="cuda")
        blk.scatter_(1, kv.long().clamp(0, n_kv), True)
        full = blk[:, :n_kv].repeat_interleave(bs, 0).repeat_interleave(
            bs, 1)
        return full.tril() if causal else full

    attn_launches = (per_phase["i"]["bsr_attention"]
                     + per_phase["j"]["bsr_attention"])
    for causal in (False, True):
        pairs = heads * attention_pairs(kv_win, bs, bs, n_win, causal)
        dense_mask = attention_mask(kv_all, n_win, n_win, causal)
        row = report(
            "bsr_attention", attn_launches,
            lambda: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                        bkv=bs, causal=causal),
            lambda: bsr_flash_attention_plain(q_all, k_all, v_all, kv_all,
                                              bq=bs, bkv=bs, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_all[None], k_all[None], v_all[None], attn_mask=dense_mask),
            4 * q_all.numel() * 4 + kv_all.numel() * 4, 4 * hd * pairs,
            f"(j) BH={heads} S={s_len} D={hd} causal={causal}",
            tol=KERNEL_TOL["float32"], rate=H100_3XTF32_FLOPS)
        del dense_mask
        if not causal:
            kernels.append(row)
        out_cc = torch.empty_like(q_all)
        turns = paired_ms(
            lambda: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                        bkv=bs, causal=causal),
            lambda: _build.call(
                "sam_bsr_attention_f32", q_all.device, kv_all.data_ptr(),
                q_all.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                out_cc.data_ptr(), heads, s_len, s_len, hd, n_win, win, bs,
                bs, hd ** -0.5, int(causal)))
        log(f"[f] bsr_attention at (j) causal={causal}, tensor cores against "
            f"the CUDA-core kernel in turns (new, old, old, new): "
            + ", ".join(f"{t:.4f}" for t in turns) + " ms")
        del out_cc

    # the path's own head (i): a fully masked q block, and bfloat16
    kw = seen["i"]["bsr_attention"][-1]
    qi_, ki_, vi_, idx_i = kw["q"], kw["k"], kw["v"], kw["kv_idx"]
    idx_m = idx_i.clone()
    idx_m[0] = ki_.shape[1] // bs                     # every slot masked
    out_m = bsr_flash_attention(qi_, ki_, vi_, idx_m, bq=bs, bkv=bs)
    torch.cuda.synchronize()
    if out_m[:, :bs].count_nonzero():
        raise AssertionError("bsr_attention: a fully masked q block is not "
                             "zeros")
    err_m = held("bsr_attention", out_m,
                 bsr_flash_attention_plain(qi_, ki_, vi_, idx_m, bq=bs,
                                           bkv=bs),
                 "(i) with q block 0 masked", KERNEL_TOL["float32"])
    q16, k16, v16 = (x.bfloat16() for x in (qi_, ki_, vi_))
    err_16 = held("bsr_attention",
                  bsr_flash_attention(q16, k16, v16, idx_i, bq=bs, bkv=bs),
                  bsr_flash_attention_plain(q16, k16, v16, idx_i, bq=bs,
                                            bkv=bs),
                  "(i) in bfloat16", KERNEL_TOL["bfloat16"])
    log(f"[f] bsr_attention at (i): q block 0 fully masked gives zeros "
        f"(max abs err {err_m} elsewhere); bfloat16 max abs err {err_16}")

    def one_head():
        return bsr_flash_attention(qi_, ki_, vi_, idx_i, bq=bs, bkv=bs)

    dev_i, kern_i = profiled_device_ms(one_head, "bsr_attention")
    ops_i = 4 * hd * attention_pairs(kv_win, bs, bs, n_win, False)
    bound_i = kernel_roofline(ops_i, 0, peak_flops=H100_3XTF32_FLOPS)
    fp32_i = kernel_roofline(ops_i, 0, peak_flops=H100_FP32_FLOPS)
    log(f"[f] bsr_attention at (i) BH=1 S={qi_.shape[1]} D={qi_.shape[2]}: "
        f"ms {event_ms(one_head):.4f}, device " + (
            "not measured" if dev_i is None else
            f"{dev_i:.4f}, of it the kernel {kern_i:.4f}")
        + f", bound_ms {bound_i['t_compute'] * 1e3:.4f} "
        f"(fp32_bound_ms {fp32_i['t_compute'] * 1e3:.4f})")

    # (j) in bfloat16: the card's rate for a bf16 model's attention
    qb_all, kb_all, vb_all = (x.bfloat16() for x in (q_all, k_all, v_all))
    err_b = held("bsr_attention",
                 bsr_flash_attention(qb_all, kb_all, vb_all, kv_all, bq=bs,
                                     bkv=bs),
                 bsr_flash_attention_plain(qb_all, kb_all, vb_all, kv_all,
                                           bq=bs, bkv=bs),
                 "(j) in bfloat16", KERNEL_TOL["bfloat16"])
    ops_j = 4 * hd * heads * attention_pairs(kv_win, bs, bs, n_win, False)
    roof_b = kernel_roofline(ops_j, 4 * qb_all.numel() * 2,
                             peak_flops=H100_BF16_FLOPS)
    bound_b = max(roof_b["t_compute"], roof_b["t_memory"]) * 1e3
    ms_b = event_ms(lambda: bsr_flash_attention(qb_all, kb_all, vb_all,
                                                kv_all, bq=bs, bkv=bs))
    log(f"[f] bsr_attention at (j) in bfloat16, causal=False: ms "
        f"{ms_b:.4f}, bound_ms {bound_b:.4f} (bf16 rate), max abs err "
        f"{err_b} against the plain version")
    del qb_all, kb_all, vb_all
    for name, fn, args in (
            ("spmm_bsr", spmm_bsr, (bm, ci, bp.bfloat16(), cc.bfloat16())),
            ("sddmm_bsr", sddmm_bsr, (sr, sc, sa.bfloat16(), sb.bfloat16(),
                                      sbs))):
        plain = spmm_bsr_plain if name == "spmm_bsr" else sddmm_bsr_plain
        err = held(name, fn(*args), plain(*args), "bfloat16")
        log(f"[f] {name} in bfloat16 at the same shape: max abs err {err}")
    bf_args = (bm, ci, bp.bfloat16(), cc.bfloat16())
    ops_g = 2 * n_live * bsz * bsz * cc.shape[1]
    roof_g = kernel_roofline(
        ops_g, (bp.numel() + cc.numel() + n_brow * bsz * cc.shape[1]) * 2,
        peak_flops=H100_BF16_FLOPS)
    bound_g = max(roof_g["t_compute"], roof_g["t_memory"]) * 1e3
    log(f"[f] spmm_bsr at (g) in bfloat16: ms "
        f"{event_ms(lambda: spmm_bsr(*bf_args)):.4f}, bound_ms "
        f"{bound_g:.4f} (bf16 rate)")
    del bf_args

    # coo_to_levels at (k)'s intermediate (the row of the kernels line) and
    # at (l); no single PyTorch call computes it, so it has no library time
    def coo_flat(out):
        return torch.cat([t.reshape(-1).long() for part in out for t in part])

    def coo_bytes(n, caps):
        """keys (8 B) and valid (1 B) read once for the whole call; each
        level's crd, seg and count written once."""
        total, parent = n * 9, 1
        for cap in caps:
            total += cap * 4 + (parent + 1) * 4 + 8
            parent = cap
        return total

    coo_cases = [("k", seen["k"]["coo_to_levels"][-1]),
                 ("l", {"keys": keys_l, "valid": valid_l,
                        "dims_list": dims_l, "caps": caps_l}),
                 ("l2", {"keys": keys_l2, "valid": valid_l2,
                         "dims_list": dims_l2, "caps": caps_l2})]
    # the largest call of (s)'s and (t)(2)'s fused cascades, where they
    # launched it
    coo_cases += [(tag, on_card(kw)) for tag in ("s", "t")
                  for kw in seen.get(tag, {}).get("coo_to_levels", [])]
    for tag, kw in coo_cases:
        ck, cv, cd, cc = kw["keys"], kw["valid"], kw["dims_list"], kw["caps"]
        row = report(
            "coo_to_levels", per_phase[{"t": "t2"}.get(tag, tag)][
                "coo_to_levels"],
            lambda: coo_to_levels(ck, cv, cd, cc),
            lambda: coo_to_levels_plain(ck, cv, cd, cc), None,
            coo_bytes(ck.numel(), cc), 0,
            f"({tag}) N={ck.numel()} dims={list(cd)} caps={list(cc)}",
            flat=coo_flat, per_call=4)       # launches a call, N > 0
        if tag == "k":
            kernels.append(row)
    del keys_l, valid_l, keys_l2, valid_l2, coo_cases, kw

    # -- (s) and (t): their profiles, after (f) -----------------------------
    seen.clear()                     # (f)'s copies of the kernels' inputs
    torch.cuda.empty_cache()
    s_prof = device_profile(lambda: model(s_x))
    s_host = host_profile(lambda: model(s_x))
    workloads["pruned transformer (s)"].update(profile=s_prof,
                                               host_profile=s_host)
    log("[s] host (cProfile cumulative ms) " + ", ".join(
        f"{r['name']} {r['cum_ms']:.1f}" for r in s_host))
    log(f"[s] profiled call {s_prof['wall_ms']:.1f} ms with "
        f"{s_prof['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if s_prof["idle_share"] is None
                     else f"{s_prof['idle_share']:.4f}"))
    for row in s_prof["top_kernels"][:4]:
        log(f"[s]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    model.close()
    del model

    t1_prof = device_profile(lambda: moe_mod.apply_moe(
        moe_p, t_x, k=top_k, dispatch="sam", capacity_factor=1.25,
        compute_dtype=torch.float32))
    workloads["MoE prefill (t)"]["profile"] = t1_prof
    log(f"[t] apply_moe float32 sam cf 1.25, profiled call "
        f"{t1_prof['wall_ms']:.3f} ms with {t1_prof['device_busy_ms']:.3f} "
        f"ms of kernels on the card, idle share "
        + ("not measured" if t1_prof["idle_share"] is None
           else f"{t1_prof['idle_share']:.4f}"))
    for row in t1_prof["top_kernels"][:4]:
        log(f"[t]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    del t_x, moe_p
    clear_program_cache()

    # -- (u) the language-model serving path ---------------------------------
    # before (q), after (s)'s and (t)'s profiles: a profiler session that
    # spans (q)'s server threads leaves later sessions short of device events
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import model as lm
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step)

    torch.cuda.empty_cache()
    u_start = time.perf_counter()
    kops.reset_launch_counts()          # the LM path launches none of them

    def rel_err(got, want):
        """max |got - want| over max |want|, both finite."""
        got, want = got.double().cpu(), want.double().cpu()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"(u) shape {tuple(got.shape)} against "
                                 f"{tuple(want.shape)}, or not finite")
        return float((got - want).abs().max() / want.abs().max())

    def held_lm(label, got, want):
        err = rel_err(got, want)
        if err > U_TOL:
            raise AssertionError(f"(u) {label}: rel err {err} > {U_TOL}")
        return err

    def finite(label, t):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"(u) {label}: a logit is not finite")

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def cached_equals_forward(label, cfg32, params, seq, n_pre):
        """float32 compute and caches: a cached prefill of ``n_pre`` tokens
        of ``seq`` and one decode step a further token, each step's logits
        against ``forward`` over the whole of ``seq``; returns the
        largest rel err."""
        full, _ = lm.forward(cfg32, params, {"tokens": seq})
        caches = lm.init_caches(cfg32, seq.shape[0], seq.shape[1] + 8,
                                dtype=torch.float32)
        pre, caches = lm.forward(cfg32, params, {"tokens": seq[:, :n_pre]},
                                 caches)
        errs = [held_lm(f"{label} prefill", pre, full[:, :n_pre])]
        for i in range(n_pre, seq.shape[1]):
            got, caches = lm.decode_step(cfg32, params, caches,
                                         {"tokens": seq[:, i:i + 1]})
            errs.append(held_lm(f"{label} decode at {i}", got, full[:, i]))
        return max(errs)

    def card_equals_cpu(label, cfg32, params, batch):
        """The card's float32 forward against the CPU's on the same
        parameters (copied to the host); returns the rel err."""
        got, _ = lm.forward(cfg32, params, batch)
        on_host = lm.tree_map(lambda t: t.cpu(), params)
        want, _ = lm.forward(cfg32, on_host,
                             {k: v.cpu() for k, v in batch.items()})
        return held_lm(f"{label} card against the CPU", got, want)

    # (u)(1) qwen3-0.6b at its full configuration: generate with the
    # reference CLI's defaults, step by step, then serve --arch
    u_cfg = get_config("qwen3-0.6b")
    u_b, u_p, u_g = 4, 32, 16
    u_max = u_p + u_g + 8
    u_params, init_ms = synced_ms(lambda: lm.init_params(
        u_cfg, torch.Generator(device="cuda").manual_seed(SEED)))
    u_prompts = torch.randint(
        0, u_cfg.vocab, (u_b, u_p), dtype=torch.int32, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    seqs, gen_first_ms = synced_ms(lambda: lm_serve.generate(
        u_cfg, u_params, u_prompts, u_g, u_max))
    torch.cuda.synchronize()
    u_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seqs2, gen_warm_ms = synced_ms(lambda: lm_serve.generate(
        u_cfg, u_params, u_prompts, u_g, u_max))
    u_peak = torch.cuda.max_memory_allocated() - u_base
    if (seqs.shape != (u_b, u_p + u_g)
            or not torch.equal(seqs[:, :u_p], u_prompts)
            or int(seqs.min()) < 0 or int(seqs.max()) >= u_cfg.vocab):
        raise AssertionError(f"(u) generate gave {tuple(seqs.shape)} "
                             f"tokens in [{int(seqs.min())}, "
                             f"{int(seqs.max())}]")
    # the steps generate takes, timed one by one on the same inputs
    prefill, step = make_prefill_step(u_cfg), make_serve_step(u_cfg)
    caches = lm.init_caches(u_cfg, u_b, u_max)
    (logits, caches), prefill_ms = synced_ms(
        lambda: prefill(u_params, caches, {"tokens": u_prompts}))
    finite("prefill", logits)
    decode_ms = []
    for i in range(u_g):
        tok = torch.argmax(logits, dim=-1)[:, None].int()
        (logits, caches), ms = synced_ms(
            lambda: step(u_params, caches, {"tokens": tok}))
        finite(f"decode step {i}", logits)
        decode_ms.append(ms)
    tok = torch.argmax(logits, dim=-1)[:, None].int()
    u_prof = device_profile(lambda: step(u_params, caches, {"tokens": tok}))
    u_host = host_profile(lambda: step(u_params, caches, {"tokens": tok}),
                          top=8)
    dec_med = statistics.median(decode_ms)
    u_flops = model_flops(u_cfg.n_active_params(), u_b, "decode")
    u_rate = u_flops / (dec_med / 1e3)
    tok_s = u_b * u_g / (gen_warm_ms / 1e3)
    del caches, logits
    log(f"[u] qwen3-0.6b full ({u_cfg.n_layers} layers, d_model "
        f"{u_cfg.d_model}, vocab {u_cfg.vocab}, {u_cfg.n_params()} params "
        f"in float32, bfloat16 compute): init {init_ms:.1f} ms; generate "
        f"batch {u_b} prompt {u_p} gen {u_g} greedy: first {gen_first_ms:.1f}"
        f" ms, warm {gen_warm_ms:.1f} ms ({tok_s:.1f} tokens/s), the same "
        f"tokens warm: {bool(torch.equal(seqs, seqs2))}; peak allocated "
        f"{u_peak} bytes above the {u_base} live")
    log(f"[u] prefill {prefill_ms:.3f} ms; decode ms a token: median "
        f"{dec_med:.3f} (min {min(decode_ms):.3f}, max "
        f"{max(decode_ms):.3f} over {u_g} steps); model FLOP rate "
        f"{u_rate / 1e12:.4f} TFLOP/s ({u_flops:.4g} FLOP a step, "
        f"2 x {u_cfg.n_active_params()} x {u_b}), "
        f"{u_rate / H100_BF16_FLOPS:.6f} of 989 TFLOP/s")
    log(f"[u] one profiled decode step: {u_prof['wall_ms']:.3f} ms with "
        f"{u_prof['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if u_prof["idle_share"] is None
                     else f"{u_prof['idle_share']:.4f}"))
    for row in u_prof["top_kernels"][:4]:
        log(f"[u]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    log("[u] one decode step's host (cProfile cumulative ms) " + ", ".join(
        f"{r['name']} {r['cum_ms']:.1f}" for r in u_host))
    cli_seqs, cli_ms = synced_ms(lambda: lm_serve.main(
        ["--arch", "qwen3-0.6b", "--batch", "4", "--prompt-len", "32",
         "--gen", "16"]))
    if cli_seqs.shape != (4, 48):
        raise AssertionError(f"(u) serve --arch gave {cli_seqs.shape}")
    u32 = dataclasses.replace(u_cfg, compute_dtype="float32")
    err_dec = cached_equals_forward("qwen3-0.6b", u32, u_params, seqs, u_p)
    two = dict(u_params, layers=lm.tree_map(lambda a: a[:2],
                                            u_params["layers"]))
    err_cpu = card_equals_cpu("qwen3-0.6b, 2 layers",
                              dataclasses.replace(u32, n_layers=2), two,
                              {"tokens": seqs[:, :u_p]})
    log(f"[u] serve --arch qwen3-0.6b --batch 4 --prompt-len 32 --gen 16: "
        f"{cli_ms:.1f} ms, init included; float32 compute: prefill of "
        f"{u_p} + {u_g} decode steps against forward over {u_p + u_g} "
        f"tokens rel err {err_dec:.3e}, the card's forward at 2 of 28 "
        f"layers against the CPU's {err_cpu:.3e} (tolerance {U_TOL})")
    workloads["LM serving qwen3-0.6b (u)"] = {
        "warm_ms": gen_warm_ms, "first_ms": gen_first_ms,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "decode_median_ms": dec_med, "tokens_per_s": tok_s,
        "peak_bytes": u_peak, "profile": u_prof, "host_profile": u_host,
        "model_flops_per_s": u_rate,
        "bf16_peak_share": u_rate / H100_BF16_FLOPS,
        "rel_err_cached": err_dec, "rel_err_cpu": err_cpu,
        "cli_ms": cli_ms}
    del u_params, two, seqs, seqs2, cli_seqs
    torch.cuda.empty_cache()

    # (u)(2) one architecture of each other family at full width, depth cut
    for arch, n_layers, extra, equal_decode in U_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  **extra)
        params = lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED))
        rng = np.random.default_rng(SEED)
        seq = torch.tensor(rng.integers(0, cfg.vocab, (u_b, u_p + 2)),
                           dtype=torch.int32, device="cuda")
        fixed, prefix = {}, 0
        if cfg.frontend == "siglip_stub":
            fixed["patches"] = torch.tensor(
                rng.normal(size=(u_b, cfg.n_patches, cfg.patch_dim)),
                dtype=torch.float32, device="cuda")
            prefix = cfg.n_patches
        if cfg.frontend == "encodec_stub":
            feed = torch.tensor(rng.normal(size=(u_b, u_p + 2, cfg.d_model)),
                                dtype=torch.float32, device="cuda")
            key = "frames"
        else:
            feed, key = seq, "tokens"
        batch = dict(fixed, **{key: feed[:, :u_p]})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (logits, _), fwd_ms = synced_ms(
            lambda: lm.forward(cfg, params, batch))
        finite(f"{arch} forward", logits)
        # two decode steps behind a cached prefill; the stubs take their
        # patches with every step, as the reference's
        caches = lm.init_caches(cfg, u_b, u_p + 8 + 3 * (prefix + 1))
        (logits, caches), pre_ms = synced_ms(
            lambda: lm.forward(cfg, params, batch, caches))
        finite(f"{arch} prefill", logits)
        step_ms = []
        for i in (u_p, u_p + 1):
            one = dict(fixed, **{key: feed[:, i:i + 1]})
            (logits, caches), ms = synced_ms(
                lambda: lm.decode_step(cfg, params, caches, one))
            finite(f"{arch} decode", logits)
            step_ms.append(ms)
        peak = torch.cuda.max_memory_allocated() - base
        del caches, logits
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        err_cpu = card_equals_cpu(
            arch, cfg32, params,
            {k: v[:1] for k, v in batch.items()})  # one row on the host
        err_dec = (cached_equals_forward(arch, cfg32, params, seq, u_p)
                   if equal_decode else None)
        log(f"[u] {arch}, {n_layers} of {get_config(arch).n_layers} layers"
            + (f" ({extra})" if extra else "") + f", {cfg.n_params()} "
            f"params: forward (4, {u_p}) {fwd_ms:.1f} ms, cached prefill "
            f"{pre_ms:.1f} ms, decode {step_ms[0]:.1f} and {step_ms[1]:.1f}"
            f" ms, peak {peak} bytes above the {base} live; float32: card "
            f"against CPU rel err {err_cpu:.3e}"
            + ("" if err_dec is None else
               f", prefill + 2 decode steps against forward {err_dec:.3e}")
            + f" (tolerance {U_TOL})")
        workloads[f"LM {arch} (u)"] = {
            "first_ms": fwd_ms, "prefill_ms": pre_ms, "decode_ms": step_ms,
            "peak_bytes": peak, "rel_err_cpu": err_cpu,
            "rel_err_cached": err_dec}
        del params, batch, feed, seq, fixed
        torch.cuda.empty_cache()
    per_phase["u"] = kops.launch_counts()
    log(f"[u] launches {per_phase['u']} (no hand-written kernel lies on "
        f"the LM path); phase {time.perf_counter() - u_start:.1f} s")

    # -- (v) the language-model training path -------------------------------
    # after (u), before (q); no hand-written kernel lies on it, so the
    # counts zeroed here must stay 0
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.distributed.fault_tolerance import TrainingRunner
    from repro_torch.launch import train as lm_train
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_train_step,
                                              remat_loss_fn, value_and_grad)

    torch.cuda.empty_cache()
    v_start = time.perf_counter()
    kops.reset_launch_counts()

    # (v)(1) qwen3-0.6b whole through launch.train.build, TrainingRunner
    # and a Checkpointer: 6 steps uninterrupted, then a run that fails at
    # step 4 after its step-3 checkpoint and one that resumes
    v_b, v_s, v_steps = 8, 256, 6
    v_tokens = v_b * v_s
    v_cfg, _, v_state, v_step, v_data = lm_train.build(
        "qwen3-0.6b", reduced=False, batch=v_b, seq=v_s, remat="dots",
        steps=v_steps)
    v_ms = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = v_step(state, batch)
        torch.cuda.synchronize()
        v_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.synchronize()
    v_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        golden_state, golden = TrainingRunner(
            timed_step, v_data, Checkpointer(os.path.join(tmp, "a")),
            ckpt_every=v_steps + 1).run(v_state, v_steps)
        v_peak = torch.cuda.max_memory_allocated() - v_base
        del golden_state
        ck_dir = os.path.join(tmp, "b")
        ck_fail, ck_resume = Checkpointer(ck_dir), Checkpointer(ck_dir)
        try:
            TrainingRunner(v_step, v_data, ck_fail,
                           ckpt_every=3).run(v_state, v_steps, fail_at=4)
        except RuntimeError as exc:     # the injected failure, and only it
            if str(exc) != "injected failure at step 4":
                raise
        else:
            raise AssertionError("(v) the injected failure did not happen")
        t0 = time.perf_counter()
        v_final, resumed = TrainingRunner(
            v_step, v_data, ck_resume, ckpt_every=3).run(v_state, v_steps)
        resume_s = time.perf_counter() - t0
        saved = Checkpointer(ck_dir).all_steps()
    golden_loss = [h["loss"] for h in golden]
    resumed_loss = [h["loss"] for h in resumed]
    if (len(resumed) != 3 or saved != [3, 6]
            or [h["step"] for h in resumed] != [4.0, 5.0, 6.0]
            or not all(np.isfinite(golden_loss))):
        raise AssertionError(f"(v) resumed {resumed}, checkpoints {saved}, "
                             f"losses {golden_loss}")
    if resumed_loss != golden_loss[3:]:
        raise AssertionError(f"(v) resumed losses {resumed_loss} against "
                             f"the uninterrupted run's {golden_loss[3:]}")
    v_med = statistics.median(v_ms[1:])
    v_flops = model_flops(v_cfg.n_active_params(), v_tokens, "train")
    v_rate = v_flops / (v_med / 1e3)
    one_batch = v_data(0)
    v_prof = device_profile(lambda: v_step(v_final, one_batch))
    log(f"[v] qwen3-0.6b full ({v_cfg.n_layers} layers, {v_cfg.n_params()} "
        f"float32 params, bfloat16 compute, AdamW bf16 moments, remat "
        f"dots) batch {v_b} x {v_s} through launch.train.build and "
        f"TrainingRunner: step ms first {v_ms[0]:.1f}, median "
        f"{v_med:.3f} (min {min(v_ms[1:]):.3f}, max {max(v_ms[1:]):.3f} "
        f"over steps 2-{v_steps}), {v_tokens / (v_med / 1e3):.1f} tokens/s;"
        f" peak allocated {v_peak} bytes above the {v_base} live; losses "
        f"{golden_loss}")
    log(f"[v] a failure at step 4, then a runner resumed from the step-3 "
        f"checkpoint ran exactly 3 steps in {resume_s:.1f} s (restore "
        f"included) with the uninterrupted run's losses bit for bit "
        f"{resumed_loss}; checkpoints {saved}; the step-3 save: host copy "
        f"{ck_fail.seconds['copy']:.2f} s, write "
        f"{ck_fail.seconds['write']:.2f} s; the step-6 save: host copy "
        f"{ck_resume.seconds['copy']:.2f} s, write "
        f"{ck_resume.seconds['write']:.2f} s; the restore "
        f"{ck_resume.seconds['restore']:.2f} s")
    log(f"[v] model FLOP rate {v_rate / 1e12:.4f} TFLOP/s ({v_flops:.4g} "
        f"FLOP a step, 6 x {v_cfg.n_active_params()} x {v_tokens}), "
        f"{v_rate / H100_BF16_FLOPS:.4f} of 989 TFLOP/s")
    log(f"[v] one profiled step: {v_prof['wall_ms']:.3f} ms with "
        f"{v_prof['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if v_prof["idle_share"] is None
                     else f"{v_prof['idle_share']:.4f}"))
    for row in v_prof["top_kernels"][:4]:
        log(f"[v]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    del v_final

    # one step's forward and backward from the same state and batch under
    # each remat policy (without the update, whose temporaries hide the
    # activations a policy keeps): the same loss, peaks ordered
    # full <= dots <= none
    remat_peak, remat_loss, remat_ms = {}, {}, {}

    def peak_above(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, ms = synced_ms(fn)
        return out, ms, torch.cuda.max_memory_allocated() - base

    for policy in ("none", "dots", "full"):
        out, remat_ms[policy], remat_peak[policy] = peak_above(
            lambda: value_and_grad(remat_loss_fn(v_cfg, policy),
                                   v_state[0], one_batch))
        remat_loss[policy] = float(out[0])
        del out
    if (len(set(remat_loss.values())) != 1 or not
            remat_peak["full"] <= remat_peak["dots"] <= remat_peak["none"]):
        raise AssertionError(f"(v) remat losses {remat_loss}, peaks "
                             f"{remat_peak}")
    log("[v] one step's forward and backward a remat policy (peak "
        "allocated bytes above the state, ms): "
        + ", ".join(f"{k} {remat_peak[k]} ({remat_ms[k]:.1f} ms)"
                    for k in ("none", "dots", "full"))
        + f"; the same loss {remat_loss['none']}")
    workloads["LM training qwen3-0.6b (v)"] = {
        "first_ms": v_ms[0], "warm_ms": v_med, "step_ms": v_ms,
        "tokens_per_s": v_tokens / (v_med / 1e3), "peak_bytes": v_peak,
        "live_bytes": v_base, "losses": golden_loss,
        "resumed_losses": resumed_loss, "resume_s": resume_s,
        "checkpoint_s": {"step 3": ck_fail.seconds,
                         "step 6": ck_resume.seconds},
        "profile": v_prof, "model_flops_per_s": v_rate,
        "bf16_peak_share": v_rate / H100_BF16_FLOPS,
        "remat_grad_peak_bytes": remat_peak, "remat_grad_ms": remat_ms}
    del v_state, one_batch
    torch.cuda.empty_cache()

    # (v)(2) the card's train step against the CPU's: qwen3-0.6b at full
    # width, 2 of 28 layers, float32 compute, one AdamW step on (2, 32)
    c_cfg = dataclasses.replace(v_cfg, n_layers=2, compute_dtype="float32")
    c_opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    c_step = make_train_step(c_cfg, c_opt, remat="dots")
    c_params = lm.init_params(
        c_cfg, torch.Generator(device="cuda").manual_seed(SEED))
    c_batch = batch_for_step(c_cfg, ShapeConfig("v2", 32, 2, "train"), 0)
    on_host = lm.tree_map(lambda t: t.cpu(), c_params)
    host_batch = {k: v.cpu() for k, v in c_batch.items()}
    runs = {}
    for dev, p, b in (("cuda", c_params, c_batch),
                      ("cpu", on_host, host_batch)):
        (new_p, new_o, m), ms = synced_ms(lambda: c_step(
            p, init_opt_state(c_opt, p), b))
        grads = lm.tree_leaves(value_and_grad(
            remat_loss_fn(c_cfg, None), p, b)[1])
        runs[dev] = (m, grads, lm.tree_leaves(new_p), ms)
        del new_p, new_o
    (m_g, g_g, p_g, ms_g), (m_c, g_c, p_c, ms_c) = runs["cuda"], runs["cpu"]
    loss_err = abs(float(m_g["loss"]) - float(m_c["loss"])) / abs(
        float(m_c["loss"]))
    norm_err = abs(float(m_g["grad_norm"]) - float(m_c["grad_norm"])) / \
        float(m_c["grad_norm"])
    grad_err = max(float((a.cpu().double() - b.double()).abs().max()
                         / max(float(b.abs().max()), 1e-30))
                   for a, b in zip(g_g, g_c))
    param_err = max(float((a.cpu().double() - b.double()).abs().max())
                    for a, b in zip(p_g, p_c))
    if (loss_err > 1e-5 or norm_err > 1e-4 or grad_err > 1e-4
            or param_err > 2 * c_opt.lr):
        raise AssertionError(f"(v)(2) card against CPU: loss {loss_err}, "
                             f"grad_norm {norm_err}, gradients {grad_err}, "
                             f"parameters {param_err}")
    log(f"[v] qwen3-0.6b at full width, 2 of 28 layers, float32, one AdamW "
        f"step on (2, 32): card {ms_g:.1f} ms, CPU {ms_c:.1f} ms; the "
        f"card's loss against the CPU's rel err {loss_err:.3e} (tolerance "
        f"1e-5), grad_norm {norm_err:.3e} (1e-4), the largest gradient "
        f"leaf's error over its largest magnitude {grad_err:.3e} (1e-4), "
        f"new parameters within {param_err:.3e} (2 lr = {2 * c_opt.lr})")
    workloads["LM train step card against CPU (v)"] = {
        "first_ms": ms_g, "cpu_ms": ms_c, "rel_err_loss": loss_err,
        "rel_err_grad_norm": norm_err, "rel_err_grads": grad_err,
        "param_err": param_err}
    del c_params, on_host, runs, g_g, g_c, p_g, p_c, grads, p, b
    torch.cuda.empty_cache()

    # (v)(3) one train step each for the other families at full width, the
    # depth of (u)(2): loss and gradients, plain SGD at lr 0.05, twice on
    # one (4, 32) batch (tests/test_arch_smoke.py's step); the loss falls
    for arch, n_layers, extra, _ in U_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  **extra)
        params = lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED))
        batch = batch_for_step(cfg, ShapeConfig("v3", 32, 4, "train"), 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(2):
            (loss, grads), t = synced_ms(lambda: value_and_grad(
                remat_loss_fn(cfg, None), params, batch))
            params = lm.tree_map(lambda p, g: p - 0.05 * g.to(p.dtype),
                                 params, grads)
            losses.append(float(loss))
            ms.append(t)
            del grads
        peak = torch.cuda.max_memory_allocated() - base
        if not (np.isfinite(losses).all() and losses[1] < losses[0]):
            raise AssertionError(f"(v)(3) {arch}: losses {losses}")
        log(f"[v] {arch}, {n_layers} of {get_config(arch).n_layers} layers"
            + (f" ({extra})" if extra else "") + f", {cfg.n_params()} "
            f"params: loss {losses[0]:.4f} -> {losses[1]:.4f} after one "
            f"SGD step; step ms {ms[0]:.1f} then {ms[1]:.1f}; peak {peak} "
            f"bytes above the {base} live")
        workloads[f"LM training {arch} (v)"] = {
            "first_ms": ms[0], "warm_ms": ms[1], "losses": losses,
            "peak_bytes": peak}
        del params, batch
        torch.cuda.empty_cache()
    per_phase["v"] = kops.launch_counts()
    if any(per_phase["v"].values()):
        raise AssertionError(f"(v) launched a hand-written kernel: "
                             f"{per_phase['v']}")
    log(f"[v] launches {per_phase['v']} (no hand-written kernel lies on "
        f"the LM training path); phase {time.perf_counter() - v_start:.1f} s")

    # -- (q) serving, threaded, on the card ---------------------------------
    # last of the paths, after (f): a torch.profiler session that spans
    # the server's threads leaves later sessions missing device events
    # four submitter threads at once, each 16 requests of (d2)'s product (a
    # density each, uniform in [0.005, 0.02], a seed each) and 4 of (e)'s
    # Plus3, plus a b-format SpMM at (g)'s shape and the fused GAT program at
    # (k)'s shape on the same server; every result equals its float64 oracle
    import threading

    from repro_torch.core.serving import AdmissionError, Request, SamServer

    n = 1024
    mm_expr = "X(i,j) = B(i,k) * C(k,j)"
    mm_fmt = {"B": "cc", "C": "cc"}
    p3_expr = "X(i,j) = B(i,j) + C(i,j) + D(i,j)"
    p3_fmt = {"B": "cc", "C": "cc", "D": "cc"}
    q_jobs = []                     # per thread: [(kind, arrays, want)]
    for t in range(4):
        rt = np.random.default_rng(SEED + 300 + t)
        jobs = []
        for r in range(16):
            rs = np.random.default_rng(SEED + 400 + 16 * t + r)
            dens = float(rt.uniform(0.005, 0.02))
            arrays = {m: sparse_int(rs, (n, n), dens) for m in "BC"}
            jobs.append(("d2", arrays, (sp.csr_matrix(arrays["B"])
                                        @ sp.csr_matrix(arrays["C"]))
                         .toarray()))
        for r in range(4):
            rs = np.random.default_rng(SEED + 500 + 4 * t + r)
            arrays = {m: sparse_int(rs, (n, n), 0.05) for m in "BCD"}
            jobs.append(("e", arrays,
                         arrays["B"] + arrays["C"] + arrays["D"]))
        q_jobs.append([jobs[i] for i in rt.permutation(len(jobs))])
    d2_sets = [a for jobs in q_jobs for k, a, _ in jobs if k == "d2"]
    # (g)'s shape and (k)'s, their operands drawn here
    rq = np.random.default_rng(SEED + 600)
    bs, d_model, d_ff, tokens = 128, 3072, 8192, 4096
    nbr, nbc = d_ff // bs, d_model // bs
    keep = np.zeros(nbr * nbc, bool)
    keep[rq.choice(nbr * nbc, nbr * nbc // 4, replace=False)] = True
    q_w1t = (np.kron(keep.reshape(nbr, nbc), np.ones((bs, bs), np.int8))
             * rq.integers(-3, 4, (d_ff, d_model), dtype=np.int8)
             ).astype(np.float32)
    q_xt = rq.integers(-3, 4, (d_model, tokens)).astype(np.float32)
    q_spmm_want = q_w1t.astype(np.float64) @ q_xt.astype(np.float64)
    n_nodes, deg, feat = 16384, 14, 128
    src = np.repeat(np.arange(n_nodes), deg)
    dst = np.concatenate([rq.choice(n_nodes, deg, replace=False)
                          for _ in range(n_nodes)])
    edge = rq.integers(1, 4, src.size) * rq.choice([-1, 1], src.size)
    adj = np.zeros((n_nodes, n_nodes))
    adj[src, dst] = edge
    feats = {t: rq.integers(-3, 4, (n_nodes, feat)).astype(float)
             for t in "CDE"}
    q_gat = {"B": adj, **feats}
    q_gat_want = sp.csr_matrix(
        (edge * np.einsum("ef,ef->e", feats["C"][src], feats["D"][dst]),
         (src, dst)), shape=(n_nodes, n_nodes)) @ feats["E"]
    del adj, src, dst, edge, feats
    nnz_b = [np.count_nonzero(a["B"]) for a in d2_sets]
    log(f"[q] 4 threads x (16 of (d2), {min(nnz_b)}-{max(nnz_b)} nonzeros "
        f"in B, and 4 of (e)); a b-format SpMM at (g)'s shape and the GAT "
        f"program at (k)'s")

    kops.reset_launch_counts()
    srv = SamServer(max_batch=8)
    q_results = {}
    q_errors = []
    start = threading.Barrier(5)

    def submitter(ti):
        try:
            start.wait(timeout=600)
            hs = [srv.submit(Request(mm_expr if kind == "d2" else p3_expr,
                                     arrays, formats=mm_fmt if kind == "d2"
                                     else p3_fmt,
                                     order="ikj" if kind == "d2" else "ij"))
                  for kind, arrays, _ in q_jobs[ti]]
            q_results[ti] = [h.result(timeout=600) for h in hs]
        except Exception as exc:  # noqa: BLE001 — fails the phase below
            q_errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(ti,))
               for ti in range(4)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    start.wait(timeout=600)
    h_spmm = srv.submit(Request(
        "x(i,k) = B(i,j) * C(j,k)", {"B": q_w1t, "C": q_xt},
        formats={"B": "bb", "C": "dd", "x": "dd"}, order="ijk"))
    h_gat = srv.submit(Request(
        GAT, q_gat, formats=GAT_FMT,
        schedule={k: Schedule(loop_order=o) for k, o in GAT_ORDER.items()},
        dims={"i": n_nodes, "j": n_nodes, "f": feat, "g": feat}))
    pipeline = sorted(th.name for th in threading.enumerate()
                      if th.name.startswith("sam-serve-") and th.is_alive())
    for th in threads:
        th.join(timeout=900)
    srv.drain(timeout=900)
    q_wall = time.perf_counter() - t0
    st_q = srv.stats()
    if q_errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"(q) submitter failed: {q_errors[:1]}")
    if pipeline != ["sam-serve-batcher", "sam-serve-decode",
                    "sam-serve-dispatch", "sam-serve-encode"]:
        raise AssertionError(f"(q) pipeline threads {pipeline}")
    if (st_q["submitted"] != 82 or st_q["completed"] != 82
            or st_q["failed"] or st_q["rejected"]):
        raise AssertionError(f"(q) stats {st_q}")
    for ti, jobs in enumerate(q_jobs):
        for (kind, _, want), got in zip(jobs, q_results[ti]):
            check_equal(f"(q) {kind} request", tree_to_dense(got), want)
    check_equal("(q) b-format SpMM", tree_to_dense(h_spmm.result(timeout=60)),
                q_spmm_want)
    check_equal("(q) GAT program",
                tree_to_dense(h_gat.result(timeout=60)["A"]), q_gat_want)
    del q_spmm_want, q_gat_want
    per_phase["q"] = kops.launch_counts()
    # the (d2) results against the same engine's execute_batch, bit for bit
    d2_eng = expr_engine(mm_expr, mm_fmt, ("i", "k", "j"),
                         {"i": n, "j": n, "k": n})
    for ti, jobs in enumerate(q_jobs):
        members = [(a, got) for (kind, a, _), got in zip(jobs, q_results[ti])
                   if kind == "d2"]
        for (a, got), ref in zip(members, d2_eng.execute_batch(
                [a for a, _ in members])):
            if not all(np.array_equal(x, y) for x, y in (
                    (got.vals, ref.vals),
                    *((lg.crd, lr.crd) for lg, lr in
                      zip(got.levels, ref.levels)))):
                raise AssertionError("(q) a served (d2) result differs "
                                     "from execute_batch")
    for name in ("scatter_workspace", "segment_reduce", "spmm_bsr",
                 "coo_to_levels"):
        if per_phase["q"][name] < 1:
            raise AssertionError(f"(q) {name} never launched: "
                                 f"{per_phase['q']}")
    log(f"[q] 82 requests served in {q_wall * 1e3:.1f} ms, every result "
        f"equal to its oracle, the (d2) results to execute_batch bit for "
        f"bit; pipeline threads while it ran {pipeline}; launches "
        f"{per_phase['q']}")
    log(f"[q] stats: {st_q['requests_per_sec']:.3f} requests/s, p50_ms "
        f"{st_q['p50_ms']:.1f}, p99_ms {st_q['p99_ms']:.1f}, service p50/p99 "
        f"{st_q['service_p50_ms']:.1f}/{st_q['service_p99_ms']:.1f} ms, "
        f"queue wait p50/p99 {st_q['queue_wait_p50_ms']:.1f}/"
        f"{st_q['queue_wait_p99_ms']:.1f} ms, dispatches "
        f"{st_q['dispatches']}, occupancy {st_q['batch_occupancy']:.3f}, "
        f"max batch {st_q['max_batch_seen']}")
    srv.shutdown()

    def burst():
        """One served burst: the 64 (d2) operand sets and the 16 Plus3
        ones submitted at once, drained."""
        with SamServer(max_batch=8) as s:
            hs = s.submit_many(
                [Request(mm_expr if kind == "d2" else p3_expr, arrays,
                         formats=mm_fmt if kind == "d2" else p3_fmt,
                         order="ikj" if kind == "d2" else "ij")
                 for jobs in q_jobs for kind, arrays, _ in jobs])
            s.drain(timeout=900)
            bad = [h for h in hs if h.exception(timeout=60) is not None]
            if bad:
                raise AssertionError(f"(q) burst: {bad[0].exception()}")
            return s.stats()

    # one burst, profiled (its requests/s carry the profiler's cost)
    bursts = []
    prof_q = device_profile(lambda: bursts.append(burst()))
    st_burst = bursts[0]
    # the sequential loop: one (d2) request at a time on a fresh engine
    seq_eng = CompiledExpr(mm_expr, Format(mm_fmt),
                           Schedule(loop_order=("i", "k", "j")),
                           {"i": n, "j": n, "k": n})
    t0 = time.perf_counter()
    for a in d2_sets:
        seq_eng.execute(a)
    seq_s = time.perf_counter() - t0
    idle = prof_q["idle_share"]
    log(f"[q] a served burst of 80: {st_burst['requests_per_sec']:.3f} "
        f"requests/s, {st_burst['dispatches']} dispatches; profiled burst "
        f"{prof_q['wall_ms']:.1f} ms with {prof_q['device_busy_ms']:.3f} ms "
        f"of kernels on the card, idle share "
        + ("not measured" if idle is None else f"{idle:.4f}"))
    log(f"[q] sequential loop: 64 (d2) requests one at a time on a fresh "
        f"engine in {seq_s * 1e3:.1f} ms = {64 / seq_s:.3f} requests/s")

    # admission of (o) under 4 GB: refused with reason, or served tiled
    with SamServer(mem_budget="4GB", admission="reject") as s:
        h = s.submit(Request(o_expr, o_arrays, formats={"B": "cc",
                                                        "C": "dd"},
                             order="ikj", density=o_dens))
        err = h.exception(timeout=600)
        if (not isinstance(err, AdmissionError) or err.reason != "over-budget"
                or s.stats()["dispatches"]):
            raise AssertionError(f"(q) (o) not refused over budget: {err}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with SamServer(mem_budget="4GB") as s:
        h = s.submit(Request(o_expr, o_arrays, formats={"B": "cc",
                                                        "C": "dd"},
                             order="ikj", density=o_dens))
        got_o = h.result(timeout=900)
        st_o = s.stats()
    q_o_ms = (time.perf_counter() - t0) * 1e3
    # the request's own peak: the allocations live when it started (the
    # earlier phases' tensors) are not its own
    q_o_peak = torch.cuda.max_memory_allocated() - base
    check_equal("(q) (o) served tiled", tree_to_dense(got_o), want_o)
    if st_o["tiled_requests"] != 1 or q_o_peak > o_budget:
        raise AssertionError(f"(q) (o) stats {st_o}, peak {q_o_peak}")
    log(f"[q] (o) refused over budget with admission='reject'; served "
        f"tiled under 4GB in {q_o_ms:.1f} ms, equal to (o)'s oracle, peak "
        f"allocated {q_o_peak} bytes above the {base} live before it "
        f"(budget {o_budget})")
    workloads["serving (q)"] = {
        "wall_ms": q_wall * 1e3, "stats": st_q, "burst_stats": st_burst,
        "profile": prof_q, "pipeline_threads": pipeline,
        "sequential_requests_per_sec": 64 / seq_s,
        "sequential_ms": seq_s * 1e3, "o_tiled_ms": q_o_ms,
        "o_tiled_peak_bytes": q_o_peak, "warm_ms": q_wall * 1e3 / 82}
    del q_jobs, q_results, d2_sets, q_w1t, q_xt, q_gat, got_o

    # -- (r) distributed tiles on the card -----------------------------------
    from repro_torch.core.dist_exec import DistTiledExpr, InjectedFault

    ref_o = o_result                         # (o)'s TiledExpr result
    dist = DistTiledExpr(teng, workers=2, overlap=True, faults=[
        InjectedFault(tile=1, worker=w, attempt=0) for w in (0, 1)])

    def dist_call(label):
        """One distributed call: host ms and its peak allocated bytes above
        what was live before it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = dist(o_arrays)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        same = (np.array_equal(out.vals, ref_o.vals) and all(
            np.array_equal(a.crd, b.crd) and np.array_equal(a.seg, b.seg)
            for a, b in zip(out.levels, ref_o.levels)))
        if not same:
            raise AssertionError(f"(r) {label}: differs from (o)'s TiledExpr")
        check_equal(f"(r) {label}", tree_to_dense(out), want_o)
        if peak > o_budget:
            raise AssertionError(f"(r) {label}: peak {peak} above the "
                                 f"budget {o_budget}")
        return ms, peak

    # one call (its plans are (o)'s engine's, built before): a second
    # call would add about 12 s to the script's time limit
    kops.reset_launch_counts()               # the DistTiledExpr call only
    r_ms, r_peak = dist_call("the call")
    per_phase["r"] = kops.launch_counts()
    if (dist.stats["tiles"] != 4 or dist.stats["retries"] < 1
            or per_phase["r"]["segment_reduce"] < 1):
        raise AssertionError(f"(r) stats {dist.stats}, launches "
                             f"{per_phase['r']}")
    log(f"[r] DistTiledExpr of (o), 2 workers, overlap: tile 1 failed on "
        f"its first attempt and was retried ({dist.failure_log[0]}); equal "
        f"to (o)'s TiledExpr bit for bit and to the oracle; one call "
        f"{r_ms:.1f} ms (o: first {first_o:.1f}, warm {warm_o:.1f}); peak "
        f"{r_peak} bytes (budget {o_budget}); stats {dist.stats}; launches "
        f"{per_phase['r']}")
    workloads["distributed tiles (r)"] = {
        "first_ms": r_ms, "peak_bytes": r_peak, "stats": dict(dist.stats),
        "failure_log": dist.failure_log}
    del dist, ref_o, o_result

    # the CLI: serve --sam with a budget that tiles, tiles over 2 workers
    cli_dims = {"i": 4096, "j": 512, "k": 4096}
    cli_est = tiling.estimate_call_bytes(
        o_expr, o_fmt, o_sch, cli_dims, densities={"B": 0.002, "C": 0.002})
    cli_budget = cli_est // 3
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--sam",
           o_expr, "--sam-order", "ikj", "--sam-formats", "B=cc,C=dd",
           "--sam-dims", ",".join(f"{k}={v}" for k, v in cli_dims.items()),
           "--sam-density", "0.002", "--mem-budget", str(cli_budget),
           "--workers", "2", "--batch", "2", "--reps", "1"]
    t0 = time.perf_counter()
    cli = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    cli_s = time.perf_counter() - t0
    for line in cli.stdout.splitlines():
        log(f"[r] cli: {line}")
    if (cli.returncode or "OUT-OF-CORE" not in cli.stdout
            or "DISTRIBUTED" not in cli.stdout):
        raise AssertionError(f"(r) serve --sam exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    log(f"[r] serve --sam --mem-budget {cli_budget} (a third of the untiled "
        f"estimate {cli_est}) --workers 2 exited 0 in {cli_s:.1f} s")
    workloads["distributed tiles (r)"]["cli_budget"] = cli_budget
    del o_arrays, want_o, teng, spmspm_d, want_d

    # -- (w) the launch tools and the examples -------------------------------
    # (1) and the four examples run as subprocesses on the card; (2) and
    # (3) count on meta tensors in a host process started after (a); each
    # subprocess on the card prints its kernel launches, which make the
    # phase's
    from repro_torch.core.autoschedule import (resolve_densities,
                                               synthetic_operands)
    from repro_torch.core.einsum import parse as w_parse

    w_start = time.perf_counter()
    w_env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    w_dims = {"i": W_SAM_N, "j": W_SAM_N, "k": W_SAM_N}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)     # (1)'s and (3)'s JSON
    w_json = ROOT / "chiprun_out" / "w_sam_dryrun.json"
    w_cmds = {"dryrun --sam": [
        "-m", "repro_torch.launch.dryrun", "--sam", W_SAM, "--sam-dims",
        ",".join(f"{k}={v}" for k, v in w_dims.items()), "--sam-density",
        str(W_SAM_DENSITY), "--json", str(w_json)]}
    w_cmds.update({name: [str(ROOT / "examples" / name)]
                   for name in W_EXAMPLES})
    w_procs = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable] + cmd, cwd=ROOT, env=w_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, cmd in w_cmds.items()}
    per_phase["w"] = {k: 0 for k in kops.launch_counts()}
    w_runs = {}
    try:
        # (2) and (3) ran on the host beside the earlier phases
        # (``w_lm_counts``, started after (a)); their records are read here
        w_lm_out, w_lm_err = W_LM_PROC[0].communicate(timeout=900)
        (ROOT / "chiprun_out" / "w_lm.log").write_text(
            w_lm_out + "\n--- stderr\n" + w_lm_err)
        if W_LM_PROC[0].returncode:
            raise AssertionError(f"(w)(2) exited {W_LM_PROC[0].returncode} "
                                 f"(its output in chiprun_out/w_lm.log): "
                                 f"{w_lm_err[-3000:]}")
        w_lm_rec = json.loads(W_LM_JSON.read_text())
        w2_s, w3_s = w_lm_rec["lm_s"], w_lm_rec["probe_s"]
        w_lm = {}
        for rec in w_lm_rec["cells"]:
            arch, shape = rec["arch"], rec["shape"]
            if rec.get("skipped"):
                log(f"[w] (2) {arch} x {shape}: skipped (full attention "
                    f"at 500k)")
                continue
            w_lm[(arch, shape, rec["n_devices"])] = rec
            log_w_lm_cell(rec)

        # (3) the probe sweep of qwen3-0.6b x train_4k: its extrapolation
        # must equal (2)'s direct count
        w_probe = w_lm_rec["probe"]
        direct = w_lm[("qwen3-0.6b", "train_4k", 256)]
        dr = direct["roofline"]
        if (w_probe["flops_per_device"] * 256 != direct["flops"]
                or w_probe["bytes_per_device"] * 256
                != direct["bytes_accessed"]
                or (dr["collective_bytes_per_device"] is None)
                != (w_probe["collective_bytes_per_device"] is None)
                or (dr["collective_bytes_per_device"] is not None and abs(
                    w_probe["collective_bytes_per_device"]
                    - dr["collective_bytes_per_device"])
                    > 1e-9 * dr["collective_bytes_per_device"])):
            raise AssertionError(f"(w)(3) probes {w_probe} against the "
                                 f"direct count {direct}")
        log(f"[w] (3) roofline_sweep qwen3-0.6b x train_4k: probes "
            f"extrapolate {w_probe['flops_per_device'] * 256:.6e} flops, "
            f"{w_probe['bytes_per_device'] * 256:.6e} bytes and "
            f"{w_probe['collective_bytes_per_device']} collective bytes a "
            f"device, equal to (2)'s direct count; {w3_s:.1f} s on the "
            f"host ((2) took {w2_s:.1f} s, both beside (b)-(v))")

        # (1) and (4): each subprocess must exit 0 with its OK line
        for name, (started, proc) in w_procs.items():
            out, err = proc.communicate(timeout=600)
            secs = time.perf_counter() - started
            lines = out.strip().splitlines()
            ok = [ln for ln in lines if ln.startswith(("OK", "[sam-dryrun] "
                                                       "all"))]
            if proc.returncode or not ok:
                raise AssertionError(f"(w) {name} exited "
                                     f"{proc.returncode}: {out[-1500:]} "
                                     f"{err[-1500:]}")
            for line in lines:
                if line.startswith("kernel launches:"):
                    for k, v in json.loads(line.split(":", 1)[1]).items():
                        per_phase["w"][k] += v
            w_runs[name] = {"ok_line": ok[-1], "seconds": secs}
            log(f"[w] {'(1)' if name == 'dryrun --sam' else '(4)'} {name}: "
                f"{ok[-1]} (done within {secs:.1f} s)")
    finally:
        for _, proc in w_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # (1)'s cells: all 16, each equal to the oracle, and a reduce kernel
    # launched
    w_cells = json.loads(w_json.read_text())
    w_arrays = synthetic_operands(
        w_parse(W_SAM), w_dims,
        resolve_densities(w_parse(W_SAM), W_SAM_DENSITY))
    w_nnz = int(np.count_nonzero(oracle(W_SAM, w_arrays)))
    if (len(w_cells) != 16
            or any("error" in c or not c["equals_oracle"]
                   or c["engine_nnz"] != w_nnz for c in w_cells)
            or per_phase["w"]["scatter_workspace"]
            + per_phase["w"]["segment_reduce"] < 1
            or per_phase["w"]["spmm_bsr"] < 1):
        raise AssertionError(f"(w) cells {w_cells}, launches "
                             f"{per_phase['w']}")
    w_cycles = [c["cycles"]["paper"] for c in w_cells]
    log(f"[w] (1) dryrun --sam {W_SAM!r} at {w_dims}, density "
        f"{W_SAM_DENSITY} ({int(np.count_nonzero(w_arrays['B']))} and "
        f"{int(np.count_nonzero(w_arrays['C']))} nonzeros): "
        f"{len(w_cells)} format cells on the card, each equal to the "
        f"oracle ({w_nnz} nonzeros), cycles under "
        f"{len(w_cells[0]['cycles'])} presets (paper {min(w_cycles)}-"
        f"{max(w_cycles)})")
    workloads["launch tools (w)"] = {
        "first_ms": (time.perf_counter() - w_start) * 1e3,
        "sam_cells": w_cells, "lm_s": w2_s, "probe_s": w3_s,
        "lm_cells": [{k: v for k, v in rec.items() if k != "roofline"}
                     | rec["roofline"] for rec in w_lm.values()],
        "probe": w_probe, "subprocesses": w_runs}
    log(f"[w] launches {per_phase['w']} ((1) and the examples); phase "
        f"{time.perf_counter() - w_start:.1f} s")

    # -- (x) lanes and placement over several devices ------------------------
    phase_x(x_m, x_d2, workloads, per_phase)
    workloads["launch tools (w)"]["ssm_cells"] = [
        {k: v for k, v in rec.items() if k != "roofline"} | rec["roofline"]
        for rec in read_w_ssm()]
    del x_m, x_d2

    # the model blocks' and the serving path's launches join the kernels
    # line
    for row in kernels:
        row["launches"] += sum(per_phase[t][row["name"]]
                               for t in ("s", "t2", "t3", "t3s", "u",
                                         "v", "q", "r", "w", "x"))

    clear_compile_cache()
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "workloads": workloads, "launches_by_phase": per_phase,
               "launches_by_route": per_route,
               "kernels": measured}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    for label, w in workloads.items():
        log(f"[workload] {label}: " + (f"warm {w['warm_ms']:.3f} ms"
                                       if "warm_ms" in w else
                                       f"one call {w['first_ms']:.3f} ms"))
    log(f"[time] seconds since start at each phase's last line "
        f"{json.dumps(PHASE_END_S)}")
    log(json.dumps({"kernels": [
        {k: v for k, v in r.items()
         if k not in ("shape", "bytes", "device_ms", "kernel_device_ms",
                      "ms_again", "ids")}
        for r in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_x(x_m, x_d2, workloads, per_phase) -> None:
    """(x): lanes and placement over several devices (the module's
    docstring). ``x_m`` and ``x_d2`` are (operands, float64 oracle,
    single-device result) of (m)'s and (d2)'s products; ``workloads``
    holds (m)'s and (d2)'s warm ms; ``per_phase`` gets (x)'s launches."""
    import os
    import tempfile

    import torch

    from repro_torch.core import torch_backend as tb
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.kernels import ops as kops

    x_start = time.perf_counter()
    n_gpus = torch.cuda.device_count()

    # (x)(1) (m)'s and (d2)'s products with their lanes over a lane mesh of
    # four: distinct cards where the host has four, else cuda:0 four times
    lane_env = os.environ.get(tb.LANE_DEVICES_ENV)
    if n_gpus < 4:
        os.environ[tb.LANE_DEVICES_ENV] = "4"
    lanes4 = dict(loop_order=("i", "k", "j"), split={"i": 4},
                  parallelize={"i": 4})
    x_runs = {}
    try:
        kops.reset_launch_counts()
        for tag, (arrays, want, single), n, base in (
                ("m", x_m, 4096, "SpMSpM 4096 lanes"),
                ("d2", x_d2, 1024, "SpMSpM 1024 ikj")):
            eng = tb.compile_expr("X(i,j) = B(i,k) * C(k,j)",
                                  Format({"B": "cc", "C": "cc"}),
                                  Schedule(**lanes4),
                                  {"i": n, "j": n, "k": n}, shard_lanes=4)
            got = tree_to_dense(eng(arrays))
            check_equal(f"(x)(1) {tag} on the lane mesh", got, want)
            if not np.array_equal(got, single):
                raise AssertionError(f"(x)(1) {tag} differs from ({tag})")
            ms = warm_ms(lambda: eng(arrays), reps=3)
            x_runs[tag] = {"warm_ms": ms, "stats": dict(eng.stats),
                           "devices": [str(d) for d in eng._lane_devices],
                           "single_warm_ms": workloads[base]["warm_ms"]}
            if eng.stats["sharded_dispatches"] < 1:
                raise AssertionError(f"(x)(1) {tag} stats {eng.stats}")
            log(f"[x] (1) ({tag})'s product, lanes {{i: 4}} over the lane "
                f"mesh {x_runs[tag]['devices']}: equals ({tag})'s result "
                f"and the oracle; warm median {ms:.3f} ms over 3 against "
                f"({tag})'s {x_runs[tag]['single_warm_ms']:.3f} ms; "
                f"sharded_dispatches {eng.stats['sharded_dispatches']}")
        per_phase["x"] = kops.launch_counts()
    finally:
        if lane_env is None:
            os.environ.pop(tb.LANE_DEVICES_ENV, None)
        else:
            os.environ[tb.LANE_DEVICES_ENV] = lane_env
    if (per_phase["x"]["segment_reduce"] < 1
            or per_phase["x"]["scatter_workspace"] < 1):
        raise AssertionError(f"(x)(1) launches {per_phase['x']}")
    log(f"[x] (1) lane mesh of four: "
        + ("four distinct cards" if n_gpus >= 4 else
           f"cuda:0 repeated four times ({n_gpus} card(s) on this host)")
        + f"; launches {per_phase['x']}")
    # (x)(2) placement: qwen3-0.6b whole under torch.distributed.run on
    # DTensors (NCCL) against a plain one-process run of the same steps,
    # then a counted qwen3-0.6b step and one moonshot-v1-16b-a3b step (2
    # of 48 layers at full width) under the same launch against the plain
    # step; the three launches run together on four cards
    x_mp = 2 if n_gpus >= 4 else 1
    x_env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    x_tmp = tempfile.mkdtemp()
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n_gpus)]
    x_train = ["-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
               "--batch", str(X_BATCH), "--seq", str(X_SEQ), "--steps",
               str(X_STEPS)]
    x_cmds = {
        "sharded": torchrun + x_train + [
            "--model-parallel", str(x_mp), "--ckpt-dir",
            os.path.join(x_tmp, "sharded")],
        "plain": [sys.executable] + x_train + [
            "--ckpt-dir", os.path.join(x_tmp, "plain")],
        "ranks": torchrun + [str(ROOT / "chip_smoke.py"), "--x2-ranks",
                             x_tmp, str(x_mp)]}
    def start(name):
        return time.perf_counter(), subprocess.Popen(
            x_cmds[name], cwd=ROOT, env=x_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    # on fewer than four cards the counted step and the moonshot step wait
    # for the two qwen3-0.6b runs: the four processes' steps at once
    # outgrow one card's 80 GB (call 2, PR 26)
    later = () if n_gpus >= 4 else ("ranks",)
    x_procs = {name: start(name) for name in x_cmds if name not in later}
    x_out = {}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    try:
        for name in x_cmds:
            if name not in x_procs:
                x_procs[name] = start(name)
            started, proc = x_procs[name]
            out, err = proc.communicate(timeout=600)
            x_out[name] = (out, time.perf_counter() - started)
            (ROOT / "chiprun_out" / f"x2_{name}.log").write_text(
                out + "\n--- stderr\n" + err)
            if proc.returncode:
                raise AssertionError(
                    f"(x)(2) {name} exited {proc.returncode} (its output "
                    f"in chiprun_out/x2_{name}.log): {out[-2000:]} "
                    + " ".join(ln for ln in err.splitlines()
                               if "Error" in ln)[-3000:])
    finally:
        for _, proc in x_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def losses_of(out):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("[train] losses ")]
        if len(lines) != 1:
            raise AssertionError(f"(x)(2) output {out[-2000:]}")
        return json.loads(lines[0][len("[train] losses "):])
    x_sharded, x_plain = (losses_of(x_out[k][0]) for k in ("sharded",
                                                            "plain"))
    x_errs = [abs(a - b) / abs(b) for a, b in zip(x_sharded, x_plain)]
    # the first loss comes from the same parameters, so it holds 1e-5;
    # with a data axis over 1 card each shard's bfloat16 weight gradients
    # round before their sum, so the later losses hold 1e-4 (1.19e-5
    # after 2 steps on four H100s, PERF.md); on one card every op is
    # local and all of them hold 1e-5
    x_tol = [1e-5] + [1e-5 if n_gpus == x_mp else 1e-4] * (X_STEPS - 1)
    mesh_line = next(ln for ln in x_out["sharded"][0].splitlines()
                     if ln.startswith("[train] qwen3-0.6b"))
    if (len(x_sharded) != X_STEPS
            or any(e > t for e, t in zip(x_errs, x_tol))):
        raise AssertionError(f"(x)(2) qwen3-0.6b losses {x_sharded} "
                             f"against the plain run's {x_plain}")
    log(f"[x] (2) qwen3-0.6b whole, batch {X_BATCH} x {X_SEQ}, "
        f"{X_STEPS} steps under torch.distributed.run on {n_gpus} card(s), "
        f"model parallel {x_mp}, DTensors over NCCL: {mesh_line!r}; "
        f"losses {x_sharded} against the plain run's {x_plain}, relative "
        f"differences {[f'{e:.3e}' for e in x_errs]} (tolerances "
        f"{x_tol}); {x_out['sharded'][1]:.1f} s and "
        f"{x_out['plain'][1]:.1f} s")
    x_moon = json.loads(pathlib.Path(x_tmp, "moonshot.json").read_text())
    x_tp = json.loads(pathlib.Path(x_tmp, "qwen3.json").read_text())
    shutil.rmtree(x_tmp, ignore_errors=True)
    # the collectives the cards issued against the dry-run's count of the
    # same step on the same mesh (a fake process group, meta tensors)
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    x_want = dryrun.count_collectives(
        get_config("qwen3-0.6b"), ShapeConfig("x2", X_SEQ, X_BATCH, "train"),
        "dots", 1, False, tuple(x_tp["mesh"]), ("data", "model"))
    x_dry_s = time.perf_counter() - t0
    x_got = {k: (v["calls"], v["bytes"]) for k, v in x_tp["by_axis"].items()}
    x_dry = {k: (v["calls"], v["bytes"])
             for k, v in x_want.get("by_axis", {}).items()}
    log(f"[x] (2) qwen3-0.6b's placed train step on {x_tp['mesh']} "
        f"(batch {X_BATCH} x {X_SEQ}, bf16, dots, AdamW): peak allocated "
        f"bytes a card {x_tp['peaks']} (allocated before the step "
        f"{x_tp['before']}); collectives on the cards (op@axis: calls, "
        f"output bytes a card) {json.dumps(x_got)}, wire bytes a card "
        f"{x_tp['bytes']}; the dry-run's count of the same step and mesh "
        f"{json.dumps(x_dry)}, wire bytes {x_want.get('bytes')} "
        f"({x_dry_s:.1f} s)")
    if x_got != x_dry or x_tp["bytes"] != x_want.get("bytes"):
        raise AssertionError(f"(x)(2) collectives on the cards {x_got} "
                             f"against the dry-run's {x_want}")
    if x_moon["loss_err"] > 1e-5 or x_moon["grad_err"] > 1e-4:
        raise AssertionError(f"(x)(2) moonshot step {x_moon}")
    log(f"[x] (2) moonshot-v1-16b-a3b, 2 of 48 layers at full width (one "
        f"dense, one MoE layer of 64 experts, top-6), float32, one step on "
        f"(4, 32) on DTensors (MoE groups {x_moon['groups']}): loss "
        f"{x_moon['loss']:.6f}, rel err {x_moon['loss_err']:.3e} against "
        f"the plain step (1e-5), the largest gradient leaf's error over "
        f"its largest magnitude {x_moon['grad_err']:.3e} (1e-4); "
        f"{x_out['ranks'][1]:.1f} s (with the counted qwen3-0.6b step)")
    # its counted train step: the experts on their expert-parallel shards,
    # the collectives equal to the dry-run's count of the same step
    moon_cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                                   n_layers=2, compute_dtype="float32")
    x_mesh = tuple(x_moon["mesh"])
    want_e = rules_local_experts(moon_cfg, x_mesh)
    bad = [sh for card in x_moon["shards"] for sh in card
           if sh[2][0] != want_e or sh[2][1:] != sh[1][1:]]
    if bad or not all(x_moon["shards"]):
        raise AssertionError(f"(x)(2) moonshot's expert shards {bad or x_moon}"
                             f" (the rules give {want_e} experts a card)")
    t0 = time.perf_counter()
    moon_want = dryrun.count_collectives(
        moon_cfg, ShapeConfig("x2", 32, 4, "train"), "dots", 1, False,
        x_mesh, ("data", "model"))
    moon_got = {k: (v["calls"], v["bytes"])
                for k, v in x_moon["by_axis"].items()}
    moon_dry = {k: (v["calls"], v["bytes"])
                for k, v in moon_want.get("by_axis", {}).items()}
    log(f"[x] (2) moonshot's counted train step on {x_mesh} (float32, dots, "
        f"AdamW): the expert stacks' local shards {want_e} of 64 experts "
        f"on every card while the MoE layer runs (the rules' "
        f"{x_mesh} split); peak allocated bytes a card {x_moon['peaks']} "
        f"(allocated before the step {x_moon['before']}); collectives on "
        f"the cards {json.dumps(moon_got)}, wire bytes a card "
        f"{x_moon['bytes']}; the dry-run's count {json.dumps(moon_dry)}, "
        f"wire bytes {moon_want.get('bytes')} "
        f"({time.perf_counter() - t0:.1f} s)")
    if moon_got != moon_dry or x_moon["bytes"] != moon_want.get("bytes"):
        raise AssertionError(f"(x)(2) moonshot's collectives on the cards "
                             f"{moon_got} against the dry-run's {moon_want}")
    x_deep = phase_x3(n_gpus, x_env, torchrun)
    x_ssm = phase_x4(n_gpus, x_env, torchrun)
    workloads["lanes and placement (x)"] = {
        "first_ms": (time.perf_counter() - x_start) * 1e3,
        "lanes": x_runs, "qwen3_sharded": x_sharded, "qwen3_plain": x_plain,
        "qwen3_loss_rel_errs": x_errs, "moonshot": x_moon,
        "qwen3_counted": x_tp, "qwen3_dryrun": x_want,
        "moonshot_dryrun": moon_want, "deepseek": x_deep, "ssm": x_ssm,
        "cards": n_gpus, "model_parallel": x_mp}
    log(f"[x] phase {time.perf_counter() - x_start:.1f} s")



def rules_local_experts(cfg, mesh_shape) -> int:
    """The experts a card holds of each of ``cfg``'s expert stacks on a
    (data, model) mesh of ``mesh_shape`` by the sharding rules."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    devs = np.empty(int(np.prod(mesh_shape)), dtype=object)
    devs[:] = [torch.device("meta")] * devs.size
    mesh = Mesh(devs.reshape(mesh_shape), ("data", "model"))
    spec = sharding.param_spec(
        "layers/moe/w_gate", (1, cfg.n_experts, cfg.d_model, cfg.moe_d_ff),
        mesh)
    return cfg.n_experts // int(np.prod(
        [mesh.shape[a] for a in sharding.expert_axes(spec)]))


def phase_x3(n_gpus, env, torchrun) -> dict:
    """(x)(3): deepseek-v3-671b's MoE layer at full width (``x3_config``).
    On four cards first its placed step under ``torch.distributed.run``
    (``--x3-ranks``, mesh (2, 2), 64 experts a card), then, with the cards
    released, the plain forward on the last card from the same seed and
    batch (the MoE dispatch in as many groups), whose loss the placed one
    must equal within 1e-5; on fewer cards the plain forward alone (a
    plain step's gradients would not fit beside its 56 GB of parameters),
    which on a one-card host ran after (a), while this process held
    little on the card (``X3_PLAIN``)."""
    import gc
    import tempfile

    import torch

    cfg = x3_config()
    # this process's cached blocks back to the card: the plain forward's
    # process draws 56 GB beside it, with about 65 GiB at its peak
    gc.collect()
    torch.cuda.empty_cache()
    out = {"main_allocated": torch.cuda.memory_allocated(),
           "main_reserved": torch.cuda.memory_reserved()}
    if n_gpus >= 4:
        tmp = tempfile.mkdtemp()
        t0 = time.perf_counter()
        proc = subprocess.run(
            torchrun + [str(ROOT / "chip_smoke.py"), "--x3-ranks", tmp],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        (ROOT / "chiprun_out" / "x3_ranks.log").write_text(
            proc.stdout + "\n--- stderr\n" + proc.stderr)
        if proc.returncode:
            raise AssertionError(
                f"(x)(3) ranks exited {proc.returncode} (output in "
                f"chiprun_out/x3_ranks.log): {proc.stderr[-3000:]}")
        out.update(json.loads(pathlib.Path(tmp, "deepseek.json").read_text()))
        shutil.rmtree(tmp, ignore_errors=True)
        out["ranks_s"] = time.perf_counter() - t0
    # the plain forward: run early on a one-card host (``main``), else now
    # on the last card, which this process does not use
    out.update(X3_PLAIN[0] if X3_PLAIN else x3_plain_run(n_gpus - 1))
    plain = out["plain_loss"]
    if not np.isfinite(plain):
        raise AssertionError(f"(x)(3) plain loss {plain}")
    log(f"[x] (3) deepseek-v3-671b, 2 of 61 layers at full width (one "
        f"dense layer with MLA and d_ff 18,432, one MoE layer of 256 "
        f"experts, top-8, and its shared expert; {out['params']:,} "
        f"parameters), float32, batch (4, 32): the plain forward on card "
        f"{out['plain_card']}" + (" (run after (a))" if X3_PLAIN else "")
        + f", loss {plain:.6f}, {out['plain_forward_ms']:.1f} ms "
        f"(parameters drawn in {out['plain_built_s']:.1f} s), peak "
        f"{out['plain_peak']} bytes with {out['live_before']} live before; "
        f"this process holds {out['main_allocated']} allocated and "
        f"{out['main_reserved']} reserved bytes on cuda:0 at (x)")
    if n_gpus < 4:
        return out
    err = abs(out["loss"] - plain) / abs(plain)
    out["loss_err"] = err
    local = {tuple(sh) for card in out["local"] for sh in card}
    log(f"[x] (3) deepseek-v3-671b's placed step on {out['mesh']} "
        f"(experts' local shards {sorted(local)}): loss {out['loss']:.6f}, "
        f"rel err {err:.3e} against the plain forward (1e-5); every "
        f"gradient leaf finite {out['finite']}; step {out['seconds']:.2f} s; "
        f"peak allocated bytes a card {out['peaks']} (allocated before the "
        f"step {out['before']}); the ranks {out['ranks_s']:.1f} s")
    want_e = rules_local_experts(cfg, tuple(out["mesh"]))
    if (err > 1e-5 or not all(out["finite"])
            or local != {(1, want_e, cfg.d_model, cfg.moe_d_ff),
                         (1, want_e, cfg.moe_d_ff, cfg.d_model)}):
        raise AssertionError(f"(x)(3) deepseek {out}")
    return out


def x4_zamba2_config():
    """(x)(4)'s zamba2-2.7b: 12 of its 54 mamba layers at full width (two
    groups of ``attn_every`` = 6, so the shared block runs twice), float32
    compute."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12,
                               compute_dtype="float32")


def phase_x4(n_gpus, env, torchrun) -> dict:
    """(x)(4): the SSM and hybrid families placed. ``python -m
    torch.distributed.run ... -m repro_torch.launch.train --arch
    xlstm-125m`` (whole, (X_BATCH, X_SEQ), X_STEPS steps) beside a plain
    run, then this script with ``--x4-ranks`` under the same launch
    (``x4_rank``); the counted steps held to ``count_collectives`` of the
    same step and mesh, zamba2's step to the plain one, the placed
    prefills and decode steps to the plain ones."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun

    mp = 2 if n_gpus >= 4 else 1
    tmp = tempfile.mkdtemp()
    cli = ["-m", "repro_torch.launch.train", "--arch", "xlstm-125m",
           "--batch", str(X_BATCH), "--seq", str(X_SEQ), "--steps",
           str(X_STEPS)]
    cmds = {"sharded": torchrun + cli + [
                "--model-parallel", str(mp), "--ckpt-dir",
                os.path.join(tmp, "sharded")],
            "plain": [sys.executable] + cli + [
                "--ckpt-dir", os.path.join(tmp, "plain")],
            "ranks": torchrun + [str(ROOT / "chip_smoke.py"), "--x4-ranks",
                                 tmp, str(mp)]}

    def start(name):
        return time.perf_counter(), subprocess.Popen(
            cmds[name], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    # on one card the ranks (zamba2's step and its plain twin) wait for
    # the two xlstm-125m runs
    later = () if n_gpus >= 4 else ("ranks",)
    procs = {name: start(name) for name in cmds if name not in later}
    outs = {}
    try:
        for name in cmds:
            if name not in procs:
                procs[name] = start(name)
            started, proc = procs[name]
            out, err = proc.communicate(timeout=600)
            outs[name] = (out, time.perf_counter() - started)
            (ROOT / "chiprun_out" / f"x4_{name}.log").write_text(
                out + "\n--- stderr\n" + err)
            if proc.returncode:
                raise AssertionError(
                    f"(x)(4) {name} exited {proc.returncode} (its output "
                    f"in chiprun_out/x4_{name}.log): {out[-2000:]} "
                    + " ".join(ln for ln in err.splitlines()
                               if "Error" in ln)[-3000:])
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def losses_of(out):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("[train] losses ")]
        if len(lines) != 1:
            raise AssertionError(f"(x)(4) output {out[-2000:]}")
        return json.loads(lines[0][len("[train] losses "):])
    rec = json.loads(pathlib.Path(tmp, "x4.json").read_text())
    (ROOT / "chiprun_out" / "x4.json").write_text(json.dumps(rec))
    shutil.rmtree(tmp, ignore_errors=True)
    mesh = tuple(rec["mesh"])
    sharded, plain = (losses_of(outs[k][0]) for k in ("sharded", "plain"))
    errs = [abs(a - b) / abs(b) for a, b in zip(sharded, plain)]
    # on one card every op is the plain one's (the losses equal bit for
    # bit on an H100); split, the bfloat16 losses are held to bfloat16's
    # unit roundoff (X4_BF16_TOL), and the function itself in float32
    # (the step below, X4_XLSTM_TOL)
    tol = [1e-5 if n_gpus == mp else X4_BF16_TOL] * X_STEPS
    if len(sharded) != X_STEPS or any(e > t for e, t in zip(errs, tol)):
        raise AssertionError(f"(x)(4) xlstm-125m losses {sharded} against "
                             f"the plain run's {plain}")
    mesh_line = next(ln for ln in outs["sharded"][0].splitlines()
                     if ln.startswith("[train] xlstm-125m"))
    log(f"[x] (4) xlstm-125m whole, batch {X_BATCH} x {X_SEQ}, {X_STEPS} "
        f"steps under torch.distributed.run on {n_gpus} card(s), model "
        f"parallel {mp}: {mesh_line!r}; losses {sharded} against the plain "
        f"run's {plain}, relative differences "
        f"{[f'{e:.3e}' for e in errs]} (tolerances {tol}); "
        f"{outs['sharded'][1]:.1f} s and {outs['plain'][1]:.1f} s")
    xf, tol = rec["xlstm_f32"], X4_XLSTM_TOL
    if xf["loss_err"] > tol["loss"] or xf["grad_err"] > tol["grad"]:
        raise AssertionError(f"(x)(4) xlstm-125m float32 step {xf}")
    log(f"[x] (4) xlstm-125m whole, float32, one step on (4, 32) on "
        f"{mesh}: loss {xf['loss']:.6f}, rel err {xf['loss_err']:.3e} "
        f"against the plain step ({tol['loss']}), the largest gradient "
        f"leaf's error over its largest magnitude {xf['grad_err']:.3e} "
        f"({tol['grad']})")

    def held_to_dryrun(label, cfg, shape, counted):
        t0 = time.perf_counter()
        want = dryrun.count_collectives(cfg, shape, "dots", 1, False, mesh,
                                        ("data", "model"))
        got = {k: (v["calls"], v["bytes"])
               for k, v in counted["by_axis"].items()}
        dry = {k: (v["calls"], v["bytes"])
               for k, v in want.get("by_axis", {}).items()}
        log(f"[x] (4) {label}'s counted train step on {mesh} (AdamW, "
            f"dots): peak allocated bytes a card {counted['peaks']} "
            f"(allocated before the step {counted['before']}); collectives "
            f"on the cards {json.dumps(got)}, wire bytes a card "
            f"{counted['bytes']}; the dry-run's count {json.dumps(dry)}, "
            f"wire bytes {want.get('bytes')} "
            f"({time.perf_counter() - t0:.1f} s)")
        if got != dry or counted["bytes"] != want.get("bytes"):
            raise AssertionError(f"(x)(4) {label}'s collectives on the "
                                 f"cards {got} against the dry-run's {want}")
        return want
    xl = rec["xlstm"]
    xl_want = held_to_dryrun("xlstm-125m", get_config("xlstm-125m"),
                             ShapeConfig("x4", X_SEQ, X_BATCH, "train"), xl)
    log(f"[x] (4) xlstm-125m's placed step {xl['placed_ms']:.1f} ms against "
        f"the plain step's {xl['plain_ms']:.1f} ms on card 0 (bf16, dots, "
        f"AdamW; the second step of each, the host's dispatch included)")
    zb = rec["zamba2"]
    zcfg = x4_zamba2_config()
    # the rules' split of out_proj's rows over the model axis
    rows = {tuple(sh) for card in zb["out_proj"] for sh in card}
    d_inner = zcfg.ssm_expand * zcfg.d_model
    if (zb["loss_err"] > 1e-5 or zb["grad_err"] > 1e-4
            or rows != {(d_inner, zcfg.d_model, d_inner // mp,
                         zcfg.d_model)}):
        raise AssertionError(f"(x)(4) zamba2 step {zb}")
    log(f"[x] (4) zamba2-2.7b, 12 of 54 layers at full width (the shared "
        f"block twice), float32, one step on (4, 32): loss "
        f"{zb['loss']:.6f}, rel err {zb['loss_err']:.3e} against the "
        f"plain step (1e-5), the largest gradient leaf's error over its "
        f"largest magnitude {zb['grad_err']:.3e} (1e-4); out_proj (whole, "
        f"local) while its layer runs {sorted(rows)}; the step's peak "
        f"allocated bytes a card {zb['peaks']}; {outs['ranks'][1]:.1f} s "
        f"(the ranks)")
    zb_want = held_to_dryrun("zamba2-2.7b", zcfg,
                             ShapeConfig("x4", 32, 4, "train"),
                             zb["counted"])
    for name, sv in rec["serve"].items():
        lim = X4_XLSTM_TOL["logits"] if name == "xlstm-125m" else 1e-5
        if sv["err"] > lim or sv["state_moves"]:
            raise AssertionError(f"(x)(4) {name} serving {sv}")
        log(f"[x] (4) {name}'s placed float32 prefill of (4, 32) and two "
            f"decode steps: logits within {sv['err']:.3e} of the plain "
            f"ones ({lim}); collectives {json.dumps(sv['by_axis'])}, none "
            f"of an mLSTM or mamba state ({sv['state_bytes']} bytes a "
            f"card)")
    return dict(rec, xlstm_sharded=sharded, xlstm_plain=plain,
                xlstm_rel_errs=errs, xlstm_dryrun=xl_want,
                zamba2_dryrun=zb_want, model_parallel=mp)


def x2_rank(out_dir: str, model_parallel: int) -> int:
    """(x)(2)'s counted qwen3-0.6b step and moonshot-v1-16b-a3b step as
    one process of ``torch.distributed.run``. First one train step of
    qwen3-0.6b whole (a (X_BATCH, X_SEQ) batch, bf16 compute, remat
    "dots", AdamW) on parameters placed over the process group's mesh,
    under ``CollectiveCounter``: process 0 writes ``qwen3.json`` with the
    collectives, the mesh and each card's peak allocated bytes. Then 2 of
    moonshot's 48 layers at full width, float32, the parameters and a
    (4, 32) batch placed, the loss and the gradients of one step (remat
    "dots"); process 0 takes the plain step on its card from the same
    parameters and batch (the MoE dispatch in as many groups) and writes
    both errors to ``moonshot.json``."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_train_step, remat_loss_fn,
                                              value_and_grad)

    train.start_process_group()
    mesh = make_host_mesh(model_parallel)
    sharding.set_activation_policy(mesh)
    out_dir = pathlib.Path(out_dir)

    # the counted qwen3-0.6b step
    cfg = get_config("qwen3-0.6b")
    opt = AdamWConfig()
    params = sharding.place(lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED)), mesh)
    state = init_opt_state(opt, params)
    batch = batch_for_step(cfg, ShapeConfig("x2", X_SEQ, X_BATCH, "train"),
                           0)
    batch = sharding.place(batch, mesh, sharding.batch_shardings(mesh, batch))
    step = make_train_step(cfg, opt, remat="dots")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counter = CollectiveCounter(mesh.device_mesh)
    with counter:
        out = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (peak, before))
    if dist.get_rank() == 0:
        summary = counter.summary()
        (out_dir / "qwen3.json").write_text(json.dumps({
            "mesh": list(mesh.devices.shape), "peaks": [p for p, _ in peaks],
            "before": [b for _, b in peaks], "bytes": summary["bytes"],
            "by_axis": summary["by_axis"],
            "loss": float(out[2]["loss"])}))
    del params, state, batch, out
    gc.collect()
    torch.cuda.empty_cache()      # the card's memory back to the others

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=2,
                              compute_dtype="float32")
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch = batch_for_step(cfg, ShapeConfig("x2", 32, 4, "train"), 0)
    loss, grads = value_and_grad(
        remat_loss_fn(cfg, "dots"), sharding.place(params, mesh),
        sharding.place(batch, mesh, sharding.batch_shardings(mesh, batch)))
    groups = sharding.data_group_size()
    grads = lm.tree_leaves(sharding.full_tensors(grads))
    loss = float(sharding.full_tensors(loss))
    want = None
    if dist.get_rank() == 0:
        # the plain step, its MoE dispatch grouped as the mesh groups it
        devs = np.empty(mesh.size, dtype=object)
        devs[:] = [torch.device("cuda", 0)] * mesh.size
        sharding.set_activation_policy(
            Mesh(devs.reshape(mesh.devices.shape), mesh.axis_names))
        want_loss, want = value_and_grad(remat_loss_fn(cfg, "dots"), params,
                                         batch)
        want = lm.tree_leaves(want)
        grad_err = max(float((a - b).abs().max()
                             / max(float(b.abs().max()), 1e-30))
                       for a, b in zip(grads, want))
        moon = {"loss": loss, "loss_err": abs(loss - float(want_loss))
                / abs(float(want_loss)), "grad_err": grad_err,
                "groups": groups, "leaves": len(want)}
        sharding.set_activation_policy(mesh)
    del grads, want
    gc.collect()
    torch.cuda.empty_cache()

    # the counted moonshot train step (AdamW, as the dry-run counts it):
    # its collectives, the expert stacks' local shards while the MoE layer
    # runs, each card's peak
    params = sharding.place(params, mesh)
    state = init_opt_state(opt, params)
    batch = sharding.place(batch, mesh, sharding.batch_shardings(mesh, batch))
    shards, gather = [], lm.gathered_but_experts

    def watched(tree):
        out = gather(tree)
        shards.extend((n, list(out[n].shape), list(out[n].to_local().shape))
                      for n in ("w_gate", "w_up", "w_down"))
        return out
    lm.gathered_but_experts = watched
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counter = CollectiveCounter(mesh.device_mesh)
    try:
        with counter:
            make_train_step(cfg, opt, remat="dots")(params, state, batch)
        torch.cuda.synchronize()
    finally:
        lm.gathered_but_experts = gather
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (torch.cuda.max_memory_allocated(), before,
                                   shards))
    if dist.get_rank() == 0:
        summary = counter.summary()
        (out_dir / "moonshot.json").write_text(json.dumps(dict(
            moon, mesh=list(mesh.devices.shape), peaks=[p[0] for p in peaks],
            before=[p[1] for p in peaks], shards=[p[2] for p in peaks],
            bytes=summary["bytes"], by_axis=summary["by_axis"])))
    sharding.set_activation_policy(None)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def x3_rank(out_dir: str) -> int:
    """(x)(3)'s placed deepseek-v3-671b step as one process of
    ``torch.distributed.run`` on four cards: 2 of its 61 layers at full
    width (``X3_CFG``), float32, its parameters drawn on each card from
    the seed of the plain forward and placed leaf by leaf (each card
    slicing its shards from its own draws, each whole leaf freed once
    placed: the whole tree, 56 GB, and its shards would not fit beside
    each other), the loss and the gradients of one step on a (4, 32)
    batch (remat "dots"). Process 0 writes ``deepseek.json``: the loss,
    whether every gradient leaf is finite, the expert stacks' local
    shards, each card's peak allocated bytes over the step and the step's
    seconds."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.train_step import remat_loss_fn, value_and_grad

    train.start_process_group()
    mesh = make_host_mesh(2)
    sharding.set_activation_policy(mesh)
    cfg = x3_config()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    specs = sharding.params_shardings(params, mesh)

    def place_freeing(tree, spec):
        for key in (tree if isinstance(tree, dict) else range(len(tree))):
            if isinstance(tree[key], (dict, list)):
                place_freeing(tree[key], spec[key])
                continue
            d = distribute_tensor(tree[key], mesh.device_mesh,
                                  sharding.spec_placements(spec[key], mesh),
                                  src_data_rank=None)
            # a copy of the local shard, so the whole leaf's storage goes
            tree[key] = DTensor.from_local(
                d.to_local().clone(), mesh.device_mesh, d.placements,
                run_check=False, shape=d.shape, stride=d.stride())
            del d
    place_freeing(params, specs)
    gc.collect()
    torch.cuda.empty_cache()
    batch = batch_for_step(cfg, ShapeConfig("x3", 32, 4, "train"), 0)
    batch = sharding.place(batch, mesh, sharding.batch_shardings(mesh, batch))
    local = [list(params["layers"]["moe"][n].to_local().shape)
             for n in ("w_gate", "w_up", "w_down")]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(g.to_local()).all())
                 for g in lm.tree_leaves(grads))
    loss = float(sharding.full_tensors(loss))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (peak, before, finite, local))
    if dist.get_rank() == 0:
        (pathlib.Path(out_dir) / "deepseek.json").write_text(json.dumps({
            "mesh": list(mesh.devices.shape), "loss": loss,
            "finite": [g[2] for g in got], "local": [g[3] for g in got],
            "peaks": [g[0] for g in got], "before": [g[1] for g in got],
            "leaves": len(lm.tree_leaves(grads)), "seconds": seconds}))
    sharding.set_activation_policy(None)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def x4_rank(out_dir: str, model_parallel: int) -> int:
    """(x)(4)'s placed steps as one process of ``torch.distributed.run``:
    a counted train step of xlstm-125m whole ((X_BATCH, X_SEQ), bf16,
    dots, AdamW) and a second one timed beside a plain step on card 0;
    zamba2-2.7b at 12 of 54 layers (``x4_zamba2_config``), float32, the
    loss and gradients of one step on a (4, 32) batch against the plain
    step (process 0), each card's ``out_proj`` shard while its layer
    runs, then a counted train step of it (AdamW); a placed float32
    prefill of (4, 32) and two decode steps of each against the plain
    ones, their collectives counted. Process 0 writes ``x4.json``."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_train_step, remat_loss_fn,
                                              value_and_grad)

    train.start_process_group()
    mesh = make_host_mesh(model_parallel)
    sharding.set_activation_policy(mesh)
    rank0 = dist.get_rank() == 0
    devs = np.empty(mesh.size, dtype=object)
    devs[:] = [torch.device("cuda", 0)] * mesh.size
    plain_mesh = Mesh(devs.reshape(mesh.devices.shape), mesh.axis_names)
    opt = AdamWConfig()
    rec = {"mesh": list(mesh.devices.shape)}

    def gathered(values):
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, values)
        return got

    def counted_step(cfg, params, batch):
        """One counted train step on ``params`` placed: the collectives,
        each card's peak and the bytes allocated before it."""
        params = sharding.place(params, mesh)
        state = init_opt_state(opt, params)
        batch = sharding.place(batch, mesh,
                               sharding.batch_shardings(mesh, batch))
        step = make_train_step(cfg, opt, remat="dots")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counter = CollectiveCounter(mesh.device_mesh)
        with counter:
            out = step(params, state, batch)
        torch.cuda.synchronize()
        peaks = gathered((torch.cuda.max_memory_allocated(), before))
        summary = counter.summary()
        return {"peaks": [p for p, _ in peaks],
                "before": [b for _, b in peaks], "bytes": summary["bytes"],
                "by_axis": summary["by_axis"],
                "loss": float(out[2]["loss"])}, (step, out, batch)

    def step_against_plain(cfg, params, batch):
        """The loss and gradients of one placed step (remat "dots")
        against the plain step's on card 0 (process 0): the loss's
        relative error and the largest gradient leaf's error over its
        largest magnitude."""
        loss, grads = value_and_grad(
            remat_loss_fn(cfg, "dots"), sharding.place(params, mesh),
            sharding.place(batch, mesh,
                           sharding.batch_shardings(mesh, batch)))
        grads = lm.tree_leaves(sharding.full_tensors(grads))
        torch.cuda.synchronize()
        out = {"loss": float(sharding.full_tensors(loss)),
               "peak": torch.cuda.max_memory_allocated()}
        if rank0:
            sharding.set_activation_policy(plain_mesh)
            want_loss, want = value_and_grad(remat_loss_fn(cfg, "dots"),
                                             params, batch)
            sharding.set_activation_policy(mesh)
            out["grad_err"] = max(float((a - b).abs().max()
                                        / max(float(b.abs().max()), 1e-30))
                                  for a, b in zip(grads,
                                                  lm.tree_leaves(want)))
            out["loss_err"] = (abs(out["loss"] - float(want_loss))
                               / abs(float(want_loss)))
        return out

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # xlstm-125m whole: the counted step, then a second step timed beside
    # the plain one
    cfg = get_config("xlstm-125m")
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch = batch_for_step(cfg, ShapeConfig("x4", X_SEQ, X_BATCH, "train"),
                           0)
    rec["xlstm"], (step, out, placed_batch) = counted_step(cfg, params,
                                                          batch)
    rec["xlstm"]["placed_ms"] = synced_ms(
        lambda: step(out[0], out[1], placed_batch))
    del step, out, placed_batch
    if rank0:
        sharding.set_activation_policy(plain_mesh)
        state = init_opt_state(opt, params)
        step = make_train_step(cfg, opt, remat="dots")
        p, state, _ = step(params, state, batch)
        rec["xlstm"]["plain_ms"] = synced_ms(lambda: step(p, state, batch))
        del p, state, step
        sharding.set_activation_policy(mesh)
    xlstm_params = params

    # xlstm-125m whole in float32: one step's loss and gradients against
    # the plain step's
    fcfg = dataclasses.replace(cfg, compute_dtype="float32")
    fbatch = batch_for_step(fcfg, ShapeConfig("x4", 32, 4, "train"), 0)
    rec["xlstm_f32"] = step_against_plain(fcfg, params, fbatch)
    gc.collect()
    torch.cuda.empty_cache()

    # zamba2-2.7b at 12 of 54 layers: the step against the plain one, the
    # out_proj shards while the layers run
    cfg = x4_zamba2_config()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch = batch_for_step(cfg, ShapeConfig("x4", 32, 4, "train"), 0)
    shards, gather = [], lm.gathered_over_data

    def watched(tree):
        res = gather(tree)
        t = res["cell"]["out_proj"] if isinstance(res, dict) \
            and "cell" in res else None
        if isinstance(t, DTensor):         # not the plain step's
            shards.append(tuple(t.shape) + tuple(t.to_local().shape))
        return res
    lm.gathered_over_data = watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        zb = step_against_plain(cfg, params, batch)
    finally:
        lm.gathered_over_data = gather
    got = gathered((zb.pop("peak"), sorted(set(shards))))
    zb["peaks"] = [g[0] for g in got]
    zb["out_proj"] = [g[1] for g in got]
    gc.collect()
    torch.cuda.empty_cache()
    zb["counted"], _ = counted_step(cfg, params, batch)
    rec["zamba2"] = zb
    gc.collect()
    torch.cuda.empty_cache()

    # a placed float32 prefill and two decode steps of each against the
    # plain ones; no collective may move an mLSTM or mamba state
    rec["serve"] = {}
    xcfg = dataclasses.replace(get_config("xlstm-125m"),
                               compute_dtype="float32")
    for name, scfg, sparams in (("xlstm-125m", xcfg, xlstm_params),
                                ("zamba2-2.7b", cfg, params)):
        toks = torch.tensor(np.random.default_rng(SEED).integers(
            0, scfg.vocab, (4, 34)), device="cuda")

        def serve(placed):
            caches = lm.init_caches(scfg, 4, 40, dtype=torch.float32)
            ps = sparams
            if placed:
                ps = sharding.place(sparams, mesh)
                caches = sharding.place(caches, mesh, sharding
                                        .cache_shardings(mesh, caches))
            logits = []
            for lo, hi in ((0, 32), (32, 33), (33, 34)):
                b = {"tokens": toks[:, lo:hi]}
                if placed:
                    b = sharding.place(b, mesh,
                                       sharding.batch_shardings(mesh, b))
                with torch.no_grad():
                    lg, caches = lm.forward(scfg, ps, b, caches)
                logits.append(sharding.full_tensors(lg))
            return logits
        # a layer's mLSTM or mamba state: the collectives issued while
        # any tensor of its shape is redistributed (the only way the
        # layers move a cache) are recorded apart
        if name == "xlstm-125m":
            hd = 2 * scfg.d_model // scfg.n_heads
            state = (4, scfg.n_heads, hd, hd)
        else:
            h = scfg.ssm_expand * scfg.d_model // scfg.ssm_headdim
            state = (4, h, scfg.ssm_state, scfg.ssm_headdim)
        moves, redistribute = [], DTensor.redistribute

        def watched_redistribute(self, *args, **kwargs):
            if tuple(self.shape) != state:
                return redistribute(self, *args, **kwargs)
            with CollectiveCounter(mesh.device_mesh) as inner:
                out = redistribute(self, *args, **kwargs)
            moves.extend(inner.records)
            return out
        counter = CollectiveCounter(mesh.device_mesh)
        DTensor.redistribute = watched_redistribute
        try:
            with counter:
                got = serve(True)
        finally:
            DTensor.redistribute = redistribute
        sv = {"by_axis": {k: (v["calls"], v["bytes"]) for k, v in
                          counter.summary()["by_axis"].items()},
              "state_bytes": int(np.prod(state)) * 4 // mesh.size,
              "state_moves": moves}
        if rank0:
            sharding.set_activation_policy(plain_mesh)
            want = serve(False)
            sharding.set_activation_policy(mesh)
            sv["err"] = max(float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(got, want))
        rec["serve"][name] = sv
        del got
    if rank0:
        (pathlib.Path(out_dir) / "x4.json").write_text(json.dumps(rec))
    sharding.set_activation_policy(None)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def x3_plain_run(card=None) -> dict:
    """(x)(3)'s plain forward in a process of its own (``--x3-plain``), on
    ``card`` where given (``CUDA_VISIBLE_DEVICES``), else on ``cuda:0``;
    returns its record."""
    import os
    import tempfile

    env = dict(os.environ)
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp, "plain.json")
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--x3-plain",
             str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        if proc.returncode:
            raise AssertionError(f"(x)(3) plain forward exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        return dict(json.loads(path.read_text()), plain_card=card or 0)


def x3_plain(out_path: str) -> int:
    """(x)(3)'s plain forward on one card (``x3_config``, a (4, 32) batch,
    the MoE dispatch in the groups of a (2, 2) mesh), the parameters drawn
    from the placed step's seed: writes its loss, ms, parameter count,
    seconds to draw them and peak allocated bytes to ``out_path``."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as lm

    cfg = x3_config()
    live = torch.cuda.memory_allocated()
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cuda", 0)] * 4
    sharding.set_activation_policy(Mesh(devs.reshape(2, 2),
                                        ("data", "model")))
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch = batch_for_step(cfg, ShapeConfig("x3", 32, 4, "train"), 0)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(lm.loss_fn(cfg, params, batch))
    torch.cuda.synchronize()
    pathlib.Path(out_path).write_text(json.dumps({
        "plain_loss": loss,
        "plain_forward_ms": (time.perf_counter() - t0) * 1e3,
        "params": sum(t.numel() for t in lm.tree_leaves(params)),
        "plain_built_s": built_s,
        "plain_peak": torch.cuda.max_memory_allocated(),
        "live_before": live}))
    return 0


def x3_config():
    """(x)(3)'s deepseek-v3-671b: 2 of 61 layers at full width (one dense
    layer with its MLA and d_ff 18,432, one MoE layer of 256 experts,
    top-8, and its shared expert), float32 compute."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=2,
                               first_dense_layers=1, compute_dtype="float32")


def phase_x_alone() -> int:
    """``--phase-x``: phase (x) alone, for a host with several cards. (m)'s
    and (d2)'s operands are drawn afresh at their shapes and densities,
    their single-device results and warm ms taken on ``cuda:0``
    (``shard_lanes=False``) before (x) runs."""
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr
    from repro_torch.kernels import _build

    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {smi[0]}")
    rng = np.random.default_rng(SEED)
    workloads, per_phase, runs = {}, {}, {}
    for tag, label, n, density, par in (
            ("m", "SpMSpM 4096 lanes", 4096, 0.005, {"i": 4}),
            ("d2", "SpMSpM 1024 ikj", 1024, 0.01, {})):
        arrays = {t: sparse_int(rng, (n, n), density) for t in "BC"}
        want = (sp.csr_matrix(arrays["B"])
                @ sp.csr_matrix(arrays["C"])).toarray()
        eng = compile_expr("X(i,j) = B(i,k) * C(k,j)",
                           Format({"B": "cc", "C": "cc"}),
                           Schedule(loop_order=("i", "k", "j"), split=par,
                                    parallelize=par),
                           {"i": n, "j": n, "k": n}, shard_lanes=False)
        single = tree_to_dense(eng(arrays))
        check_equal(f"({tag}) on one card", single, want)
        workloads[label] = {"warm_ms": warm_ms(lambda: eng(arrays), reps=3)}
        runs[tag] = (arrays, want, single)
    phase_x(runs["m"], runs["d2"], workloads, per_phase)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "phase_x.json").write_text(json.dumps(
        {"nvidia_smi": smi, "workloads": workloads,
         "launches_by_phase": per_phase}, indent=1))
    log("\n".join(smi))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def log_w_lm_cell(rec) -> None:
    """Logs one (w)(2) record (``dryrun.main``'s); fails the phase unless
    its FLOPs are counted and its arguments fit the card."""
    arch, shape = rec["arch"], rec["shape"]
    mem, r = rec["mem_per_device"], rec["roofline"]
    detail = r["collective_detail"]
    wires = {k: v["wire"] for k, v in detail.get("by_axis", {}).items()}
    coll = (f"collective {r['t_collective']:.4e} s "
            f"({r['collective_bytes_per_device']:.6e} wire bytes a device: "
            f"{json.dumps(detail['bytes_by_op'])}; by op and axis "
            f"{json.dumps(wires)})"
            if r["t_collective"] is not None else
            f"collective none (placement refused at "
            f"{r['collective_detail']['refused']})")
    log(f"[w] (2) {arch} x {shape} on {rec['n_devices']} devices: "
        f"flops {rec['flops']:.6e}, useful "
        f"{rec['useful_flop_ratio']:.4f}, arguments "
        f"{mem['argument_bytes']} bytes a device "
        f"({mem['argument_bytes'] / mem['hbm_bytes']:.4f} of 80 GB), "
        f"compute {r['t_compute']:.4e} s, memory "
        f"{r['t_memory']:.4e} s, {coll} a device at the H100's "
        f"rates ({r['bottleneck']})")
    if not (rec["flops"] > 0 and mem["fits"]):
        raise AssertionError(f"(w)(2) {rec}")


# (w)(2)'s SSM and hybrid cells, counted in host processes of their own
# and read at the end of (x): (arch, shape, ``dryrun`` mesh flags).
# xlstm-125m's sLSTM scan is counted op by op (about 300 s for the cell's
# FLOPs and bytes and 250 s a mesh on the host), so its meshes get a
# process each
W_SSM_CELLS = {"zamba2": [("zamba2-2.7b", "train_4k", ["--both-meshes"]),
                          ("zamba2-2.7b", "decode_32k", [])],
               "xlstm": [("xlstm-125m", "train_4k", [])],
               "xlstm-multi-pod": [("xlstm-125m", "train_4k",
                                    ["--multi-pod"])]}


def w_ssm_counts(group: str, out_path: str) -> int:
    """(w)(2)'s cells of ``W_SSM_CELLS[group]`` on the host: each
    ``dryrun.main`` record and the seconds it took, to ``out_path``."""
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(2)
    cells, t0 = [], time.perf_counter()
    for arch, shape, meshes in W_SSM_CELLS[group]:
        cells += dryrun.main(["--arch", arch, "--shape", shape] + meshes)
    pathlib.Path(out_path).write_text(json.dumps(
        {"cells": cells, "seconds": time.perf_counter() - t0}))
    return 0


def read_w_ssm() -> list:
    """(w)(2)'s SSM and hybrid cells from their host processes (started
    after (a)): logged, and their records returned."""
    cells = []
    for group, (proc, path) in W_SSM_PROCS.items():
        out, err = proc.communicate(timeout=900)
        (ROOT / "chiprun_out" / f"w_ssm_{group}.log").write_text(
            out + "\n--- stderr\n" + err)
        if proc.returncode:
            raise AssertionError(f"(w)(2) {group} exited {proc.returncode} "
                                 f"(its output in chiprun_out/"
                                 f"w_ssm_{group}.log): {err[-3000:]}")
        got = json.loads(path.read_text())
        for rec in got["cells"]:
            log_w_lm_cell(rec)
        cells += got["cells"]
        log(f"[w] (2) the {group} cells counted in {got['seconds']:.1f} s "
            f"on the host, beside (b)-(x)")
    return cells


def w_lm_counts(out_path: str) -> int:
    """(w)(2) and (3) in a process of their own: the LM dry-run of
    qwen3-0.6b's four shapes and deepseek-v3-671b x train_4k on both
    production meshes, each placed again for its collective term
    (``--all`` counts xlstm-125m's sLSTM scan op by op: minutes on the
    host), and the probe sweep of qwen3-0.6b x train_4k; their records
    and seconds written to ``out_path``."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun, roofline_sweep

    torch.set_num_threads(2)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    cells = []
    for arch, shape in ([("qwen3-0.6b", n) for n in SHAPES]
                        + [("deepseek-v3-671b", "train_4k")]):
        cells += dryrun.main(["--arch", arch, "--shape", shape,
                              "--both-meshes"])
    lm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = roofline_sweep.main([
        "--arch", "qwen3-0.6b", "--shape", "train_4k",
        "--json", str(ROOT / "chiprun_out" / "w_roofline.json")])[0]
    pathlib.Path(out_path).write_text(json.dumps({
        "cells": cells, "lm_s": lm_s, "probe": probe,
        "probe_s": time.perf_counter() - t0}))
    return 0


def _stop_background() -> None:
    for proc in W_LM_PROC + [p for p, _ in W_SSM_PROCS.values()]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--w-lm"]:
        sys.exit(w_lm_counts(sys.argv[2]))
    if sys.argv[1:2] == ["--w-ssm"]:
        sys.exit(w_ssm_counts(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--x2-ranks"]:
        sys.exit(x2_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--x3-ranks"]:
        sys.exit(x3_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--x4-ranks"]:
        sys.exit(x4_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--x3-plain"]:
        sys.exit(x3_plain(sys.argv[2]))
    if sys.argv[1:] == ["--phase-x"]:
        sys.exit(phase_x_alone())
    try:
        code = main()
    finally:
        _stop_background()
    sys.exit(code)
