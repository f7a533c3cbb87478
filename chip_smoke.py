#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Drives the port's main paths end to end, through the entry points a user
calls, and fails (non-zero exit) if any phase fails:

1. environment: the card's name and power limit, CUDA, nvcc;
2. build: every kernel source from this checkout (``gemm``, ``symm``,
   ``rank_k``, ``rank_k_packed``, ``trmm``, ``trmm_packed``, ``trsm``), all
   nvcc runs started together, with nvcc's ``-Xptxas -v`` report
   (registers, shared memory, spills).  Fails if any instantiation of the
   kernels spills, or if the launch parameters they were built with
   (threads, stages, shared bytes, passes; trsm's inverse kernel and
   workspace too) or the GEMM's split-k plan differ from their Python
   mirrors (``kernels/gemm.py::mainloop_params``, ``split_plan``,
   ``kernels/syrk.py::rank_k_params``, ``kernels/trsm.py::trsm_params``);
3. kernel vs oracle: every kernel under every candidate of its Hopper knob
   space against a float64 oracle, held to ``F32_TOL`` (tighter than the
   reference conformance harness's 5e-4, so that a TF32 product fails it):
   the GEMM on ragged, aligned and decode (split-k) shapes, ``alpha``/``beta``
   with C, stacks with per-item and shared B, and operands with unaligned
   leading strides equal bit for bit to aligned copies of the same values;
   symm, syrk/syr2k, trmm (every variant) and trsm through the port's
   conformance harness on its ragged dims and one aligned shape, with and
   without C, single and stacked (the error taken
   relative to ``conformance.error_scale``: the largest output, floored
   for a 1 x 1 syr2k whose one dot product may cancel).  Stacked results
   must equal per-item results bit for bit, and syrk/syr2k/trmm
   ``tri_packed`` must equal ``tri`` bit for bit.  trmm under every knob on
   operands with unaligned leading strides must equal aligned copies bit
   for bit, and an A with NaN everywhere above its diagonal must give the
   bits of an A with zeros there, on both copy paths.  syrk and syr2k under
   every knob, single and stacked: unaligned == aligned strides and masked
   == zero-padded operands bit for bit, and ``tri``/``tri_packed`` outputs
   symmetric bit for bit.  trsm's two kernels under every knob, single and
   stacked: ``trsm_inv`` with ``tril(D_i) D_i^-1 = I`` and within
   ``F32_TOL`` of ``diag_inverses_plain``, ``trsm`` within ``F32_TOL`` of
   ``substitute_plain`` fed the same inverses, each stack equal to its items
   bit for bit.  Then the structural
   contracts: ``run_op`` equals the padded run (``kernels/padded_ref.py``)
   bit for bit for gemm, symm, syrk, syr2k and trmm under every variant at
   ragged and one-row dims and, for the GEMM, a split-k shape (trsm within
   1e-5), with no copy op on its
   dispatch path (trsm: no pad), and every launch's recorded grid equals
   ``introspect.full_grid_for``/``packed_grid_for``, ``tri_packed``
   launching fewer blocks than ``tri``;
4. install: ``repro_torch.launch.calibrate`` times the kernels on the card
   and persists ``hopper__{gemm,symm,syrk,syr2k,trmm,trsm}_b4.adsala`` into
   a temporary registry; then the prewarm: every model phase's decision
   keys harvested on the meta device at that phase's shapes
   (``roofline/harvest.py``), the GEMM knob space pruned by the H100
   oracle at them (a reading), the oracle's Spearman rank correlation with
   the install's labels per op (a reading), the registry's decision cache
   prewarmed with every key, and ``scripts/torch_prewarm_model.py --timer
   wallclock`` for llama3-8b into a registry of its own, which must exit
   0;
5. serve: a fresh process loads those artifacts into a new
   ``AdsalaRuntime`` and calls ``run_op``: the GEMMs of the llama3-8b
   linears (d_model 4096, 8 KV heads x 128, d_ff 14336) at 8 and 2048
   tokens and one serving bucket with a shared weight; and the operations
   of a Shampoo-style preconditioner of its (4096, 14336) MLP weight G:
   ``syrk`` for L = G G^T and R = G^T G (each as an update
   ``0.05 * G G^T + 0.95 * L`` of the last one), ``symm`` of a (4096, 4096)
   sym(A) against G, ``syr2k`` at (4096, 4096), ``trmm`` of its Cholesky
   factor tril(L) (4096, 4096) against G (whitening G with a triangular
   factor), ``trsm`` of a (4096, 4096) tril(A) against G, and one stacked
   (8, 512, 512) call per op.  Every decision must come from the model,
   every call must launch exactly the kernels its knob names (trsm: one
   ``trsm_inv`` and one ``trsm``, no GEMM) and every result must be within
   ``F32_TOL`` of the plain version.  Then syrk runs the L = G G^T call and
   the stacked call, syr2k its big and its stacked call, and trmm both its
   calls, once under each variant with the tile the model chose (a caller
   that pins the variant through ``run_op(..., knob=...)``), which must
   give tri_packed == tri bit for bit.  Last, a
   ``BlasService`` on the card under the same runtime: 4 client threads
   submit 192 requests together (32 of each op at the preconditioner-block
   shape), one warm-up window and then 5 timed ones, every future within
   ``F32_TOL`` of the plain version of its request, the recorded launches
   equal to the buckets executed, mean batch above 1, no failure;
   requests/s through the service against one ``run_op`` per request, in
   windows alternated with the service's, as median, min and max.  Then
   the retune phase on a copy of the registry: the same traffic through a
   ``BlasService`` with a ``Retuner`` of the default ``RetuneConfig`` (the
   reference's thresholds; each served point anchors its drift signal on
   its first 3 samples), ``step()`` after each window, 12 windows after
   the cold one that may read no drift, each op's probes printed against
   the install's own timer and the installed model; the served GEMM knob's
   time x 4 fed as telemetry, which one ``step()`` must detect, refit,
   save under the next artifact version and swap, the decisions after it
   equal to a fresh runtime loading the saved artifact and the new knob's
   kernel within ``F32_TOL`` of its plain version; the drift readings
   under a co-tenant matmul.  Then the fleet phase: a ``FleetService`` of
   2 executor processes on the card (spawned) over the artifacts in this
   host's fingerprint sub-registry, the same traffic, every result equal
   to the in-process ``run_op`` bit for bit, every executor's resolution
   naming this card, a warm join with no model evaluation, an executor
   SIGKILLed and respawned with no future lost, and requests/s of the
   fleet, the in-process service and one ``run_op`` each, alternated;
6. model: another fresh process loads the installed ``hopper__gemm_b4``
   artifact into a new ``AdsalaRuntime``, builds llama3-8b at full width
   and depth (32 layers, 8,030,261,248 float32 parameters) on the card
   from a seed, routed (``use_pallas_gemm=True``), and serves 4 requests
   of 128 prompt tokens, 32 new tokens greedy, through
   ``ServeSession.generate`` (one prefill and 32 decode steps).  It fails
   unless that generate launches the GEMM kernel 225 x 33 = 7,425 times
   (7 linears a block and the LM head, every pass) and nothing else,
   every decision comes from the prewarmed cache (no model evaluation,
   no default, every call a cache hit, the keys asked for equal to the
   harvested ones, each cached knob the installed model's own argmin
   decided afresh), and, over a prefill
   and 4 decode steps teacher-forced on the plain model's greedy tokens,
   every GEMM call of the routed run lies within ``F32_TOL`` of
   ``torch.matmul`` on its operands (TF32-rounded operands above it),
   every layer, routed and plain on the plain run's captured input and a
   copy of its cache, and the final norm and LM head on its captured
   final hidden state, lie within ``F32_TOL`` of their plain versions
   (TF32-rounded weights above it), and the logits
   of those passes lie within ``MODEL_TOL`` of the plain version (the
   unrouted config: ``torch.matmul``, TF32 off) while TF32-rounded
   weights do not.  It prints the plain model's own float32 noise floor
   (the same passes, each layer's and the head's, with every weight the
   GEMM reads one ulp up); where the logits' floor lies above
   ``MODEL_TOL``, the logits are held to ``FLOOR_FACTOR`` times it, and
   the layers and the head judge the kernel.  It prints the prefill's
   time and
   tokens/s, the median decode step, the host's time per step, the device
   profile of one prefill and 4 decode steps (the GEMM kernel's share,
   the top operations, the device's idle share), the greedy tokens of the
   routed and the plain run, and the reckoning from the config (bytes a
   decode step reads, as launched, the prefill's operations, the KV
   cache);
6b. the MoE model: a third fresh process, after phase 6's has exited,
   loads the installed ``hopper__gemm_b4`` artifact into a new runtime and
   serves deepseek-v2-lite-16b at full width and depth (27 layers: MLA,
   a dense first layer, 26 MoE layers of 64 experts top-6 and 2 shared;
   15,706,484,224 float32 parameters) the same 4 x 128 prompt tokens, 32
   new, greedy.  It fails unless that generate launches the GEMM kernel
   268 + 32 x 241 = 7,980 times (counted from the config: MLA's 4 linears
   at the prefill and 3 at a decode step, the dense MLP's 3, each MoE
   layer's 3 expert stacks, one launch each over all 64 experts, and 3
   shared linears, and the LM head) and nothing else, every decision
   comes from the installed model, each MoE layer routed is within
   ``F32_TOL`` of its plain version on the same captured input (prefill
   and 4 steps, teacher-forced), and the logits lie within ``MODEL_TOL``
   of the plain version (einsum and ``torch.matmul``, TF32 off) with the
   TF32-rounded weights (the linears and the expert tensors) above it, or
   differ only where the routed and plain runs chose other experts by a
   near tie (a gap under ``NEAR_TIE`` of the top probability).  It prints
   what phase 6 prints, the routing flips with their gaps, the profiles'
   GEMM time of the expert stacks apart from the other linears, and the
   expert stacks at the decode and prefill shapes against their plain
   version, ``torch.bmm`` and the bound;
6c. the hybrid model: a fourth fresh process serves zamba2-1.2b at full
   width and depth (38 Mamba2 blocks, 36 of them in 6 ``zamba_super``
   blocks that each end in the one shared attention + MLP block;
   1,220,805,504 float32 parameters) the same requests.  It fails unless
   the generate launches the GEMM kernel 125 + 32 x 125 = 4,125 times
   (each Mamba2 block's in_proj and out_proj, each super's in_proj and
   the shared block's 7 linears, the LM head) and nothing else, every
   decision comes from the installed model, and the calls, layers, head
   and logits are held as in phase 6.  Its ``[ssm]`` line reads the
   chunked prefill against the same prompt fed token by token through
   ``decode_step`` (the reference's -30 clamp of the running log-decay;
   printed, not gated);
6d. the SSM model: a fifth fresh process serves rwkv6-1.6b at full width
   and depth (24 RWKV6 layers, 1,615,497,216 float32 parameters) the same
   way: 193 + 32 x 193 = 6,369 GEMM launches (8 linears a layer, the LM
   head; the LoRA products stay plain), and its ``[ssm]`` line.  Its
   logits' noise floor lies far above ``MODEL_TOL``: past the clamp the
   per-head norm scales heads of small variance up to the others', and
   their rounding with them, so float32 rounding grows about twofold a
   layer.  Both recurrent phases print that floor again with the clamp
   out of reach;
6e. the audio model: a sixth fresh process serves whisper-medium at full
   width and depth (24 ``"enc"`` blocks, bidirectional, and 24
   ``"dec_cross"`` blocks, causal self-attention with a KV cache and
   cross-attention to the encoder's output, no RoPE, sinusoid positions;
   810,987,520 float32 parameters) the same requests, each with stub frame
   embeddings (1,500 frames).  The session runs the encoder once and
   decodes token t at its true position 128 + t.  It fails unless the
   generate launches the GEMM kernel 144 + 241 + 32 x 241 = 8,097 times
   (the encoder's 6 linears a block once; 10 a decoder block, the
   cross-attention's K and V projected from the encoder's output at every
   pass, and the LM head) and nothing else; the calls, layers (the
   encoder's blocks too, on their captured inputs), head and logits are
   held as in phase 6.  It prints the cross K and V projections' device
   time a decode step against the step's GEMM time, and the encoder's
   device time alone (its GEMM apart);
6f. the VLM: a seventh fresh process serves internvl2-76b at full width
   and a cut depth (16 of its 80 layers: the 80 are 282.48 GB of float32
   weights; the 16 with the embedding, head and vision projection
   15,858,933,760 parameters, 63.44 GB) the same requests, each with 256
   stub patch embeddings that the vision projection, one GEMM launch,
   puts ahead of the prompt.  It fails unless the generate launches the
   GEMM kernel 114 + 32 x 113 = 3,730 times and nothing else; the calls,
   layers, head and logits are held as in phase 6;
8. training (``launch/train.py``'s ``TrainLoop``, ``optim``, ``data``,
   ``checkpoint``, ``distributed/fault_tolerance.py``), in fresh processes
   once phase 6f's has exited.  The training step routes nothing through
   the hand-written kernels (the GEMM has no backward; the reference
   trains unrouted too), so its matmuls are ``torch.matmul``.
   8a: every architecture's smoke config takes 2 ``step_fn`` steps on the
   card; every loss and gradient finite, every parameter moved.
   8b: llama3-8b at full width and 2 layers, float32 with TF32 off, one
   8 x 128 batch: the loss and every parameter's gradient against a
   float64 copy of the same weights on the card, within 1e-5 (loss,
   relative) and 1e-4 (each gradient's max error over its max value).
   8c: llama3-8b at full width and 12 of its 32 layers (``TRAIN_CUTS``)
   at its own numerics (bf16 compute, remat ``nested``, ``ce_chunk``
   2048), 8 steps of 8 x 128 tokens from ``SyntheticLMDataset`` at
   ``launch/train.py``'s defaults: every loss and gradient norm finite,
   the first loss within 1.0 of ln 128256, every parameter moved, no
   hand-written kernel launched, the peak memory under the card's; it
   prints the step's ms and tokens/s, the model TFLOP/s against the
   dense bf16 peak, the optimiser's and the clip's device time and the
   device's idle share from a profiled step, and the peak memory.
   8d (another process, deterministic algorithms): the example's reduced
   config through ``TrainLoop.run`` preempted at step 6, restored and run
   to step 10, against 10 steps uninterrupted: the restored state, every
   loss and the final parameters bit for bit.  Beside it (a process of
   its own, untimed) ``examples/torch_train_lm.py`` (300 steps) on the
   card must exit 0 with its loss dropping;
9. training under a mesh, in a fresh process after phase 8's: a world of
   one under NCCL (``distributed/world.py::init_world``) and the (1, 1)
   ("data", "model") mesh ``best_mesh`` gives it, the parameters
   DTensors laid out by ``param_specs`` and each batch sharded by
   ``make_global_batch``.  9a: llama3-8b at full width and 2 layers,
   float32 with TF32 off, one 8 x 128 batch: one ``TrainLoop`` step under
   the mesh against one unsharded step from the same weights, the loss
   within 1e-6 relative and each gradient (as the optimiser reads it)
   within 1e-6 of its max |g|; it prints whether the two are bit-equal.
   9b: llama3-8b at the depth of ``TRAIN_CUTS`` at its own numerics, 4
   steps of 8 x 128 under the mesh: every loss finite, the first within
   1.0 of ln V, every parameter moved, no hand-written kernel launched,
   the peak memory under the card's; its step ms and tokens/s are printed
   beside 8c's (DTensor's host cost).  9c: the llama3 smoke config's
   state saved under the mesh restores into the unsharded ``TrainLoop``,
   and one saved by that loop restores under the mesh, both bit for bit;
10. the dry run (``launch/dryrun.py``, ``roofline/``).  10a, in phase 9's
   process on its mesh: 9b's model and batch counted twice by
   ``roofline/counting.py::count_step``, once as the dry run's step on
   fake DTensors (nothing allocated) and once as a real ``step_fn`` step
   on the card (untimed): the FLOPs equal, the dry run's peak bytes within
   0.8x-1.25x of ``max_memory_allocated`` of a real step, and the
   measured step (median of 3 after a warm-up) not below the roofline's
   ``max(t_compute, t_memory)`` of the dry count.  10b, in a fresh
   process after phase 7, the last timed phase, so that no timed phase
   shares the host with its work on fake tensors: the
   production cells of ``DRYRUN_CELLS`` at full depth on fake worlds of 256
   and 512 ranks over the card's device type, each ``ok``, with their
   peak bytes a rank, FLOPs, bytes and collective bytes a rank, the three
   terms, the bottleneck, ``useful_ratio`` and the collectives by kind.
   10c, after 10b in its process: the ``cpu_blocked`` backend's gemm
   install at precisions s and d on the host CPU (named from
   ``/proc/cpuinfo``), and its tuned knob against its default on held-out
   dims;
7. times (CUDA events) of every served call: the kernel under the tuned and
   the default knob and under the best knob of a sweep of its whole space,
   the plain version, a library call the port never makes (``torch.matmul``,
   ``torch.addmm``, ``torch.linalg.solve_triangular``) and the float32
   bound of the card; for each call (the pinned variants too) also its rate
   (TFLOP/s, or GB/s when bytes bound it), its share of the bound and, for
   the GEMM, the split-k plan it launched; for each trsm call its two
   kernels apart (each against its plain version, and ``trsm_inv`` against
   ``solve_triangular`` of the diagonal blocks against I, those three as
   device times from ``torch.profiler``: the inverses take less than their
   call's host time); and
   the host's time per call of the GEMM wrapper against ``torch.matmul``
   at a product too small to time the card.

The launch counts come from ``repro_torch.kernels.introspect``: each path
(the ``run_op`` calls, the service, each model's generate) is driven with
the counts set to 0 just before it and read just after; launches made by
the comparisons of phase 3 and the models' checks do not count.  Phases
8c and 9b read them around their training steps, which must launch none.

Run from the root of a checkout on a machine with the card:
``python3 chip_smoke.py``.  The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times.

``python3 -u chip_smoke.py --repeat-checks N`` runs phases 1 and 2 and then
phase 3 N times, each repeat under a 120 s watchdog that prints every
thread's stack and exits if it trips: a stress run of the checks, which
prints no result line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

#: the kernel sources of the main paths, built side by side
KERNEL_SOURCES = ("gemm", "symm", "rank_k", "rank_k_packed", "trmm",
                  "trmm_packed", "trsm")

#: the reference conformance harness's ragged GEMM dims
#: (src/repro/backends/conformance.py RAGGED_DIMS["gemm"]) and one aligned
KERNEL_DIMS = ((129, 65, 257), (1, 300, 384), (300, 300, 300),
               (256, 512, 384), (8, 4096, 1024))
#: GEMM dims run on operands with unaligned leading strides (the kernel's
#: 4-byte copies), held bit for bit against aligned copies of the values:
#: ragged, and a decode shape that splits k
UNALIGNED_DIMS = ((129, 256, 384), (8, 4096, 1024))
#: one aligned shape beside RAGGED_DIMS for the 2-dim ops
ALIGNED_2D = (256, 384)
#: trmm dims run on operands with unaligned leading strides and on an A
#: with NaN above its diagonal: ragged, and the aligned shape (16-byte
#: copies when the strides allow them)
TRMM_PATH_DIMS = ((129, 257), ALIGNED_2D)
#: syrk/syr2k (n, k) run on unaligned and on zero-padded operands: ragged
#: (k not a multiple of 4: the 4-byte copies), one row, and aligned
RANK_K_PATH_DIMS = ((129, 65), (1, 384), ALIGNED_2D)
STACK = 3
#: max relative error (to the largest output) of the kernel vs a float64
#: oracle and of a served result vs the plain version.  The reference
#: conformance harness allows 5e-4 for float32; this limit sits above the
#: IEEE-f32 readings on the H100 (1.1e-6 and 4.3e-6 for the GEMM) and below
#: what TF32 inputs (a 10-bit mantissa, unit roundoff 2**-11) give, so a
#: TF32 path fails it.  Phase 3 checks that TF32-rounded inputs exceed it.
F32_TOL = 2e-5

#: llama3-8b (src/repro/configs/llama3_8b.py): the (k, n) of its linears
D_MODEL, KV_WIDTH, D_FF = 4096, 8 * 128, 14336
LINEARS = ((D_MODEL, D_MODEL), (D_MODEL, KV_WIDTH), (D_MODEL, D_FF),
           (D_FF, D_MODEL))
TOKENS = (8, 2048)
BUCKET = (8, 128, D_MODEL)          # a serving bucket against one weight
#: the stacked call of each 2-dim op
STACKED_2D = (8, 512, 512)
#: the service phase: client threads, requests of each op per thread, the
#: request shape (gemm: (512, 512, 512)), the flush size and the workers
SERVICE_THREADS, SERVICE_PER_THREAD = 4, 8
SERVICE_SHAPE = (512, 512)
SERVICE_MAX_BATCH, SERVICE_WORKERS = 8, 2
#: timed windows of the whole traffic, through the service and as one
#: run_op per request, alternated after one warm-up window of each
SERVICE_WINDOWS = 5
#: seconds the fresh serving process may take
SERVE_TIMEOUT_S = 600
#: the prewarm phase: the oracle's dominance band for the pruned-space
#: reading, and scripts/torch_prewarm_model.py's install of llama3-8b's
#: harvested keys, timed on the card, with the seconds it may take
PREWARM_SLACK = 0.15
PREWARM_ARGS = ("--arch", "llama3-8b", "--batch", "4", "--seq", "128",
                "--max-new", "32", "--timer", "wallclock", "--n-samples",
                "32", "--tune-trials", "1", "--candidates",
                "LinearRegression,DecisionTree")
PREWARM_TIMEOUT_S = 240
#: the retune phase: windows of phase 5's traffic after the cold one, a
#: step() after each and none of them may read drift (a window gives each
#: op one sample: the default retuner's 3 anchoring samples, then its
#: min_samples 8, and one to spare), the drift fed as telemetry (the
#: reference retune_bench's DRIFT_MULT), and the co-tenant's windows and
#: matmul edge
RETUNE_WINDOWS = 12
DRIFT_MULT = 4.0
COTENANT_WINDOWS = 3
COTENANT_SHAPE = 8192
#: the fleet phase: executor processes, and rounds of alternated windows
#: (fleet, in-process service, one run_op per request)
FLEET_PROCESSES = 2
FLEET_ROUNDS = 3

#: the model phases, each serving one model at full width, routed,
#: float32, in a fresh process of its own (the first two do not fit the
#: card together): arch -> (the tag of its lines, parameters, layers
#: served, d_model, seconds its process may take).  Phase 6: llama3-8b
#: (src/repro_torch/configs/llama3_8b.py); phase 6b: deepseek-v2-lite-16b
#: (configs/deepseek_v2_lite.py: MLA, a dense first layer, 26 MoE layers
#: of 64 experts top-6 and 2 shared); phase 6c: zamba2-1.2b
#: (configs/zamba2_1p2b.py: 6 zamba_super blocks of 6 Mamba2 blocks and
#: the one shared attention block, 2 Mamba2 blocks); phase 6d: rwkv6-1.6b
#: (configs/rwkv6_1p6b.py: 24 RWKV6 layers); phase 6e: whisper-medium
#: (configs/whisper_medium.py: 24 encoder and 24 decoder layers); phase
#: 6f: internvl2-76b (configs/internvl2_76b.py) at the depth of
#: MODEL_CUTS
MODEL_PHASES = {
    "llama3-8b": ("model", 8_030_261_248, 32, 4096, 300),
    "deepseek-v2-lite-16b": ("moe", 15_706_484_224, 27, 2048, 420),
    "zamba2-1.2b": ("zamba2", 1_220_805_504, 38, 2048, 300),
    "rwkv6-1.6b": ("rwkv6", 1_615_497_216, 24, 2048, 300),
    "whisper-medium": ("whisper", 810_987_520, 24, 1024, 300),
    "internvl2-76b": ("vlm", 15_858_933_760, 16, 8192, 480),
}
#: the models served at a cut depth, arch -> layers: internvl2-76b's 80
#: layers are 282.48 GB of float32 weights; 16 of them (3.42 GB each) with
#: the embedding, the LM head and the vision projection (8.67 GB) leave
#: room on the 85.5 GB card for the checks' temporaries (the TF32 rounding
#: of the (8192, 128256) head takes two 4.2 GB ones)
MODEL_CUTS = {"internvl2-76b": 16}
#: phase 8: the model trained at a cut depth, arch -> layers: llama3-8b's 32
#: layers are 8.030 B parameters, 128.5 GB of float32 parameters,
#: gradients and both AdamW moments (16 bytes a parameter), which do not
#: fit the 80 GB card; 16 layers are 4.540 B (72.6 GB), which leave no room
#: for the activations and the bf16 weight casts; 12 are 3.668 B (58.7
#: GB).  All 32 need the state sharded over several cards
TRAIN_CUTS = {"llama3-8b": 12}
#: phase 8: the batch of a step (launch/train.py's defaults), the steps of
#: the full-width run and of each smoke config, and the layers of the
#: full-width float64 gradient check (1.487 B parameters)
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS = 8
TRAIN_SMOKE_STEPS = 2
GRAD_LAYERS = 2
#: phase 8b's limits: per tensor, max |g_f32 - g_f64| / max |g_f64|, and
#: the loss's relative error
GRAD_TOL = 1e-4
GRAD_LOSS_TOL = 1e-5
#: phase 8d: the step during which the preemption notice arrives, and the
#: steps of the resumed and the uninterrupted run
RESUME_AT, RESUME_STEPS = 6, 10
#: seconds the training processes may take (8a-8c, 8d, the example)
TRAIN_TIMEOUT_S = 300
RESUME_TIMEOUT_S = 180
EXAMPLE_TIMEOUT_S = 240
#: phase 9 (training under a mesh): the steps of 9b, 9a's limit (the
#: loss's relative error, each gradient's max error over its max value),
#: and the seconds its process may take
MESH_STEPS = 4
MESH_TOL = 1e-6
MESH_TIMEOUT_S = 300
#: phase 10a: the timed real steps after one warm-up, and the band the dry
#: count's peak bytes must lie in, as a share of the real step's
DRYRUN_TIMED_STEPS = 3
DRYRUN_PEAK_BAND = (0.8, 1.25)
#: phase 10b: the production cells traced at full depth, and the seconds
#: their process (10c after them) may take.  llama3-8b x prefill_32k is
#: left out: its 32 x 32 flash blocks a layer, 32 layers, trace on fake
#: tensors for about 9 minutes of host time (550 s on an 8-core host),
#: past what the time limit leaves; the CPU tests trace it at 2 layers
DRYRUN_CELLS = (("llama3-8b", "train_4k", "single"),
                ("llama3-8b", "decode_32k", "single"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"),
                ("llama3-8b", "train_4k", "multi"))
DRYRUN_TIMEOUT_S = 360
#: phase 10c: the cpu_blocked install (dims up to 512, 16 samples) and the
#: held-out gemm dims its tuned knob is timed at against the default
CPU_BLOCKED_ARGS = ("--backend", "cpu_blocked", "--ops", "gemm",
                    "--precisions", "s,d", "--samples", "16",
                    "--dim-lo", "32", "--dim-hi", "512",
                    "--footprint-mb", "8", "--tune-trials", "1",
                    "--candidates", "LinearRegression,DecisionTree,KNN")
CPU_BLOCKED_HELD_OUT = ((96, 480, 200), (300, 300, 300), (512, 64, 448),
                        (200, 512, 96))
#: requests, prompt and new tokens of each model's generate, greedy
MODEL_REQUESTS, MODEL_PROMPT, MODEL_NEW = 4, 128, 32
#: decode steps after the prefill whose logits are held to the plain version
MODEL_CHECK_STEPS = 4
#: max |routed - plain| / max |plain| of those logits.  On the H100 (700 W)
#: IEEE f32 in the two summation orders read 4.1e-6 through the 32 layers
#: and TF32-rounded weights 1.4e-3; the phase prints both and fails unless
#: the limit lies between them
MODEL_TOL = 1e-4
#: where the plain model's own float32 noise floor (every GEMM weight one
#: ulp up) lies above MODEL_TOL, its logits are held to this many times
#: that floor: rwkv6-1.6b's floor is 0.33-0.44 on the H100 (700 W), its
#: routed logits 1.01-1.02 times it, and TF32-rounded weights 2.1-3.0 times
FLOOR_FACTOR = 2.0
#: the device ops a model phase lists and the calls over which it takes a
#: linear's host time
MODEL_TOP_OPS = 8
MODEL_HOST_CALLS = 50
#: a routing flip between the routed and the plain run is a near tie where
#: the routed run's k-th and (k+1)-th expert probabilities differ by less
#: than this share of its top probability
NEAR_TIE = 1e-5
#: profiles of the same calls :func:`_device_ms` takes before it fails
#: for want of device time
PROFILE_ATTEMPTS = 3
#: the GEMM kernel's name in a profile (csrc/gemm.cu's ``gemm_kernel``)
GEMM_KERNEL = re.compile(r"(^|[\s:])gemm_kernel<")

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 (NVIDIA's H100 SXM data sheet), phase 8's model-FLOP share
BF16_PEAK_TFLOPS = 989.4
#: the ops whose calls phase 7 prints a ``[rate]`` line for
RATE_OPS = ("gemm", "symm", "syrk", "syr2k", "trmm", "trsm")

#: calibration settings of phase 4, and the Halton dims each op installs
#: with (log-scaled, so most are small: the six gather in about two
#: minutes on the card)
CALIBRATE_ARGS = ("--backend", "hopper", "--precisions", "s",
                  "--dim-lo", "8", "--dim-hi", "16384",
                  "--footprint-mb", "400", "--tune-trials", "1",
                  "--candidates", "LinearRegression,DecisionTree,KNN,XGBoost")
CALIBRATE_SAMPLES = {"gemm": 256, "symm": 256, "syrk": 256, "syr2k": 192,
                     "trmm": 192, "trsm": 192}

#: the kernels the main paths launch: name -> (route, source, TPU kernel)
KERNELS = {
    "gemm": ("cuda", "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:55"),
    "symm": ("cuda", "src/repro_torch/kernels/csrc/symm.cu",
             "src/repro/kernels/symm.py:38"),
    "rank_k": ("cuda", "src/repro_torch/kernels/csrc/rank_k.cu",
               "src/repro/kernels/syrk.py:73"),
    "rank_k_packed": ("cuda", "src/repro_torch/kernels/csrc/rank_k_packed.cu",
                      "src/repro/kernels/syrk.py:132"),
    "trmm": ("cuda", "src/repro_torch/kernels/csrc/trmm.cu",
             "src/repro/kernels/trmm.py:57"),
    "trmm_packed": ("cuda", "src/repro_torch/kernels/csrc/trmm_packed.cu",
                    "src/repro/kernels/trmm.py:85"),
    "trsm": ("cuda", "src/repro_torch/kernels/csrc/trsm.cu",
             "src/repro/kernels/trsm.py:41"),
    "trsm_inv": ("cuda", "src/repro_torch/kernels/csrc/trsm.cu",
                 "src/repro/kernels/trsm.py:58"),
}


def serve_cases() -> list[dict]:
    """The main paths' calls: label, op, operand shapes and keywords."""
    cases = [{"label": f"T={t} ({t},{k})@({k},{n})", "op": "gemm",
              "shapes": [[t, k], [k, n]], "kw": {}}
             for t in TOKENS for k, n in LINEARS]
    b, s, d = BUCKET
    cases.append({"label": f"bucket ({b},{s},{d})@({d},{d})", "op": "gemm",
                  "shapes": [list(BUCKET), [d, d]], "kw": {}})
    ema = {"alpha": 0.05, "beta": 0.95}
    for n, k in ((D_MODEL, D_FF), (D_FF, D_MODEL)):
        cases.append({"label": f"syrk L=GG^T A ({n},{k}) C ({n},{n})",
                      "op": "syrk", "shapes": [[n, k], [n, n]], "kw": ema})
    cases += [
        {"label": f"symm sym(A) ({D_MODEL},{D_MODEL}) B ({D_MODEL},{D_FF})",
         "op": "symm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
        {"label": f"syr2k A,B ({D_MODEL},{D_MODEL})", "op": "syr2k",
         "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_MODEL]], "kw": {}},
        {"label": f"trmm tril(L) ({D_MODEL},{D_MODEL}) G ({D_MODEL},{D_FF})",
         "op": "trmm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
        {"label": f"trsm tril(A) ({D_MODEL},{D_MODEL}) B ({D_MODEL},{D_FF})",
         "op": "trsm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
    ]
    bt, m, n = STACKED_2D
    for op, shapes in (("symm", [[bt, m, m], [bt, m, n]]),
                       ("syrk", [[bt, m, n]]),
                       ("syr2k", [[bt, m, n], [bt, m, n]]),
                       ("trmm", [[bt, m, m], [bt, m, n]]),
                       ("trsm", [[bt, m, m], [bt, m, n]])):
        cases.append({"label": f"{op} stacked {STACKED_2D}", "op": op,
                      "shapes": shapes, "kw": {}})
    return cases


def _sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _rel_err(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max()
            / (want.abs().max() + 1e-9)).item()


def _tf32(x):
    """``x`` with its mantissa rounded to TF32's 10 bits, as a TF32 product
    reads its float32 inputs."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _work(op: str, shapes, kw) -> tuple[float, float]:
    """Operations and bytes of one call: its BLAS operation count (gemm
    2mnk, symm 2m^2n, syrk n^2k, syr2k 2n^2k, trmm and trsm m^2n) and each
    input read once and the output written once (a triangular or symmetric
    A counted as its lower triangle)."""
    first = shapes[0]
    batch = first[0] if len(first) == 3 else 1
    with_c = kw.get("beta", 0.0) != 0.0
    if op == "gemm":
        m, k = first[-2:]
        n = shapes[1][-1]
        flops = 2.0 * batch * m * n * k
        words = batch * m * k + math.prod(shapes[1]) + batch * m * n
    elif op in ("symm", "trmm", "trsm"):
        m, n = first[-1], shapes[1][-1]
        flops = batch * m * m * n * (2.0 if op == "symm" else 1.0)
        words = batch * (m * (m + 1) / 2 + 2 * m * n)
    else:
        n, k = first[-2:]
        two = op == "syr2k"
        flops = batch * n * n * k * (2.0 if two else 1.0)
        words = batch * ((2 if two else 1) * n * k + n * n
                         + (n * (n + 1) / 2 if with_c else 0))
    return flops, 4.0 * words


def _bound(op: str, shapes, kw) -> tuple[float, str]:
    """Least ms the card needs for one call: :func:`_work`'s operations at
    the f32 CUDA-core peak against its bytes at the HBM rate."""
    flops, nbytes = _work(op, shapes, kw)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _time_ms(torch, fn, sets, iters: int = 10) -> float:
    """Mean ms of ``fn(*operands)`` per call on the card: CUDA events around
    ``iters`` calls after a warmup, cycling through operand ``sets`` so the
    operands come from HBM and not from the 50 MB L2."""
    for ops in sets:
        fn(*ops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, sets, iters: int) -> float:
    """Mean device time per call of every kernel (and copy) ``fn`` runs on
    the card, over ``iters`` calls cycling through ``sets`` after a warmup,
    from ``torch.profiler``: for work shorter than the host time of its
    call, which CUDA events around back-to-back calls measure instead.
    Fails if the profiler records no device time in
    :data:`PROFILE_ATTEMPTS` profiles of those calls in a row (on the
    card a profile has come back empty once); prints a line for each
    profile it retakes."""
    from torch.profiler import ProfilerActivity, profile
    for ops in sets:
        fn(*ops)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages())
        if us > 0:
            return us / 1e3 / iters
        print(f"[times] torch.profiler recorded no device time in profile "
              f"{attempt} of {PROFILE_ATTEMPTS}", flush=True)
    raise SystemExit(f"[times] torch.profiler recorded no device time in "
                     f"{PROFILE_ATTEMPTS} profiles")


def kernel_of(op: str, knob: dict) -> str:
    """The kernel (a key of :data:`KERNELS`) a call of ``op`` under
    ``knob`` runs."""
    if op in ("syrk", "syr2k"):
        return "rank_k_packed" if knob["variant"] == "tri_packed" \
            else "rank_k"
    if op == "trmm":
        return "trmm_packed" if knob["variant"] == "tri_packed" else "trmm"
    return op


def _expected_launches(op: str, knob: dict) -> dict:
    if op == "trsm":
        return {"trsm_inv": 1, "trsm": 1}
    return {kernel_of(op, knob): 1}


def make_operands(torch, gen, op: str, shapes):
    """Seeded operands of a case on the card: standard normal, trsm's A
    made diagonally dominant (``+ m * I``) and syrk's C symmetric."""
    xs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    if op == "trsm":
        xs[0].diagonal(dim1=-2, dim2=-1).add_(shapes[0][-1])
    if op == "syrk" and len(xs) == 2:
        xs[1] = 0.5 * (xs[1] + xs[1].mT)
    return xs


def plain_of(op: str, knob: dict):
    """The plain PyTorch version of ``op`` under ``knob`` (its variant)."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    if op == "gemm":
        return G.gemm_plain
    if op == "symm":
        return S.symm_plain
    if op == "trmm":
        return TM.trmm_plain
    if op == "trsm":
        return T.trsm_plain
    if op == "syrk":
        return lambda a, c=None, **kw: K.rank_k_plain(
            a, None, c, variant=knob["variant"], **kw)
    return lambda a, b, c=None, **kw: K.rank_k_plain(
        a, b, c, variant=knob["variant"], **kw)


# -- phase 5, in a fresh process --------------------------------------------

def serve_main(registry_dir: str, retune_dir: str, fleet_dir: str) -> None:
    """Load the installed artifacts into a new runtime and serve the main
    paths' calls, then the same runtime behind a ``BlasService``, then the
    retune phase (:func:`retune_phase`, on the copy of the registry in
    ``retune_dir``) and the fleet phase (:func:`fleet_phase`, the
    artifacts copied into the sub-registry of this host's fingerprint
    under ``fleet_dir``); prints one ``SERVE_RESULT {json}`` line."""
    # a stuck phase prints every thread's stack before the parent's
    # timeout kills this process
    faulthandler.dump_traceback_later(SERVE_TIMEOUT_S - 20, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core.knobs import Knob
    from repro_torch.kernels import introspect, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rt = AdsalaRuntime()
    loaded = ModelRegistry(registry_dir).load_into(rt, backend="hopper")
    missing = [op for op in ops.HOPPER_OPS if not rt.has(op, 4, "hopper")]
    if loaded != len(ops.HOPPER_OPS) or missing:
        raise SystemExit(f"expected hopper__{{op}}_b4.adsala for every op "
                         f"in {registry_dir}, loaded {loaded}, missing "
                         f"{missing}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, pinned = [], []

    def call(case, operands, knob=None):
        with introspect.capture_launches() as launched:
            out = ops.run_op(case["op"], tuple(operands), backend="hopper",
                             runtime=rt, knob=knob, **case["kw"])
        torch.cuda.synchronize()
        launches = {}
        for kernel, _grid in launched:
            launches[kernel] = launches.get(kernel, 0) + 1
        if knob is None:
            dims = ops.dims_of(case["op"],
                               tuple(tuple(x.shape) for x in operands))
            knob = rt.peek(case["op"], dims, 4, "hopper")
        kd = knob.dict
        plain = plain_of(case["op"], kd)(*operands, **case["kw"])
        if tuple(out.shape) != tuple(plain.shape) or \
                not bool(torch.isfinite(out).all()):
            raise SystemExit(f"{case['label']}: bad output "
                             f"{tuple(out.shape)}")
        want = _expected_launches(case["op"], kd)
        rows.append({**case, "knob": kd, "launches": launches,
                     "expected_launches": want,
                     "kernel": kernel_of(case["op"], kd),
                     "rel_err": _rel_err(out, plain),
                     "abs_err": (out - plain).abs().max().item()})
        return out

    # the run_op path: counts from 0 just before, read just after
    introspect.reset_launches()
    for case in serve_cases():
        operands = make_operands(torch, gen, case["op"], case["shapes"])
        call(case, operands)
        # every rank-k and trmm call but R = G^T G, whose full variant
        # alone takes about 48 ms on an H100
        if case["op"] in ("syrk", "syr2k", "trmm") \
                and case["shapes"][0] != [D_FF, D_MODEL]:
            pinned.append((case, operands))
        del operands
    stats = rt.stats
    served = len(rows)
    # a caller that pins the variant: syrk L = G G^T, both syr2k calls, the
    # stacked syrk call and both trmm calls under each variant, with the
    # tile the model chose
    for case, operands in pinned:
        model = dict(rows[[r["label"] for r in rows].index(case["label"])]
                     ["knob"])
        outs = {}
        for variant in ("full", "tri", "tri_packed"):
            knob = Knob(tuple(sorted({**model, "variant": variant}.items())))
            outs[variant] = call({**case, "label": f"{case['label']} pinned "
                                  f"{variant}", "pinned": True},
                                 operands, knob)
        if not torch.equal(outs["tri"].view(torch.int32),
                           outs["tri_packed"].view(torch.int32)):
            raise SystemExit(f"[serve] {case['label']}: tri_packed != tri "
                             f"bit for bit")
    launches = introspect.launch_counts()
    service = serve_service(torch, rt)
    t0 = time.perf_counter()
    traffic_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    traffic = [service_requests(torch, traffic_gen)
               for _ in range(SERVICE_THREADS)]
    retune = retune_phase(torch, traffic, retune_dir)
    retune["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sub = ModelRegistry(fleet_dir).for_fingerprint(create=True)
    for path in Path(registry_dir).glob("hopper__*.adsala"):
        shutil.copy(path, sub.root / path.name)
    fleet = fleet_phase(torch, rt, traffic, fleet_dir)
    fleet["phase_s"] = time.perf_counter() - t0
    fleet["slug"] = sub.root.name
    print("SERVE_RESULT " + json.dumps({
        "rows": rows, "served": served, "launches": launches,
        "model_evals": stats.model_evals,
        "default_calls": stats.default_calls,
        "eval_failures": stats.eval_failures, "calls": stats.calls,
        "service": service, "retune": retune, "fleet": fleet}), flush=True)


def service_requests(torch, gen) -> list[tuple[str, tuple]]:
    """The service phase's traffic, per client thread: 8 requests of each
    of the six ops, at the preconditioner-block shape (512, 512) and for
    gemm (512, 512, 512), seeded operands on the card."""
    m, n = SERVICE_SHAPE
    shapes = {"gemm": [[m, m], [m, n]], "symm": [[m, m], [m, n]],
              "syrk": [[m, n]], "syr2k": [[m, n], [m, n]],
              "trmm": [[m, m], [m, n]], "trsm": [[m, m], [m, n]]}
    return [(op, tuple(make_operands(torch, gen, op, shapes[op])))
            for _ in range(SERVICE_PER_THREAD) for op in shapes]


def serve_service(torch, rt) -> dict:
    """The service phase, on the card under the installed runtime: four
    client threads submit their requests together.  After one warm-up
    window of the whole traffic (the cold decisions of new shapes, the
    workers' streams), :data:`SERVICE_WINDOWS` windows through the service
    alternate with as many windows of one ``run_op`` per request on the
    same requests.  Checks every result of the service windows against the
    plain version of its own request and their launches against the
    buckets they executed."""
    from repro_torch.kernels import introspect, ops
    from repro_torch.serving import BlasService, ServeConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    traffic = [service_requests(torch, gen) for _ in range(SERVICE_THREADS)]
    flat = [r for part in traffic for r in part]
    torch.cuda.synchronize()
    cfg = ServeConfig(max_batch=SERVICE_MAX_BATCH, linger_ms=2.0,
                      workers=SERVICE_WORKERS)
    before = rt.stats

    def batches(svc) -> dict:
        return {key: (b.batches, b.exec_seconds)
                for key, b in svc.bucket_stats().items() if key[0] == "hopper"}

    with BlasService(runtime=rt, config=cfg) as svc, \
            concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        def client(reqs):
            return [svc.submit(op, operands) for op, operands in reqs]

        def service_window():
            t0 = time.perf_counter()
            futures = list(pool.map(client, traffic))
            outs = [f.result(timeout=300) for part in futures for f in part]
            dt = time.perf_counter() - t0
            # a worker books its stats just after it resolves the futures
            if not svc.drain(timeout=60):
                raise SystemExit("[service] requests still in flight")
            return dt, outs

        def single_window():
            t0 = time.perf_counter()
            for op, operands in flat:
                ops.run_op(op, operands, runtime=rt)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        service_window()
        single_window()
        st0, buckets0 = dataclasses.replace(svc.stats), batches(svc)
        launches = {k: 0 for k in KERNELS}
        service_s, single_s, results = [], [], []
        for _ in range(SERVICE_WINDOWS):
            introspect.reset_launches()
            dt, outs = service_window()
            for kernel, count in introspect.launch_counts().items():
                launches[kernel] += count
            service_s.append(dt)
            results.append(outs)
            single_s.append(single_window())
        st, buckets1 = svc.stats, batches(svc)
    after = rt.stats
    worst = 0.0
    for i, (op, operands) in enumerate(flat):
        dims = ops.dims_of(op, tuple(tuple(x.shape) for x in operands))
        knob = rt.peek(op, dims, 4, "hopper").dict
        want = plain_of(op, knob)(*operands)
        for outs in results:
            err = _rel_err(outs[i], want)
            worst = max(worst, err)
            if not err < F32_TOL:
                raise SystemExit(f"[service] {op} {knob}: rel err {err:.3e}")
    # every launch belongs to a bucket the service executed
    expected = {k: 0 for k in KERNELS}
    knobs, spans = {}, {}
    for key, (n_batches, exec_s) in buckets1.items():
        _be, op, _bytes, dims = key
        knob = rt.peek(op, dims, 4, "hopper").dict
        knobs[op] = _knob_str(op, knob)
        n0, exec0 = buckets0.get(key, (0, 0.0))
        n_batches -= n0
        spans[op] = 1e3 * (exec_s - exec0) / max(1, n_batches)
        for kernel, count in _expected_launches(op, knob).items():
            expected[kernel] += count * n_batches
    completed = st.completed - st0.completed
    failed = st.failed - st0.failed
    n_batches = st.batches - st0.batches
    return {"requests": len(flat) * SERVICE_WINDOWS, "completed": completed,
            "failed": failed, "batches": n_batches,
            "mean_batch": (completed + failed) / max(1, n_batches),
            "launches": launches, "expected_launches": expected,
            "knobs": knobs, "max_rel_err": worst, "bucket_ms": spans,
            "window_requests": len(flat),
            "service_s": service_s, "single_s": single_s,
            "mean_bucket_ms": 1e3 * (st.exec_sum - st0.exec_sum)
            / max(1, completed),
            "model_evals": after.model_evals - before.model_evals,
            "default_calls": after.default_calls - before.default_calls,
            "eval_failures": after.eval_failures - before.eval_failures}


# -- the prewarm phase (after phase 4) ---------------------------------------

def harvest_models() -> dict:
    """Every model phase's decision keys, harvested on the meta device at
    that phase's shapes (:data:`MODEL_REQUESTS` x :data:`MODEL_PROMPT`
    tokens, :data:`MODEL_NEW` new, the depth of :data:`MODEL_CUTS`):
    arch -> sorted keys, each ``[backend, op, dtype_bytes, dims]``."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import harvest_decision_keys
    out = {}
    for arch in MODEL_PHASES:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=MODEL_CUTS.get(
            arch, full.n_layers))
        keys = harvest_decision_keys(cfg, batch_size=MODEL_REQUESTS,
                                     seq_len=MODEL_PROMPT, max_new=MODEL_NEW)
        out[arch] = sorted([be, op, db, list(dims)]
                           for be, op, db, dims in keys)
    return out


def _spearman(a, b) -> float:
    """Spearman's rank correlation of two 1-D arrays (ranks by argsort;
    the timings have no exact ties)."""
    import numpy as np
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def oracle_readings(out_dir: Path) -> dict:
    """Per op, the H100 oracle against phase 4's measured labels
    (``datasets/hopper__{op}_s.npz``): Spearman's rank correlation over
    every (dims, knob) label, and the dims at which the oracle's argmin is
    the measured best.  A reading, not a gate."""
    import numpy as np
    from repro_torch.core.oracle import oracle_time
    res = {}
    for path in sorted((out_dir / "datasets").glob("hopper__*_s.npz")):
        op = path.stem.split("__", 1)[1].rsplit("_", 1)[0]
        data = np.load(path)
        knobs = json.loads(str(data["knobs"]))
        times = data["times"]
        pred = np.array([[oracle_time(op, tuple(d), k) for k in knobs]
                         for d in data["dims"]])
        res[op] = {"rho": _spearman(times.ravel(), pred.ravel()),
                   "argmin_agree": int((times.argmin(1)
                                        == pred.argmin(1)).sum()),
                   "dims": int(times.shape[0]), "knobs": len(knobs)}
    return res


def prewarm_phase(card: str, out_dir: Path) -> dict:
    """Harvest every model phase's keys, print the key counts, the pruned
    against the full GEMM knob space and the oracle's readings, prewarm
    the decision cache of phase 4's registry with every harvested key
    (the model phases load it), and run ``scripts/torch_prewarm_model.py
    --timer wallclock`` for llama3-8b into a registry of its own; fails
    unless that script exits 0.  Writes ``harvest.json`` beside the
    registry; returns arch -> keys."""
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.kernels import ops
    from repro_torch.roofline import prune_dominated_candidates
    t0 = time.perf_counter()
    harvested = harvest_models()
    space = ops.knob_space_for("gemm")
    for arch, keys in harvested.items():
        pruned = prune_dominated_candidates(
            "gemm", space, [tuple(k[3]) for k in keys],
            slack=PREWARM_SLACK)
        print(f"[prewarm] {arch}: {len(keys)} decision keys harvested on "
              f"the meta device ({MODEL_REQUESTS} x {MODEL_PROMPT} prompt "
              f"tokens, {MODEL_NEW} new); gemm knob space pruned by the "
              f"oracle {len(space)} -> {len(pruned)} (slack "
              f"{PREWARM_SLACK})", flush=True)
    for op, r in oracle_readings(out_dir).items():
        print(f"[prewarm:oracle] [{card}] {op}: Spearman rank correlation "
              f"of the H100 oracle with phase 4's measured labels "
              f"{r['rho']:.4f} over {r['dims']} dims x {r['knobs']} knobs; "
              f"oracle argmin = measured best at {r['argmin_agree']}/"
              f"{r['dims']} dims", flush=True)
    reg = ModelRegistry(out_dir / "models")
    rt = AdsalaRuntime()
    reg.load_into(rt, backend="hopper")
    keys = sorted({tuple([k[0], k[1], k[2], tuple(k[3])])
                   for ks in harvested.values() for k in ks})
    rt.select_many([(op, dims, db, be) for be, op, db, dims in keys],
                   record_hits=False)
    path = reg.save_decision_cache(rt)
    print(f"[prewarm] {len(keys)} distinct keys of the six models decided "
          f"by the installed model ({rt.stats.model_evals} model evals) and "
          f"saved to {path.name}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    (out_dir / "harvest.json").write_text(json.dumps(harvested))
    t0 = time.perf_counter()
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_prewarm_"))
    try:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_prewarm_model.py"),
             "--registry", str(scratch), *PREWARM_ARGS],
            cwd=ROOT, capture_output=True, text=True,
            timeout=PREWARM_TIMEOUT_S)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for line in proc.stdout.splitlines():
        if line.startswith("[prewarm]"):
            print(f"[prewarm:script] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"[prewarm] scripts/torch_prewarm_model.py exited "
                         f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    print(f"[prewarm] scripts/torch_prewarm_model.py {' '.join(PREWARM_ARGS)}"
          f": exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return harvested


# -- the retune phase (in phase 5's process) --------------------------------

def _service_windows(svc, pool, traffic, windows: int,
                     after=None) -> tuple[list, list, list]:
    """Run ``windows`` windows of ``traffic`` (one list of requests per
    client thread) through ``svc``; returns each window's results, what
    ``after()``, run after each window has drained, returned, and each
    window's seconds (submit to the last result, host clock)."""
    results, returned, seconds = [], [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        futures = list(pool.map(
            lambda reqs: [svc.submit(op, xs) for op, xs in reqs], traffic))
        results.append([f.result(timeout=300) for part in futures
                        for f in part])
        seconds.append(time.perf_counter() - t0)
        if not svc.drain(timeout=60):
            raise SystemExit("[retune] requests still in flight")
        if after is not None:
            got = after()
            if isinstance(got, list):
                returned.extend(got)
    return results, returned, seconds


def retune_phase(torch, traffic, retune_dir: str,
                 device: str = "cuda") -> dict:
    """On a copy of phase 4's registry (its install datasets attached to
    the artifacts): phase 5's traffic through ``BlasService(retuner=...)``
    with the default :class:`RetuneConfig`, ``step()`` after each of
    :data:`RETUNE_WINDOWS` windows after the cold one (no drift may be
    detected in any); then the served GEMM knob's measured time x
    :data:`DRIFT_MULT` fed as telemetry (detected in one ``step()``, refit,
    saved under the next artifact version, swapped), the decisions after
    the swap against a fresh runtime loading the new artifact, the newly
    served knob's kernel through ``run_op`` against its plain version;
    last, the drift readings under a co-tenant (a second stream looping a
    large ``torch.matmul``).  ``device="cpu"`` rehearses it on the plain
    versions."""
    import numpy as np
    from repro_torch.backends import resolve_backend
    from repro_torch.core import AdsalaRuntime, ModelRegistry, TimingDataset
    from repro_torch.core.registry import load_subroutine
    from repro_torch.kernels import ops
    from repro_torch.serving import BlasService, Retuner, ServeConfig

    root = Path(retune_dir)
    reg = ModelRegistry(root / "models")
    rt = AdsalaRuntime()
    reg.load_into(rt, backend="hopper")
    for op in ops.HOPPER_OPS:
        sub = rt.subroutine(op, 4, "hopper")
        data = np.load(root / "datasets" / f"hopper__{op}_s.npz")
        sub.dataset = TimingDataset(op=op, dims=data["dims"],
                                    times=data["times"],
                                    knob_space=sub.knob_space, dtype_bytes=4)
    ret = Retuner(rt, registry=reg)
    cfg = ServeConfig(max_batch=SERVICE_MAX_BATCH, linger_ms=2.0,
                      workers=SERVICE_WORKERS)
    flat = [r for part in traffic for r in part]
    be = resolve_backend("hopper", device=device)

    def reading(op):
        """The served bucket of ``op``: its key, knob, the installed
        model's prediction and the install's own timer at those dims."""
        key = next(k for k in rt.stats.buckets if k[1] == op)
        knob = rt.peek(op, key[3], 4, "hopper") or rt.select(
            op, key[3], 4, backend="hopper")
        sub = rt.subroutine(op, 4, "hopper")
        pred = float(rt.predictor(op, 4, "hopper").predict_times(key[3])[
            sub.knob_space.index(knob)])
        return key, knob, pred, be.timer_fn(op)(key[3], knob)

    t0 = time.perf_counter()
    with BlasService(runtime=rt, config=cfg, retuner=ret,
                     device=device) as svc, \
            concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        _service_windows(svc, pool, traffic, 1)   # cold decisions
        ret.baseline()
        events0 = ret.stats.drift_events
        st0 = dataclasses.replace(svc.stats)
        buckets0 = {k: (b.exec_seconds, b.exec_items)
                    for k, b in rt.stats.buckets.items()}
        _, swapped, window_s = _service_windows(
            svc, pool, traffic, RETUNE_WINDOWS, after=ret.step)
        st = svc.stats
    steady_s = time.perf_counter() - t0
    per_op = {}
    for op in ops.HOPPER_OPS:
        ewma, n = ret.drift(op, 4, "hopper")
        key, knob, pred, label = reading(op)
        b = rt.stats.buckets[key]
        secs0, items0 = buckets0.get(key, (0.0, 0))
        probes = b.exec_items - items0
        anchor = ret.anchors(op, 4, "hopper").get(
            (key[3], rt.subroutine(op, 4, "hopper").knob_space.index(knob)))
        per_op[op] = {"ewma": ewma, "samples": n, "batches": b.batches,
                      "mean_batch": b.mean_batch, "probes": probes,
                      "probe_ms": 1e3 * (b.exec_seconds - secs0)
                      / max(1, probes), "label_ms": 1e3 * label,
                      "predicted_ms": 1e3 * pred, "anchor": anchor,
                      "knob": knob.dict, "dims": list(key[3])}
    done = st.completed - st0.completed
    steady = {"drift_events": ret.stats.drift_events - events0,
              "swapped": [list(k) for k in swapped],
              "samples": ret.stats.samples, "skipped": ret.stats.skipped,
              "min_samples": ret.config.min_samples,
              "per_op": per_op, "seconds": steady_s,
              "rates": [len(flat) / dt for dt in window_s],
              "bucket_ms_per_request": 1e3 * (st.exec_sum - st0.exec_sum)
              / max(1, done)}

    # drift: the served GEMM knob's measured time x DRIFT_MULT, fed as
    # telemetry through the record_batch seam the service feeds
    g = per_op["gemm"]
    dims = tuple(g["dims"])
    old_sub = rt.subroutine("gemm", 4, "hopper")
    old_version = int(old_sub.artifact_version)
    old_knob = rt.peek("gemm", dims, 4, "hopper")
    measured = DRIFT_MULT * g["probe_ms"] / 1e3
    rt.record_batch("gemm", dims, 4, "hopper", SERVICE_MAX_BATCH,
                    exec_seconds=measured, exec_items=1)
    t0 = time.perf_counter()
    events0, swaps0 = ret.stats.drift_events, rt.stats.swaps
    swapped = ret.step()
    refit_s = time.perf_counter() - t0
    new_sub = rt.subroutine("gemm", 4, "hopper")
    probe = sorted({tuple(k[3]) for k in rt.stats.buckets if k[1] == "gemm"}
                   | {dims})
    fresh = AdsalaRuntime()
    fresh.register(load_subroutine(root / "models" / "hopper__gemm_b4.adsala"))
    live = [rt.select("gemm", d, 4, backend="hopper").dict for d in probe]
    loaded = [fresh.select("gemm", d, 4, backend="hopper").dict
              for d in probe]
    new_knob = rt.peek("gemm", dims, 4, "hopper")
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    a = torch.randn(dims[0], dims[1], generator=gen, device=device)
    w = torch.randn(dims[1], dims[2], generator=gen, device=device)
    out = ops.run_op("gemm", (a, w), runtime=rt, device=device)
    drift = {"detected": ret.stats.drift_events - events0,
             "swapped": [list(k) for k in swapped], "refit_s": refit_s,
             "old_version": old_version,
             "new_version": int(new_sub.artifact_version),
             "file_version": int(fresh.subroutine(
                 "gemm", 4, "hopper").artifact_version),
             "swaps": rt.stats.swaps - swaps0, "old_knob": old_knob.dict,
             "new_knob": new_knob.dict, "model": new_sub.model_name,
             "probe": [list(d) for d in probe],
             "equal_to_fresh": live == loaded, "live": live,
             "rel_err": _rel_err(out, plain_of("gemm", new_knob.dict)(a, w))}

    # co-tenancy: a second stream loops a large torch.matmul while phase
    # 5's traffic runs; the drift readings of a fresh retuner (observe
    # only) anchored on windows without it
    co = Retuner(rt)
    stop = threading.Event()
    edge = COTENANT_SHAPE if device == "cuda" else 256
    x = torch.randn(edge, edge, generator=gen, device=device)
    loops = [0]

    def cotenant():
        stream = (torch.cuda.Stream() if device == "cuda"
                  else contextlib.nullcontext())
        with (torch.cuda.stream(stream) if device == "cuda" else stream):
            while not stop.is_set():
                torch.matmul(x, x)
                if device == "cuda":
                    stream.synchronize()
                loops[0] += 1

    with BlasService(runtime=rt, config=cfg, retuner=co,
                     device=device) as svc, \
            concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        _service_windows(svc, pool, traffic, 1)   # cold decisions
        co.baseline()
        # the anchors form on clean windows; the co-tenant comes after
        _service_windows(svc, pool, traffic, co.config.anchor_samples,
                         after=co.observe)
        thread = threading.Thread(target=cotenant, daemon=True)
        thread.start()
        try:
            _service_windows(svc, pool, traffic, COTENANT_WINDOWS,
                             after=co.observe)
        finally:
            stop.set()
            thread.join(timeout=60)
    cotenancy = {op: co.drift(op, 4, "hopper") for op in ops.HOPPER_OPS}
    del x
    return {"steady": steady, "drift": drift, "cotenancy": cotenancy,
            "cotenant_loops": loops[0], "requests": len(flat)}


# -- the fleet phase (in phase 5's process) ---------------------------------

def fleet_phase(torch, rt, traffic, fleet_dir: str,
                device: str = "cuda") -> dict:
    """A ``FleetService`` of :data:`FLEET_PROCESSES` executor processes on
    the card (spawned), over phase 4's artifacts in the sub-registry of
    this host's fingerprint: phase 5's traffic, every result against the
    in-process ``run_op`` bit for bit; the executors' fingerprint
    resolution; a warm join (a third executor after the traffic) and its
    model evals on the same traffic; an executor SIGKILLed before a window
    (respawned, its bucket requeued, no future lost); then requests/s of
    the fleet, the in-process service and one ``run_op`` per request in
    alternated windows, the mean batch, and the device memory an executor
    takes as it starts (the card's free memory before and after).
    ``device="cpu"`` rehearses it on the plain versions.
    """
    import os
    import signal

    from repro_torch.core import ModelRegistry
    from repro_torch.kernels import ops
    from repro_torch.serving import (BlasService, FleetConfig, FleetService,
                                     ServeConfig)

    flat = [r for part in traffic for r in part]
    cfg = ServeConfig(max_batch=SERVICE_MAX_BATCH, linger_ms=2.0,
                      workers=SERVICE_WORKERS)
    def free_mb():
        return (torch.cuda.mem_get_info()[0] / 2 ** 20 if device == "cuda"
                else 0.0)

    t0 = time.perf_counter()
    free0 = free_mb()
    fleet = FleetService(fleet=FleetConfig(processes=FLEET_PROCESSES,
                                           registry_root=fleet_dir),
                         config=cfg, device=device)
    start_s = time.perf_counter() - t0
    start_mb = (free0 - free_mb()) / FLEET_PROCESSES
    try:
        with concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
            def window(svc):
                futures = list(pool.map(
                    lambda reqs: [svc.submit(op, xs) for op, xs in reqs],
                    traffic))
                return [f.result(timeout=300) for part in futures
                        for f in part]

            outs = window(fleet)
            want = [ops.run_op(op, xs, runtime=rt, device=device).cpu()
                    for op, xs in flat]
            unequal = [i for i, (got, w) in enumerate(zip(outs, want))
                       if not torch.equal(got, w)]
            first = fleet.fleet_stats()
            free0 = free_mb()
            info = fleet.add_member()               # the warm join
            join_mb = free0 - free_mb()
            evals0 = {d["member"]: d["model_evals"]
                      for d in fleet.fleet_stats()}
            for _ in range(2):
                window(fleet)
            joined = next(d for d in fleet.fleet_stats()
                          if d["member"] == info["member"])
            # SIGKILL one executor, then a window: respawn + requeue
            victim = fleet._executors[0]
            os.kill(victim.proc.pid, signal.SIGKILL)
            victim.proc.join(timeout=10)
            st0 = dataclasses.replace(fleet.stats)
            outs = window(fleet)
            st1 = fleet.stats
            killed = {"respawns": st1.worker_respawns - st0.worker_respawns,
                      "completed": st1.completed - st0.completed,
                      "failed": st1.failed - st0.failed,
                      "requests": len(flat),
                      "equal": all(torch.equal(g, w)
                                   for g, w in zip(outs, want))}
            # requests/s, alternated windows: fleet, in-process, single
            rates = {"fleet": [], "service": [], "single": []}
            fst0 = dataclasses.replace(fleet.stats)
            with BlasService(runtime=rt, config=cfg, device=device) as svc:
                window(svc)
                for _ in range(FLEET_ROUNDS):
                    for name, run in (
                            ("fleet", lambda: window(fleet)),
                            ("service", lambda: window(svc)),
                            ("single", lambda: [
                                ops.run_op(op, xs, runtime=rt, device=device)
                                for op, xs in flat])):
                        t1 = time.perf_counter()
                        run()
                        if device == "cuda":
                            torch.cuda.synchronize()
                        rates[name].append(len(flat)
                                           / (time.perf_counter() - t1))
            fst = fleet.stats
            stats = fleet.fleet_stats()
    finally:
        fleet.close()
    card = (torch.cuda.get_device_name(0).lower() if device == "cuda"
            else "")
    return {"start_s": start_s, "unequal": unequal, "requests": len(flat),
            "start_mb": start_mb, "join_mb": join_mb,
            "first": first, "joined": joined, "join_info": info,
            "join_evals_before": evals0.get(info["member"]),
            "killed": killed, "rates": rates,
            "mean_batch": (fst.completed - fst0.completed)
            / max(1, fst.batches - fst0.batches),
            "executors": [{"member": d.get("member"), "pid": d.get("pid"),
                           "alive": d.get("alive"),
                           "model_evals": d.get("model_evals"),
                           "resolution": d.get("resolution"),
                           "device_name": d.get("device_name")}
                          for d in stats],
            "names_card": all(card in str(d["resolution"].get("gpu", ""))
                              and d["resolution"].get("mode") == "exact"
                              for d in stats if d.get("alive"))}


def report_retune(card: str, res: dict) -> None:
    """Print the retune phase's lines and fail unless steady traffic read
    no drift in any window after the cold one (every op read at least
    ``min_samples`` times past its anchor), the drift
    fed as telemetry was detected in one ``step()``, refit, saved under
    the next artifact version and swapped, the decisions after the swap
    equal a fresh runtime's loading the saved artifact, and the newly
    served knob's kernel agrees with its plain version."""
    st = res["steady"]
    rates = sorted(st["rates"])
    print(f"[retune] [{card}] phase 5's traffic through "
          f"BlasService(retuner=Retuner(...)) with the default RetuneConfig, "
          f"step() after each of {RETUNE_WINDOWS} windows after the cold "
          f"one, {res['requests']} requests a window: {st['drift_events']} "
          f"drift events, swapped {st['swapped']} ({st['seconds']:.1f} s, "
          f"{st['samples']} samples); {rates[len(rates) // 2]} requests/s "
          f"(median; windows {st['rates']}); a request's share of its "
          f"bucket's span {st['bucket_ms_per_request']:.4f} ms", flush=True)
    for op, r in st["per_op"].items():
        print(f"[retune:{op}] [{card}] dims {tuple(r['dims'])} knob "
              f"{_knob_str(op, r['knob'])}: {r['batches']} buckets, mean "
              f"batch {r['mean_batch']:.3f}, {r['probes']} probes; a probe "
              f"(the first item alone, its kernels) {r['probe_ms']:.4f} ms, "
              f"the install's timer {r['label_ms']:.4f} ms "
              f"({r['probe_ms'] / r['label_ms']:.3f}x), the installed model "
              f"{r['predicted_ms']:.4f} ms; anchor (measured/predicted) "
              f"{r['anchor']}; EWMA {r['ewma']} over {r['samples']} samples",
              flush=True)
    dr = res["drift"]
    print(f"[retune:drift] [{card}] the served gemm knob "
          f"{_knob_str('gemm', dr['old_knob'])}'s time x {DRIFT_MULT:g} fed "
          f"as telemetry: {dr['detected']} drift event(s) in one step(), "
          f"swapped {dr['swapped']}, refit ({dr['model']}) in "
          f"{dr['refit_s']:.2f} s; artifact version {dr['old_version']} -> "
          f"{dr['new_version']} (on disk {dr['file_version']}), swaps "
          f"{dr['swaps']}; served knob now {_knob_str('gemm', dr['new_knob'])}"
          f"; decisions at {len(dr['probe'])} dims equal to a fresh runtime "
          f"loading the saved artifact: {dr['equal_to_fresh']}; the new "
          f"knob's kernel via run_op vs plain rel err {dr['rel_err']:.2e}",
          flush=True)
    print(f"[retune:cotenant] [{card}] EWMA with a second stream looping a "
          f"{COTENANT_SHAPE}^3 torch.matmul ({res['cotenant_loops']} loops, "
          f"{COTENANT_WINDOWS} windows after the anchors formed on clean "
          f"ones; observe only, a reading): " + ", ".join(
              f"{op} {e if e is None else round(e, 4)} ({n})"
              for op, (e, n) in res["cotenancy"].items())
          + f"; phase {res['phase_s']:.1f} s", flush=True)
    if st["drift_events"] or st["swapped"] or any(
            r["samples"] < st["min_samples"] for r in st["per_op"].values()):
        raise SystemExit("[retune] steady traffic read as drift (or gave "
                         "too few samples to read)")
    if dr["detected"] < 1 or dr["swapped"] != [["hopper", "gemm", 4]] \
            or dr["new_version"] != dr["old_version"] + 1 \
            or dr["file_version"] != dr["new_version"] or dr["swaps"] != 1:
        raise SystemExit("[retune] drift not detected, refit, versioned and "
                         "swapped in one step()")
    if not dr["equal_to_fresh"] or not dr["rel_err"] < F32_TOL:
        raise SystemExit("[retune] decisions after the swap differ from a "
                         "fresh load, or the new knob's kernel from its "
                         "plain version")


def report_fleet(card: str, res: dict) -> None:
    """Print the fleet phase's lines and fail unless every result equals
    the in-process ``run_op`` bit for bit, the warm join paid no model
    eval, the killed executor was respawned with no future lost, and
    every executor resolved the sub-registry of this card."""
    rates = {k: sorted(v) for k, v in res["rates"].items()}
    med = {k: v[len(v) // 2] for k, v in rates.items()}
    first = res["first"]
    print(f"[fleet] [{card}] {FLEET_PROCESSES} executor processes "
          f"(spawn) started in {res['start_s']:.1f} s, {res['start_mb']:.0f} "
          f"MiB of device memory each, its CUDA context (the card's free "
          f"memory before and after; the joining one {res['join_mb']:.0f} "
          f"MiB); "
          f"{res['requests']} "
          f"requests of phase 5's traffic: {len(res['unequal'])} results "
          f"differ from the in-process run_op; executors' model evals "
          f"{[d['model_evals'] for d in first]}", flush=True)
    for ex in res["executors"]:
        print(f"[fleet:executor] [{card}] {ex['member']} pid {ex['pid']} on "
              f"{ex['device_name']}: resolution {ex['resolution']}; model "
              f"evals {ex['model_evals']}", flush=True)
    info, joined = res["join_info"], res["joined"]
    print(f"[fleet:join] [{card}] warm join: {info['warm_started']} "
          f"decisions warm-started, {info['loaded']} artifacts loaded; then "
          f"2 windows: model evals {joined['model_evals']}, cache hits "
          f"{joined['cache_hits']} of {joined['calls']} calls", flush=True)
    k = res["killed"]
    print(f"[fleet:kill] [{card}] one executor SIGKILLed, then a window: "
          f"{k['respawns']} respawn(s), {k['completed']} of {k['requests']} "
          f"completed, {k['failed']} failed, results bit-equal {k['equal']}",
          flush=True)
    print(f"[fleet:rate] [{card}] requests/s (host clock, {FLEET_ROUNDS} "
          f"alternated windows each, median [min, max]): fleet "
          f"{med['fleet']:.1f} {[round(r, 1) for r in rates['fleet']]}, "
          f"in-process service {med['service']:.1f} "
          f"{[round(r, 1) for r in rates['service']]}, one run_op each "
          f"{med['single']:.1f} {[round(r, 1) for r in rates['single']]}; "
          f"fleet / single {med['fleet'] / med['single']:.3f}x, service / "
          f"single {med['service'] / med['single']:.3f}x; fleet mean batch "
          f"{res['mean_batch']:.3f}; phase {res['phase_s']:.1f} s",
          flush=True)
    if res["unequal"] or not k["equal"]:
        raise SystemExit("[fleet] results differ from the in-process run_op")
    if joined["model_evals"] != 0 or info["warm_started"] < 1:
        raise SystemExit("[fleet] the warm join paid model evals")
    if k["respawns"] < 1 or k["completed"] != k["requests"] or k["failed"]:
        raise SystemExit("[fleet] the killed executor lost futures")
    if not res["names_card"]:
        raise SystemExit("[fleet] an executor resolved artifacts not "
                         "calibrated on this card")


# -- phases 6 to 6f, each in a fresh process --------------------------------

def _gemm_calls(cfg, decode: bool) -> int:
    """GEMM launches of one pass from the config, by block kind: an
    attention block's linears (GQA q, k, v, o; MLA wq, wkv_a, wkv_b, wo,
    and at decode no wkv_b, which the absorbed form reads in its einsums),
    then the MLP's 3 (SwiGLU) or 2, or the MoE's 3 expert stacks and its
    shared experts' 3 linears; a Mamba2 block's in_proj and out_proj; a
    zamba_super's Mamba2 blocks, its in_proj and the shared attention
    block's linears; an RWKV6 layer's 8 (wr, wk, wv, wg, wo, cm_wk, cm_wr,
    cm_wv); a ``"dec_cross"`` block's self- and cross-attention's 4 each
    and its MLP's; the LM head; and at the prefill the VLM's vision
    projection.  Whisper's encoder is :func:`_encoder_calls`."""
    attn = 3 if decode and cfg.use_mla else 4
    mlp = 3 if cfg.mlp_type == "swiglu" else 2
    per = {"attn": attn + mlp,
           "moe": attn + 3 + (3 if cfg.n_shared_experts else 0),
           "mamba2": 2, "rwkv6": 8,
           "zamba_super": 2 * cfg.shared_attn_every + 1 + attn + mlp,
           "dec_cross": 2 * attn + mlp}
    vision = cfg.family == "vlm" and not decode
    return sum(repeat * per[kind] for kind, repeat in cfg.segments()) + 1 \
        + vision


def _encoder_calls(cfg) -> int:
    """GEMM launches of one run of Whisper's encoder: an ``"enc"`` block's
    q, k, v, o and its MLP's; none for the other families."""
    mlp = 3 if cfg.mlp_type == "swiglu" else 2
    return cfg.n_enc_layers * (4 + mlp)


def _reckoning(cfg, batch: int, prompt: int, max_len: int) -> dict:
    """A model phase's bounds from the config alone, before any run: the
    weight floats a decode step's GEMMs read (the experts apart; zamba2's
    shared block once a zamba_super that reads it), once and as launched
    (an expert stack reads each expert once; every other weight is read
    by each of the ``batch`` stacked items), at the HBM rate; the
    prefill's GEMM operations at the f32 peak (MLA's cached prefill
    expands the whole cache of ``max_len`` through ``wkv_b``; the experts
    run every capacity row; Whisper's encoder and every pass's cross K and
    V projections of its ``enc_seq`` frames; the VLM's vision projection
    and its vision tokens through the layers) and the share of the expert
    rows that carry a token; a decode step's GEMM operations (Whisper's
    cross K and V apart); the f32 decode state by part (KV or latent
    caches, Mamba2's ``ssm`` and ``conv``, RWKV6's ``S`` and token
    shifts); the GEMM calls a pass and of the encoder."""
    from repro_torch.models.mamba2 import _dims
    from repro_torch.models.moe import capacity
    d, V = cfg.d_model, cfg.vocab
    if cfg.use_mla:
        h, nope, rp = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        attn = (d * (cfg.kv_lora + rp) + d * h * (nope + rp)
                + h * cfg.v_head_dim * d)
        wkv_b = cfg.kv_lora * h * (nope + cfg.v_head_dim)
        kv = batch * max_len * (cfg.kv_lora + rp) * 4
    else:
        hd = cfg.hd()
        attn = d * (cfg.n_heads + 2 * cfg.kv_heads) * hd \
            + cfg.n_heads * hd * d
        wkv_b = 0
        kv = 2 * batch * max_len * cfg.kv_heads * hd * 4
    f, E = cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
    d_inner, n_heads, conv_dim = _dims(cfg)
    mamba = d * (2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                 + n_heads) + d_inner * d
    k = cfg.shared_attn_every
    # a dec_cross block's cross K and V weights, which read the encoder's
    # frames rather than the tokens
    xkv = 2 * d * cfg.kv_heads * cfg.hd()
    floats = {"attn": attn + mlp,
              "moe": attn + 3 * d * cfg.n_shared_experts * f,
              "mamba2": mamba, "zamba_super": k * mamba + 2 * d * d + attn
              + mlp, "rwkv6": 6 * d * d + 2 * d * cfg.d_ff,
              "dec_cross": 2 * attn + mlp}
    ssm = batch * n_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    conv = batch * (cfg.conv_width - 1) * conv_dim * 4
    wkv = batch * d * cfg.rwkv_head_dim * 4
    state = {"kv": 0, "ssm": 0, "conv": 0, "wkv": 0, "shift": 0}
    parts = {"attn": {"kv": kv}, "moe": {"kv": kv},
             "mamba2": {"ssm": ssm, "conv": conv},
             "zamba_super": {"ssm": k * ssm, "conv": k * conv, "kv": kv},
             "rwkv6": {"wkv": wkv, "shift": 2 * batch * d * 4},
             "dec_cross": {"kv": kv}}
    body = n_attn = n_moe = n_cross = 0
    for kind, repeat in cfg.segments():
        body += repeat * floats[kind]
        n_attn += repeat * (kind in ("attn", "moe"))
        n_moe += repeat * (kind == "moe")
        n_cross += repeat * (kind == "dec_cross")
        for part, nbytes in parts[kind].items():
            state[part] += repeat * nbytes
    experts = n_moe * E * 3 * d * f
    C = capacity(cfg, prompt) if n_moe else 0
    rows = E * batch * C
    expert_flop = 2.0 * n_moe * rows * 3 * d * f
    per_token = body - n_cross * xkv
    cross_flop = 2.0 * batch * cfg.enc_seq * n_cross * xkv
    encoder_flop = 2.0 * batch * cfg.enc_seq * cfg.n_enc_layers * (attn
                                                                   + mlp)
    seq = prompt + cfg.vision_tokens
    flop = 2.0 * (batch * seq * per_token + batch * max_len * n_attn * wkv_b
                  + batch * d * V + batch * cfg.vision_tokens * d * d) \
        + expert_flop + cross_flop + encoder_flop
    decode_flop = 2.0 * (batch * (per_token + d * V) + n_moe * E * batch
                         * (capacity(cfg, 1) if n_moe else 0) * 3 * d * f) \
        + cross_flop
    return {"expert_floats": experts, "other_floats": body + d * V,
            "decode_bytes_ms": 4.0 * (experts + body + d * V)
            / HBM_BYTES_PER_S * 1e3,
            "decode_launched_ms": 4.0 * (experts + batch * (body + d * V))
            / HBM_BYTES_PER_S * 1e3,
            "decode_flop": decode_flop,
            "decode_ops_ms": decode_flop / F32_PEAK_FLOPS * 1e3,
            "cross_flop": cross_flop, "encoder_flop": encoder_flop,
            "prefill_flop": flop,
            "prefill_ops_ms": flop / F32_PEAK_FLOPS * 1e3,
            "expert_flop": expert_flop, "capacity": C, "expert_rows": rows,
            "useful_rows": batch * prompt * cfg.top_k if n_moe else 0,
            "state_bytes": state,
            "calls_prefill": _gemm_calls(cfg, False),
            "calls_decode": _gemm_calls(cfg, True),
            "calls_encoder": _encoder_calls(cfg)}


def _prefill(tf, model, cfg, rt, prompts, extra: dict, caches):
    """The prefill of ``prompts`` with the family's stub inputs ``extra``
    (tensors), as ``ServeSession.generate`` runs it: Whisper's encoder runs
    here once and its output is returned for the decode steps (None for
    the other families).  Returns (last-token logits, encoder output)."""
    from repro_torch.models import Ctx
    enc_out = None
    batch = {"tokens": prompts}
    if cfg.family == "audio":
        enc_out = tf._run_encoder(model, extra["frames"], Ctx(cfg, rt))
    else:
        batch.update(extra)
    last, _ = tf.prefill(model, batch, caches, cfg, runtime=rt,
                         enc_out=enc_out)
    return last, enc_out


def _teacher_forced(torch, tf, model, cfg, rt, prompts, forced, steps: int,
                    max_len: int, extra: dict):
    """Prefill ``prompts`` (with the family's stub inputs ``extra``; the
    prefill's time includes Whisper's encoder), then ``steps`` decode
    steps fed ``forced`` (teacher-forced) at their true positions, the
    host never waiting on the card.  Returns the logits of every pass, the
    prefill's ms and each step's ms (CUDA events between consecutive
    passes), and each step's host ms (the time its ``decode_step`` call
    takes to return)."""
    caches = tf.init_decode_state(cfg, prompts.shape[0], max_len,
                                  dtype=torch.float32, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 2)]
    host = []
    torch.cuda.synchronize()
    events[0].record()
    last, enc_out = _prefill(tf, model, cfg, rt, prompts, extra, caches)
    events[1].record()
    logits = [last]
    for t in range(steps):
        h0 = time.perf_counter()
        last, caches = tf.decode_step(model, forced[:, t:t + 1], caches, cfg,
                                      runtime=rt, enc_out=enc_out,
                                      pos=prompts.shape[1] + t)
        host.append(1e3 * (time.perf_counter() - h0))
        events[t + 2].record()
        logits.append(last)
    torch.cuda.synchronize()
    return (logits, events[0].elapsed_time(events[1]),
            [events[t + 1].elapsed_time(events[t + 2]) for t in range(steps)],
            host)


def _logits_err(got: list, want: list) -> float:
    """Largest |got - want| over the largest |want|, over every pass."""
    return max((g.double() - w.double()).abs().max().item()
               / w.double().abs().max().item() for g, w in zip(got, want))


def _device_profile(torch, fn, label=None) -> dict:
    """``fn`` under ``torch.profiler`` (device activity only): the device
    time by kernel name, the GEMM kernel's share of it, and the device's
    idle share between its first and its last operation (1 - the union of
    the operations' intervals over that span).  With ``label`` (a launch
    grid -> a name), also the GEMM kernel's time by the label of each
    launch, the kernels matched to the recorded launches in launch order
    (one stream), as ``gemm_by_label`` (None if the counts differ)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import introspect
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            introspect.capture_launches() as seen:
        fn()
        torch.cuda.synchronize()
    ops = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise SystemExit("[model] torch.profiler recorded no device time")
    by_name: dict = {}
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    spans = sorted((s, e) for s, e, _ in ops)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    gemm = sum(us for name, us in by_name.items() if GEMM_KERNEL.search(name))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:MODEL_TOP_OPS]
    by_label = None
    if label is not None:
        kernels = sorted((s, e) for s, e, name in ops
                         if GEMM_KERNEL.search(name))
        grids = [grid for kernel, grid in seen if kernel == "gemm"]
        if len(kernels) == len(grids):
            by_label = {}
            for (s, e), grid in zip(kernels, grids):
                by_label[label(grid)] = by_label.get(label(grid), 0.0) \
                    + (e - s) / 1e3
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window, "device_ms": total / 1e3,
            "gemm_ms": gemm / 1e3, "gemm_share": gemm / total,
            "top": [(name[:90], us / 1e3) for name, us in top],
            "gemm_by_label": by_label}


def _linear_host_us(torch, model, cfg, rt) -> tuple[str, dict]:
    """The first linear of the first layer (an attention block's ``wq``,
    Mamba2's ``in_proj``, RWKV6's ``wr``) and the host's µs per call of it
    at a decode step, ``(4, 1, d_in) @ w``, three ways: the routed linear
    (``run_op``: decision, backend, wrapper, launch), the GEMM wrapper
    alone under the same knob, and ``torch.matmul``.  Host clock over
    :data:`MODEL_HOST_CALLS` calls issued back to back, too few to fill
    the launch queue, after one call each."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
    from repro_torch.models.layers import Ctx, Linear, routed_matmul
    name, lin = next((n, m) for n, m in model.layers[0].named_modules()
                     if isinstance(m, Linear))
    w = lin.w
    x = torch.randn(MODEL_REQUESTS, 1, w.shape[0], device="cuda")
    ctx = Ctx(cfg, rt)
    kd = rt.peek("gemm", ops.dims_of("gemm", (tuple(x.shape),
                                              tuple(w.shape))),
                 4, "hopper").dict
    out = {}
    for how, fn in (("routed linear", lambda: routed_matmul(x, w, ctx)),
                    ("gemm wrapper", lambda: G.gemm(
                        x, w, bm=kd["bm"], bk=kd["bk"], bn=kd["bn"])),
                    ("torch.matmul", lambda: torch.matmul(x, w))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MODEL_HOST_CALLS):
            fn()
        out[how] = 1e6 * (time.perf_counter() - t0) / MODEL_HOST_CALLS
        torch.cuda.synchronize()
    return f"layers.0.{name} ({MODEL_REQUESTS},1,{w.shape[0]}) @ " \
        f"{tuple(w.shape)}", out


def _scan_gap(torch, tf, model, cfg, rt, prompts, max_len: int) -> dict:
    """The chunked prefill of ``prompts`` against the same prompt fed one
    token at a time through ``decode_step`` (the exact one-token
    recurrence) from a fresh state: the last position's logits and each
    layer's carried recurrent state (Mamba2's ``ssm``, RWKV6's ``S``), as
    max |chunked - sequential| over max |sequential|.  The reference's
    chunked scans clamp the running log-decay at -30, so at a chunk of
    128 the two part; this reads by how much on the card."""
    def states(caches):
        out = []
        for c in caches:
            for one in (c["mamba"] if "mamba" in c else [c]):
                out.append(one["ssm"] if "ssm" in one else one["S"])
        return out

    runs = []
    for sequential in (False, True):
        caches = tf.init_decode_state(cfg, prompts.shape[0], max_len,
                                      dtype=torch.float32, device="cuda")
        if sequential:
            for t in range(prompts.shape[1]):
                last, _ = tf.decode_step(model, prompts[:, t:t + 1], caches,
                                         cfg, runtime=rt)
        else:
            last, _ = tf.prefill(model, {"tokens": prompts}, caches, cfg,
                                 runtime=rt)
        runs.append((last, states(caches)))
    (chunked, got), (seq, want) = runs
    gaps = [_rel_err(g, w) for g, w in zip(got, want, strict=True)]
    chunk = (min(cfg.ssm_chunk, prompts.shape[1]) if cfg.family == "hybrid"
             else min(cfg.rwkv_chunk, prompts.shape[1]))
    return {"chunk": chunk, "logits": _rel_err(chunked, seq),
            "argmax_agree": int((chunked.argmax(-1) == seq.argmax(-1))
                                .sum().item()),
            "state_max": max(gaps), "state_min": min(gaps),
            "state_first": gaps[0], "state_last": gaps[-1],
            "states": len(gaps)}


def _clone(node):
    """A copy of a decode cache: its tensors cloned, its dicts and lists
    rebuilt, anything else (a length) kept."""
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.clone() if hasattr(node, "clone") else node


def _hooked_layers(model) -> list:
    """``(name, module)`` of every layer the checks replay: the decoder's
    ``layers.i`` and Whisper's encoder blocks ``encoder.blocks.j``."""
    out = [(f"layers.{i}", blk) for i, blk in enumerate(model.layers)]
    if model.encoder is not None:
        out += [(f"encoder.blocks.{j}", blk)
                for j, blk in enumerate(model.encoder.blocks)]
    return out


def _layer_inputs(torch, model):
    """Forward pre-hooks on every layer of :func:`_hooked_layers` that
    append ``(layer name, input, a copy of its cache as the layer found
    it, its keyword arguments)`` to the first returned list, and a forward
    hook on the model that appends the last position of its final hidden
    state (what the final norm and the LM head read) to the second; call
    the returned remover to take them off."""
    seen: list = []
    finals: list = []

    def grab(name, args, kwargs):
        seen.append((name, args[0].clone(),
                     _clone(args[2] if len(args) > 2 else None), kwargs))

    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, kwargs, name=name: grab(name, args, kwargs),
        with_kwargs=True) for name, blk in _hooked_layers(model)]
    hooks.append(model.register_forward_hook(
        lambda mod, args, out: finals.append(out[0][:, -1:].clone())))
    return seen, finals, lambda: [h.remove() for h in hooks]


def _layer_outputs(model, c, rt, inputs) -> list:
    """Each captured ``(layer name, input, cache, kwargs)`` run through its
    layer under config ``c`` from a copy of the captured cache: the
    outputs."""
    from repro_torch.models import Ctx
    outs = []
    for name, x, cache, kwargs in inputs:
        out = model.get_submodule(name)(x, Ctx(c, rt), _clone(cache),
                                        **kwargs)
        outs.append(out[0] if isinstance(out, tuple) else out)
    return outs


def _head_outputs(model, c, rt, finals) -> list:
    """The final norm and the LM head under config ``c`` on each captured
    final hidden state: the logits."""
    from repro_torch.models import Ctx
    from repro_torch.models.transformer import _logits
    return [_logits(model, x, Ctx(c, rt)) for x in finals]


def _one_ulp(torch, weights, fn):
    """``fn()`` with every tensor of ``weights`` one ulp up, the weights
    then put back bit for bit."""
    for sign in (1.0, -1.0):
        for w in weights:
            w.copy_(torch.nextafter(w, w.new_tensor(sign * math.inf)))
        if sign > 0:
            out = fn()
    return out


def _gemm_weights(model) -> list:
    """The weights the GEMM kernel reads: every linear's (not the MoE
    routers', plain float32 matmuls in the routed run too) and the raw
    expert tensors."""
    from repro_torch.models import MoE
    from repro_torch.models.layers import Linear
    routers = {id(m.router) for m in model.modules() if isinstance(m, MoE)}
    out = []
    for mod in model.modules():
        if isinstance(mod, Linear) and id(mod) not in routers:
            out.append(mod.w)
        if isinstance(mod, MoE):
            out += [mod.wg, mod.wu, mod.wd]
    return out


def _moe_inputs(torch, model):
    """Forward pre-hooks on every MoE module that append ``(layer, input)``
    to the returned list; call the returned remover to take them off."""
    seen: list = []
    hooks = [blk.moe.register_forward_pre_hook(
        lambda mod, args, i=i: seen.append((i, args[0].clone())))
        for i, blk in enumerate(model.layers) if blk.kind == "moe"]
    return seen, lambda: [h.remove() for h in hooks]


def _moe_parity(torch, model, cfg, plain, rt, inputs) -> list:
    """Each captured ``(layer, input)``: that layer's ``moe_ffn`` routed
    (the GEMM kernel) and plain (einsum, ``torch.matmul``) on the same
    input, as ``(layer, rows, rel err)``."""
    from repro_torch.models import Ctx, moe_ffn
    out = []
    for i, x in inputs:
        mod = model.layers[i].moe
        got, _ = moe_ffn(mod, x, Ctx(cfg, rt), with_aux=False)
        want, _ = moe_ffn(mod, x, Ctx(plain), with_aux=False)
        out.append((i, x.shape[1], _rel_err(got, want)))
    return out


def _routing_flips(torch, model, cfg, routed, plain) -> dict:
    """The top-k expert sets of the routed and the plain run, per captured
    layer input and token (``routed``, ``plain``: the two runs' ``(layer,
    input)`` lists, pass for pass).  A flip is a token whose sets differ:
    listed with the routed run's k-th and (k+1)-th probabilities, their
    gap over its top probability, and the token's input difference between
    the runs (max abs over the plain row's max abs).  A flip whose inputs
    agree within ``F32_TOL`` is the run's own rounding (``root``); one
    whose inputs differ more follows from an earlier flip."""
    from repro_torch.models.moe import route
    K = cfg.top_k
    flips, routings = [], 0
    for n, ((i, xr), (j, xp)) in enumerate(zip(routed, plain,
                                               strict=True)):
        if i != j:
            raise SystemExit(f"[moe] captures out of step: {i} and {j}")
        mod = model.layers[i].moe
        pr = torch.topk(route(mod, xr, K)[0], K + 1, dim=-1)
        pp = torch.topk(route(mod, xp, K)[0], K + 1, dim=-1)
        ids_r = pr.indices[..., :K].sort(-1).values
        ids_p = pp.indices[..., :K].sort(-1).values
        differ = (ids_r != ids_p).any(-1)
        routings += differ.numel()
        diff = ((xr - xp).abs().amax(-1)
                / xp.abs().amax(-1).clamp_min(1e-30))
        for b, s in differ.nonzero().tolist():
            p = pr.values[b, s].tolist()
            flips.append({"layer": i, "capture": n, "b": b, "s": s,
                          "p_k": p[K - 1], "p_k1": p[K],
                          "gap": (p[K - 1] - p[K]) / p[0],
                          "input_diff": diff[b, s].item(),
                          "root": diff[b, s].item() < F32_TOL})
    return {"routings": routings, "flips": flips}


def _expert_stack_times(torch, model, cfg, rt) -> list:
    """The expert stacks of the main path at a decode step and at the
    prefill: ``(E, B*C, d) @ (E, d, f)`` (gate, up) and ``(E, B*C, f) @
    (E, f, d)`` (down), on the model's weights, cycled over 4 layers so
    they come from HBM (738 MB a stack).  For each: the kernel through
    ``run_op`` under the installed model's knob, the plain version (the
    unrouted ``einsum`` on the unfolded ``(B, E, C, d)`` slab), the library
    (``torch.bmm`` on the folded stack), the bound, the error against the
    plain version, the knob and the copy ops on its dispatch path."""
    from repro_torch.kernels import introspect, ops
    from repro_torch.models.moe import capacity
    E = cfg.n_experts
    layers = [blk.moe for blk in model.layers if blk.kind == "moe"][:4]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for label, seq in (("decode", 1), ("prefill", MODEL_PROMPT)):
        C = capacity(cfg, seq)
        m = MODEL_REQUESTS * C
        for which, k in (("gate/up", cfg.d_model), ("down", cfg.moe_d_ff)):
            a = torch.randn((E, m, k), generator=gen, device="cuda")
            ws = [mod.wd if which == "down" else mod.wg for mod in layers]
            sets = [(a, w) for w in ws]
            slab = a.reshape(E, MODEL_REQUESTS, C, k).transpose(0, 1)
            shapes = [[E, m, k], list(ws[0].shape)]
            kd = rt.peek("gemm", ops.dims_of("gemm", (tuple(a.shape),
                                                      tuple(ws[0].shape))),
                         4, "hopper").dict
            copies = introspect.copy_op_counts(ops.run_op, "gemm", sets[0],
                                               runtime=rt)
            got = ops.run_op("gemm", sets[0], runtime=rt)
            want = torch.einsum("becd,edf->becf", slab, ws[0]).transpose(
                0, 1).reshape(E, m, -1)
            bound_ms, bound_by = _bound("gemm", shapes, {})
            rows.append({
                "label": f"{label} {which} ({E},{m},{k})@{tuple(ws[0].shape)}",
                "knob": f"{kd['bm']}x{kd['bk']}x{kd['bn']}",
                "copies": copies, "rel_err": _rel_err(got, want),
                "abs_err": (got - want).abs().max().item(),
                "ms": _time_ms(torch, lambda x, w: ops.run_op(
                    "gemm", (x, w), runtime=rt), sets),
                "plain_ms": _time_ms(torch, lambda x, w: torch.einsum(
                    "becd,edf->becf", x.reshape(
                        E, MODEL_REQUESTS, C, k).transpose(0, 1), w), sets),
                "library_ms": _time_ms(torch, torch.bmm, sets),
                "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def model_main(registry_dir: str, arch: str) -> None:
    """Serve ``arch`` (a key of :data:`MODEL_PHASES`) at full width and
    depth from a fresh runtime holding the installed ``hopper__gemm_b4``
    artifact: one ``generate`` of :data:`MODEL_REQUESTS` prompts (its GEMM
    launches and decisions), then teacher-forced passes on its tokens for
    the times and the device profiles (an MoE model's expert stacks apart
    from its other linears), the logits against the plain version, every
    GEMM call against ``torch.matmul`` on its operands, every layer on its
    captured input and cache, the final norm and LM head on
    the captured final hidden state, the plain model's float32 noise
    floor of each and, for an MoE model, each MoE layer on one captured
    input, the routing flips between the routed and the plain run, and
    its expert stacks at the decode and prefill shapes; for a recurrent
    model the chunked prefill against the token-by-token recurrence and
    the logits' floor with the scans' clamp out of reach; prints one
    ``MODEL_RESULT {json}`` line."""
    faulthandler.dump_traceback_later(MODEL_PHASES[arch][4] - 20, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core.registry import load_subroutine
    from repro_torch.kernels import introspect
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import ServeSession, stub_inputs
    from repro_torch.models import Ctx
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    rt = AdsalaRuntime()
    artifact = Path(registry_dir) / "hopper__gemm_b4.adsala"
    rt.register(load_subroutine(artifact))
    # the prewarm phase's decision cache, and the keys it harvested
    warm_started = ModelRegistry(registry_dir).load_decision_cache(rt)
    harvested = {(be, op, db, tuple(dims)) for be, op, db, dims in json.loads(
        (Path(registry_dir).parent / "harvest.json").read_text())[arch]}
    full = get_config(arch)
    cfg = dataclasses.replace(full, use_pallas_gemm=True,
                              compute_dtype="float32",
                              n_layers=MODEL_CUTS.get(arch, full.n_layers))
    plain = dataclasses.replace(cfg, use_pallas_gemm=False)
    # the VLM's vision tokens take cache positions ahead of the prompt
    max_len = MODEL_PROMPT + MODEL_NEW + 8 + cfg.vision_tokens
    t0 = time.perf_counter()
    model = tf.init_params(SEED, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tf.param_count(model)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (MODEL_REQUESTS, MODEL_PROMPT),
                           dtype=np.int32)
    stub = stub_inputs(cfg, MODEL_REQUESTS, rng)
    sess = ServeSession(cfg=cfg, params=model, max_len=max_len, runtime=rt,
                        device="cuda")

    # the main path: counts and decisions from 0 just before, read after;
    # the keys the generate asks for are recorded on the way
    requested = set()
    select = rt.select_or_default

    def recording(op, dims, dtype_bytes, default, *, backend="hopper"):
        requested.add((backend, op, int(dtype_bytes),
                       tuple(int(d) for d in dims)))
        return select(op, dims, dtype_bytes, default, backend=backend)

    rt.select_or_default = recording
    introspect.reset_launches()
    t0 = time.perf_counter()
    tokens = sess.generate(prompts, max_new=MODEL_NEW, **stub)
    generate_s = time.perf_counter() - t0
    launches = introspect.launch_counts()
    del rt.select_or_default
    stats = rt.stats.for_backend("hopper")
    # every prewarmed decision against the installed model's own argmin
    # for its key, decided afresh here
    fresh = AdsalaRuntime()
    fresh.register(load_subroutine(artifact))
    mismatch = [list(k) for k in sorted(harvested)
                if rt.peek(k[1], k[3], k[2], k[0])
                != fresh.select(k[1], k[3], k[2], backend=k[0])]
    decisions = {"model_evals": stats.model_evals,
                 "default_calls": stats.default_calls,
                 "calls": stats.calls, "cache_hits": stats.cache_hits,
                 "eval_failures": rt.stats.eval_failures,
                 "warm_started": warm_started,
                 "requested": len(requested), "harvested": len(harvested),
                 "keys_equal": requested == harvested,
                 "argmin_mismatch": mismatch,
                 "fresh_model_evals": fresh.stats.model_evals}

    p_t = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    forced = torch.as_tensor(tokens, dtype=torch.long, device="cuda")
    extra = {k: torch.as_tensor(v, device="cuda") for k, v in stub.items()}

    def label(grid):
        # an expert stack's grid z is the E experts, a linear's the
        # requests; at a decode step only Whisper's cross K and V, which
        # project the encoder's frames, span more than one row tile
        if cfg.n_experts and grid[2] == cfg.n_experts:
            return "expert"
        return "cross K/V" if cfg.family == "audio" and grid[1] > 1 \
            else "linear"

    with torch.inference_mode():
        _, prefill_ms, step_ms, host_ms = _teacher_forced(
            torch, tf, model, cfg, rt, p_t, forced, MODEL_NEW, max_len,
            extra)
        profile = _device_profile(torch, lambda: _teacher_forced(
            torch, tf, model, cfg, rt, p_t, forced, MODEL_CHECK_STEPS,
            max_len, extra), label)
        # the decode steps alone (their prefill before the window)
        caches = tf.init_decode_state(cfg, MODEL_REQUESTS, max_len,
                                      dtype=torch.float32, device="cuda")
        _, enc_out = _prefill(tf, model, cfg, rt, p_t, extra, caches)
        decode_profile = _device_profile(torch, lambda: [
            tf.decode_step(model, forced[:, t:t + 1], caches, cfg,
                           runtime=rt, enc_out=enc_out,
                           pos=MODEL_PROMPT + t)
            for t in range(MODEL_CHECK_STEPS)], label)
        del caches, enc_out
        # Whisper's encoder alone, as the session runs it once a generate
        encoder_profile = (_device_profile(torch, lambda: tf._run_encoder(
            model, extra["frames"], Ctx(cfg, rt)))
            if cfg.family == "audio" else None)
        host_us = _linear_host_us(torch, model, cfg, rt)
        stacks = (_expert_stack_times(torch, model, cfg, rt)
                  if cfg.n_experts else [])
        # the checks' passes: a prefill + MODEL_CHECK_STEPS steps, routed
        # and plain, teacher-forced on the plain model's greedy tokens, so
        # that the plain run, whose layer inputs the checks replay, is the
        # same in every install (a routed run of an ill-conditioned model
        # such as rwkv6 parts from it as its knobs do)
        plain_tokens = ServeSession(cfg=plain, params=model, max_len=max_len,
                                    device="cuda").generate(
            prompts, max_new=MODEL_NEW, **stub)
        check = torch.as_tensor(plain_tokens, dtype=torch.long,
                                device="cuda")
        # every MoE layer's input captured in both; in the routed run every
        # GEMM call held against torch.matmul on its operands, and those
        # operands rounded to TF32 against it; in the plain run every
        # layer's input and cache, and the final hidden state
        captured, calls = {}, []
        run_op = kops.run_op

        def checked(op, operands, **kw):
            out = run_op(op, operands, **kw)
            want = torch.matmul(*operands)
            calls.append((_rel_err(out, want), _rel_err(
                torch.matmul(*map(_tf32, operands)), want)))
            return out

        for c, r in ((cfg, rt), (plain, None)):
            seen, remove = _moe_inputs(torch, model)
            if r is None:
                layer_in, finals, remove_layers = _layer_inputs(torch, model)
            with mock.patch.object(kops, "run_op", checked):
                logits, _, _, _ = _teacher_forced(
                    torch, tf, model, c, r, p_t, check, MODEL_CHECK_STEPS,
                    max_len, extra)
            remove()
            captured[c.use_pallas_gemm] = (logits, seen)
        remove_layers()
        want = captured[False][0]
        err = _logits_err(captured[True][0], want)
        # every layer, and the final norm and LM head, routed and plain on
        # the same captured input (and cache)
        layer_want = _layer_outputs(model, plain, None, layer_in)
        layer_got = _layer_outputs(model, cfg, rt, layer_in)
        head_want = _head_outputs(model, plain, None, finals)
        head_err = _logits_err(_head_outputs(model, cfg, rt, finals),
                               head_want)
        parity, flips = [], {"routings": 0, "flips": []}
        if cfg.n_experts:
            parity = _moe_parity(torch, model, cfg, plain, rt,
                                 captured[True][1])
            flips = _routing_flips(torch, model, cfg, captured[True][1],
                                   captured[False][1])
        del captured
        # the recurrent families: the chunked scan against the recurrence
        ssm = (_scan_gap(torch, tf, model, cfg, rt, p_t, max_len)
               if cfg.family in ("hybrid", "ssm") else None)
        _, plain_prefill_ms, plain_step_ms, plain_host_ms = _teacher_forced(
            torch, tf, model, plain, None, p_t, forced, MODEL_NEW, max_len,
            extra)

        def plain_logits():
            return _teacher_forced(torch, tf, model, plain, None, p_t, check,
                                   MODEL_CHECK_STEPS, max_len, extra)[0]

        def plain_pieces():
            return (plain_logits(),
                    _layer_outputs(model, plain, None, layer_in),
                    _head_outputs(model, plain, None, finals))

        # the model's own float32 noise floor: the same plain passes, each
        # layer's and the head's, with every weight the GEMM kernel reads
        # one ulp up
        weights = _gemm_weights(model)
        nudged, layer_nudged, head_nudged = _one_ulp(torch, weights,
                                                     plain_pieces)
        floor = _logits_err(nudged, want)
        head_floor = _logits_err(head_nudged, head_want)
        layer_err = [(i, x.shape[1], _rel_err(got, w), _rel_err(up, w))
                     for (i, x, _, _), got, up, w in zip(
                         layer_in, layer_got, layer_nudged, layer_want,
                         strict=True)]
        del layer_got, layer_nudged
        # the recurrent families: the logits' floor again with the scans'
        # clamp of the running log-decay out of reach, in this process
        # only, to show what the clamp adds to it
        free_floor = None
        if cfg.family in ("hybrid", "ssm"):
            from repro_torch.models import mamba2, rwkv6
            with mock.patch.object(mamba2, "CUM_FLOOR", -math.inf), \
                    mock.patch.object(rwkv6, "CUM_FLOOR", -math.inf):
                free_floor = _logits_err(
                    _one_ulp(torch, weights, plain_logits), plain_logits())
        # the precision the limits must reject: the same plain passes, and
        # each layer's and the head's, with those weights rounded to TF32's
        # 10-bit mantissa, in place (the model's last use)
        for w in weights:
            w.copy_(_tf32(w))
        rounded, layer_rounded, head_rounded = plain_pieces()
        tf32_err = _logits_err(rounded, want)
        layer_tf32 = max(_rel_err(got, w) for got, w in zip(
            layer_rounded, layer_want, strict=True))
        head_tf32 = _logits_err(head_rounded, head_want)
        # the process's peak, the checks' temporaries included
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("MODEL_RESULT " + json.dumps({
        "arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
        "full_layers": full.n_layers, "enc_seq": cfg.enc_seq,
        "d_model": cfg.d_model, "segments": cfg.segments(),
        "init_s": init_s, "generate_s": generate_s,
        "launches": launches, "decisions": decisions,
        "tokens": tokens.tolist(), "plain_tokens": plain_tokens.tolist(),
        "prefill_ms": prefill_ms, "step_ms": step_ms, "host_ms": host_ms,
        "plain_prefill_ms": plain_prefill_ms, "plain_step_ms": plain_step_ms,
        "plain_host_ms": plain_host_ms, "host_us": host_us,
        "err": err, "tf32_err": tf32_err, "floor": floor,
        "free_floor": free_floor, "layer_err": layer_err,
        "layer_tf32": layer_tf32, "calls": len(calls),
        "call_err": max(e for e, _ in calls),
        "call_tf32": min(t for _, t in calls), "head_err": head_err,
        "head_tf32": head_tf32, "head_floor": head_floor, "peak_gb": peak_gb,
        "parity": parity, "flips": flips, "stacks": stacks, "ssm": ssm,
        "profile": profile, "decode_profile": decode_profile,
        "encoder_profile": encoder_profile,
        "reckoning": _reckoning(cfg, MODEL_REQUESTS, MODEL_PROMPT,
                                max_len)}), flush=True)


def report_model(card: str, arch: str, res: dict) -> None:
    """Print a model phase's lines (the tag of :data:`MODEL_PHASES`) and
    fail unless it served ``arch`` at full width and depth through the
    installed GEMM model's knobs, one launch per linear and expert stack
    and pass, every GEMM call, every layer, every MoE layer and the final
    norm and LM head within ``F32_TOL`` of their plain versions on the
    same input (the calls', layers' and head's TF32 readings above it),
    and the logits within :data:`MODEL_TOL` of the plain version (the TF32
    reading above it), or :data:`FLOOR_FACTOR` times the plain model's own
    float32 noise floor where that floor lies above the limit, or apart
    only through routing flips that are near ties.  A model of
    :data:`MODEL_CUTS` is held to its cut depth, which the lines name."""
    tag, n_params, n_layers, d_model, _ = MODEL_PHASES[arch]
    rk = res["reckoning"]
    expected = (rk["calls_encoder"] + rk["calls_prefill"]
                + MODEL_NEW * rk["calls_decode"])
    encoder = (f"{rk['calls_encoder']} (the encoder, once) + "
               if rk["calls_encoder"] else "")
    depth = ("full width and depth" if arch not in MODEL_CUTS else
             f"full width and a cut depth, {MODEL_CUTS[arch]} of its "
             f"{res['full_layers']} layers")
    steps = sorted(res["step_ms"])
    mid = len(steps) // 2
    host_med = sorted(res["host_ms"])[mid]
    tokens = MODEL_REQUESTS * MODEL_PROMPT
    agree = [sum(a == b for a, b in zip(r, p))
             for r, p in zip(res["tokens"], res["plain_tokens"])]
    print(f"[{tag}] [{card}] {res['arch']} at {depth}: {res['layers']} "
          f"layers {res['segments']}, d_model {res['d_model']}, "
          f"{res['params']:,} parameters (float32), initialised on the card "
          f"in {res['init_s']:.2f} s; peak {res['peak_gb']:.2f} GB "
          f"allocated", flush=True)
    print(f"[{tag}] [{card}] generate: {MODEL_REQUESTS} requests x "
          f"{MODEL_PROMPT} prompt tokens, {MODEL_NEW} new (greedy) in "
          f"{res['generate_s']:.3f} s; launches {res['launches']} (expected "
          f"gemm {encoder}{rk['calls_prefill']} + {MODEL_NEW} x "
          f"{rk['calls_decode']} = {expected}); decisions "
          f"{res['decisions']}", flush=True)
    print(f"[{tag}] [{card}] prefill{' (the encoder included)' * bool(encoder)}"
          f" {res['prefill_ms']:.3f} ms "
          f"({tokens / res['prefill_ms'] * 1e3:.1f} tokens/s; plain "
          f"{res['plain_prefill_ms']:.3f} ms) | decode per step median "
          f"{steps[mid]:.3f} ms over {len(steps)} (min {steps[0]:.3f}, max "
          f"{steps[-1]:.3f}; plain median "
          f"{sorted(res['plain_step_ms'])[mid]:.3f} ms) | host per step "
          f"median {host_med:.3f} ms (plain "
          f"{sorted(res['plain_host_ms'])[mid]:.3f} ms; CUDA events between "
          f"passes, teacher-forced on the generated tokens)", flush=True)
    for name, prof, n in (("one prefill + ", res["profile"], 1),
                          ("", res["decode_profile"], MODEL_CHECK_STEPS)):
        split = prof["gemm_by_label"]
        apart = "" if not res["stacks"] else (
            "; expert stacks {:.3f} ms, other linears {:.3f} ms".format(
                split.get("expert", 0.0), split.get("linear", 0.0))
            if split else "; expert stacks apart not measured")
        print(f"[{tag}] [{card}] profile of {name}{MODEL_CHECK_STEPS} decode "
              f"steps (torch.profiler, device activity): window "
              f"{prof['window_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms "
              f"({prof['busy_ms'] / n:.3f} ms a "
              f"{'window' if n == 1 else 'step'}), idle share "
              f"{prof['idle_share']:.4f}; GEMM kernel {prof['gemm_ms']:.3f} "
              f"ms = {prof['gemm_share']:.4f} of device time "
              f"{prof['device_ms']:.3f} ms{apart}", flush=True)
    cross = (res["decode_profile"]["gemm_by_label"] or {}) if encoder else {}
    if encoder:
        per_step = {k: ms / MODEL_CHECK_STEPS for k, ms in cross.items()}
        print(f"[{tag}:cross] [{card}] a decode step's cross-attention K and "
              f"V projections of the encoder's {MODEL_REQUESTS} x "
              f"{res['enc_seq']} frames (recomputed every step, as the "
              f"reference does): " + (
                  f"{per_step.get('cross K/V', 0.0):.3f} ms of the step's GEMM "
                  f"{sum(per_step.values()):.3f} ms (device time, "
                  f"{MODEL_CHECK_STEPS} steps alone); their operations "
                  f"{rk['cross_flop'] / 1e12:.3f} TFLOP = "
                  f"{rk['cross_flop'] / F32_PEAK_FLOPS * 1e3:.3f} ms at "
                  f"{F32_PEAK_FLOPS / 1e12:.0f} TFLOP/s" if cross else
                  "not measured (launches and profiled kernels differ)"),
              flush=True)
        enc = res["encoder_profile"]
        print(f"[{tag}:encoder] [{card}] the encoder alone ({rk['calls_encoder']}"
              f" GEMM launches, once a generate): busy {enc['busy_ms']:.3f} "
              f"ms of a {enc['window_ms']:.3f} ms window; GEMM kernel "
              f"{enc['gemm_ms']:.3f} ms = {enc['gemm_share']:.4f} of device "
              f"time; its GEMM operations {rk['encoder_flop'] / 1e12:.3f} "
              f"TFLOP = {rk['encoder_flop'] / F32_PEAK_FLOPS * 1e3:.3f} ms at "
              f"{F32_PEAK_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    for name, ms in res["profile"]["top"]:
        print(f"[{tag}:top] [{card}] {ms:10.3f} ms  {name}", flush=True)
    at, host_us = res["host_us"]
    print(f"[{tag}:host] [{card}] per call at {at}, over "
          f"{MODEL_HOST_CALLS} calls: " + ", ".join(
              f"{how} {us:.2f} us" for how, us in host_us.items()),
          flush=True)
    for row in res["stacks"]:
        print(f"[{tag}:stack] [{card}] {row['label']} knob {row['knob']}: "
              f"kernel {row['ms']:.4f} ms, plain (einsum) "
              f"{row['plain_ms']:.4f} ms, torch.bmm {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); rel "
              f"err vs plain {row['rel_err']:.2e}; copy ops {row['copies']}",
              flush=True)
    experts = (f", the experts {rk['expert_flop'] / 1e12:.3f} TFLOP at "
               f"capacity {rk['capacity']}: {rk['useful_rows']:,} of "
               f"{rk['expert_rows']:,} expert rows a layer carry a token "
               f"({rk['useful_rows'] / rk['expert_rows']:.4f})"
               if rk["expert_rows"] else "")
    print(f"[{tag}:reckoning] a decode step's GEMMs read "
          f"{rk['expert_floats']:,} expert floats and {rk['other_floats']:,} "
          f"others ({4e-9 * (rk['expert_floats'] + rk['other_floats']):.2f} "
          f"GB): {rk['decode_bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12} "
          f"TB/s, {rk['decode_launched_ms']:.3f} ms as launched (each "
          f"expert once, the other weights by each of the {MODEL_REQUESTS} "
          f"stacked items), its operations {rk['decode_flop'] / 1e12:.3f} "
          f"TFLOP = {rk['decode_ops_ms']:.3f} ms; prefill "
          f"{rk['prefill_flop'] / 1e12:.3f} TFLOP "
          f"= {rk['prefill_ops_ms']:.3f} ms at "
          f"{F32_PEAK_FLOPS / 1e12:.0f} TFLOP/s{experts}; decode state "
          + " + ".join(f"{part} {nbytes / 1e6:.1f} MB" for part, nbytes
                       in rk["state_bytes"].items() if nbytes)
          + f"; {rk['calls_prefill']} GEMM calls a prefill, "
          f"{rk['calls_decode']} a decode step"
          + (f", {rk['calls_encoder']} the encoder's" if encoder else ""),
          flush=True)
    worst = max(res["parity"], key=lambda r: r[2], default=None)
    if worst is not None:
        print(f"[{tag}] [{card}] per-layer MoE, routed vs plain on the same "
              f"captured input ({len(res['parity'])} layer passes): max rel "
              f"err {worst[2]:.3e} (layer {worst[0]}, {worst[1]} tokens), "
              f"limit {F32_TOL:.0e}", flush=True)
    fl = res["flips"]
    roots = [f for f in fl["flips"] if f["root"]]
    if fl["routings"]:
        print(f"[{tag}] [{card}] routing flips, routed vs plain run: "
              f"{len(fl['flips'])} of {fl['routings']} routings "
              f"({len(roots)} with inputs within {F32_TOL:.0e})", flush=True)
    for f in fl["flips"][:20]:
        print(f"[{tag}:flip] layer {f['layer']} capture {f['capture']} "
              f"request {f['b']} token {f['s']}: p_k {f['p_k']:.9f} "
              f"p_k+1 {f['p_k1']:.9f} gap {f['gap']:.3e} of the top, input "
              f"diff {f['input_diff']:.3e}"
              f"{' (root)' if f['root'] else ''}", flush=True)
    gap = res["ssm"]
    if gap is not None:
        print(f"[ssm] [{card}] {res['arch']}: the chunked prefill (chunk "
              f"length {gap['chunk']}) against the same {MODEL_PROMPT} "
              f"tokens fed one at a time through decode_step: "
              f"last-position logits rel "
              f"gap {gap['logits']:.3e} (argmax agrees for "
              f"{gap['argmax_agree']}/{MODEL_REQUESTS} requests); carried "
              f"state rel gap over {gap['states']} layers max "
              f"{gap['state_max']:.3e}, min {gap['state_min']:.3e}, first "
              f"{gap['state_first']:.3e}, last {gap['state_last']:.3e} (the "
              f"reference's -30 clamp of the running log-decay; not gated)",
              flush=True)
    free = ("" if res["free_floor"] is None else
            f" ({res['free_floor']:.3e} with the scans' -30 clamp of the "
            f"running log-decay out of reach)")
    print(f"[{tag}] [{card}] teacher-forced logits, prefill + "
          f"{MODEL_CHECK_STEPS} decode steps on the plain model's greedy "
          f"tokens: routed vs plain (torch.matmul and einsum, TF32 off) "
          f"{res['err']:.3e}, TF32-rounded weights vs "
          f"plain {res['tf32_err']:.3e}, limit {MODEL_TOL:.0e} (where the "
          f"floor lies above it, {FLOOR_FACTOR:g} x the floor); the plain "
          f"model's own float32 noise floor (every GEMM weight one ulp up) "
          f"{res['floor']:.3e}{free}", flush=True)
    layer = max(res["layer_err"], key=lambda r: r[2])
    print(f"[{tag}] [{card}] every layer routed vs plain on the plain "
          f"run's captured input and cache ({len(res['layer_err'])} layer "
          f"passes): max rel err {layer[2]:.3e} (layer {layer[0]}, {layer[1]} "
          f"tokens; that pass's 1-ulp floor {layer[3]:.3e}), largest 1-ulp "
          f"floor {max(r[3] for r in res['layer_err']):.3e}, TF32-rounded "
          f"weights {res['layer_tf32']:.3e}, limit {F32_TOL:.0e}",
          flush=True)
    print(f"[{tag}] [{card}] every GEMM call of the routed teacher-forced "
          f"passes against torch.matmul on its operands ({res['calls']} "
          f"calls): max rel err {res['call_err']:.3e}, TF32-rounded operands "
          f"least {res['call_tf32']:.3e}, limit {F32_TOL:.0e}", flush=True)
    print(f"[{tag}] [{card}] final norm + LM head routed vs plain on the "
          f"plain run's final hidden state ({MODEL_CHECK_STEPS + 1} passes): "
          f"max rel err {res['head_err']:.3e}, 1-ulp floor "
          f"{res['head_floor']:.3e}, TF32-rounded weights "
          f"{res['head_tf32']:.3e}, limit {F32_TOL:.0e}", flush=True)
    for r, p, n in zip(res["tokens"], res["plain_tokens"], agree):
        print(f"[{tag}:tokens] routed {r}\n[{tag}:tokens] plain  {p} "
              f"({n}/{MODEL_NEW} agree)", flush=True)
    print(f"[{tag}] greedy tokens agree at {sum(agree)}/"
          f"{MODEL_REQUESTS * MODEL_NEW} positions", flush=True)
    if (res["params"], res["layers"], res["d_model"]) \
            != (n_params, n_layers, d_model):
        raise SystemExit(f"[{tag}] not {arch} at {depth}: "
                         f"{res['params']} parameters, {res['layers']} "
                         f"layers")
    want = {k: 0 for k in KERNELS}
    want["gemm"] = expected
    if res["launches"] != want:
        raise SystemExit(f"[{tag}] launches {res['launches']}, expected "
                         f"{want}")
    dec = res["decisions"]
    print(f"[{tag}:prewarm] the first generate from the prewarmed decision "
          f"cache ({dec['warm_started']} entries loaded): {dec['calls']} "
          f"calls, {dec['cache_hits']} cache hits, {dec['model_evals']} model "
          f"evals, {dec['default_calls']} default calls; {dec['requested']} "
          f"keys asked for, {dec['harvested']} harvested, equal "
          f"{dec['keys_equal']}; prewarmed decisions off the installed "
          f"model's argmin: {len(dec['argmin_mismatch'])} of "
          f"{dec['fresh_model_evals']}", flush=True)
    # a decision must come from the installed model, not a default: with
    # the prewarmed cache every one is a cache hit of the model's argmin
    if dec["default_calls"] != 0 or dec["model_evals"] != 0 \
            or dec["eval_failures"] or dec["cache_hits"] != dec["calls"] \
            or not dec["keys_equal"] or dec["argmin_mismatch"] \
            or dec["fresh_model_evals"] != dec["harvested"]:
        raise SystemExit(f"[{tag}] the first generate did not serve the "
                         f"installed model's decisions from the prewarmed "
                         f"cache: {dec}")
    copied = [row["label"] for row in res["stacks"] if row["copies"]]
    if copied or not all(row["rel_err"] < F32_TOL for row in res["stacks"]):
        raise SystemExit(f"[{tag}] expert stacks copied on dispatch "
                         f"({copied}) or off their plain version")
    if worst is not None and not worst[2] < F32_TOL:
        raise SystemExit(f"[{tag}] layer {worst[0]}: routed MoE "
                         f"{worst[2]:.3e} from its plain version")
    if not MODEL_TOL < res["tf32_err"]:
        raise SystemExit(f"[{tag}] TF32-rounded weights {res['tf32_err']:.3e}"
                         f" within the limit {MODEL_TOL:.0e}")
    if not layer[2] < F32_TOL or not F32_TOL < res["layer_tf32"]:
        raise SystemExit(f"[{tag}] layer {layer[0]}: routed {layer[2]:.3e} "
                         f"from its plain version on the same input, TF32 "
                         f"{res['layer_tf32']:.3e}, limit {F32_TOL:.0e}")
    if not res["call_err"] < F32_TOL or not F32_TOL < res["call_tf32"]:
        raise SystemExit(f"[{tag}] GEMM calls: routed {res['call_err']:.3e} "
                         f"from torch.matmul on the same operands, TF32 "
                         f"least {res['call_tf32']:.3e}, limit {F32_TOL:.0e}")
    if not res["head_err"] < F32_TOL or not F32_TOL < res["head_tf32"]:
        raise SystemExit(f"[{tag}] final norm + LM head: routed "
                         f"{res['head_err']:.3e} from its plain version on "
                         f"the same input, TF32 {res['head_tf32']:.3e}, limit "
                         f"{F32_TOL:.0e}")
    wide = [f for f in roots if not f["gap"] < NEAR_TIE]
    if wide or (fl["flips"] and not roots):
        raise SystemExit(f"[{tag}] routing flips not explained by near ties "
                         f"(gap under {NEAR_TIE:.0e} of the top): "
                         f"{wide or fl['flips'][:3]}")
    # apart by more than the limit only through near-tie routing flips;
    # where the model's own float32 noise floor lies above the limit, the
    # logits are held to FLOOR_FACTOR x that floor (the kernel is judged by
    # every layer and the head on their captured inputs, held above)
    limit = (MODEL_TOL if res["floor"] < MODEL_TOL
             else FLOOR_FACTOR * res["floor"])
    if not res["err"] < limit and not roots:
        raise SystemExit(f"[{tag}] logits {res['err']:.3e} against the plain "
                         f"version with no routing flip, limit {limit:.3e} "
                         f"(noise floor {res['floor']:.3e})")


# -- phase 8, training: fresh processes after phase 6f's ------------------

def _whole(t):
    """A DTensor's gathered value; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _param_samples(params) -> dict:
    """A strided sample of at most ~4096 values of every parameter (a
    DTensor's from its gathered value), to tell whether each moved without
    a copy of the model."""
    return {k: _whole(p.detach()).reshape(-1)[::max(1, p.numel() // 4096)]
            .clone() for k, p in params.named_parameters()}


def _unmoved(torch, params, before: dict) -> list:
    return [k for k, s in _param_samples(params).items()
            if torch.equal(s, before[k])]


def train_families(torch, card: str, root: Path) -> None:
    """8a: every architecture's smoke config takes :data:`TRAIN_SMOKE_STEPS`
    ``TrainLoop.step_fn`` steps on the card at its own numerics (Whisper's
    and the VLM's stub inputs beside the tokens).  Fails unless every loss
    and gradient norm (so every gradient) is finite and every parameter
    moved."""
    import numpy as np
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHITECTURES, get_smoke_config
    from repro_torch.data import SyntheticLMDataset, make_device_batch
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    for arch in ARCHITECTURES:
        cfg = get_smoke_config(arch)
        ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=2)
        loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(lr=1e-3, warmup_steps=1),
                         ckpt=Checkpointer(root / cfg.name), dataset=ds)
        state = loop.init_state(SEED)
        before = _param_samples(state["params"])
        rng = np.random.default_rng(SEED)
        losses, norms = [], []
        for step in range(TRAIN_SMOKE_STEPS):
            batch = make_device_batch({**ds.batch_at(step),
                                       **stub_inputs(cfg, 2, rng)},
                                      loop.device)
            p, o, ef, m = loop.step_fn(state["params"], state["opt"],
                                       state["ef"], batch)
            state = {"params": p, "opt": o, "ef": ef}
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        unmoved = _unmoved(torch, state["params"], before)
        print(f"[train:families] [{card}] {cfg.name} ({cfg.family}): "
              f"{sum(x.numel() for x in state['params'].parameters()):,} "
              f"parameters on {loop.device}, losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}, grad norms "
              f"{' '.join(f'{x:.4f}' for x in norms)}, "
              f"{len(before) - len(unmoved)}/{len(before)} parameters "
              f"moved", flush=True)
        if not all(map(math.isfinite, losses + norms)) or unmoved:
            raise SystemExit(f"[train:families] {arch}: a loss or gradient "
                             f"is not finite, or {unmoved} did not move")
        del state, p, o, ef, m
        torch.cuda.empty_cache()


def train_gradient(torch, card: str, root: Path) -> None:
    """8b: llama3-8b at full width and :data:`GRAD_LAYERS` layers, float32
    compute with TF32 off, one batch of :data:`TRAIN_BATCH` x
    :data:`TRAIN_SEQ`: the loss and every parameter's gradient against a
    float64 copy of the same weights on the same batch.  Fails unless
    every gradient's max |error| / max |g_f64| is within
    :data:`GRAD_TOL` and the loss's relative error within
    :data:`GRAD_LOSS_TOL`."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_device_batch
    from repro_torch.models import init_params, loss_fn
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=GRAD_LAYERS,
                              compute_dtype="float32")
    batch = make_device_batch(SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=SEED).batch_at(0), "cuda")
    out = {}
    for dtype in ("float32", "float64"):
        t0 = time.perf_counter()
        # the same draw both times; the float64 copy holds the same values
        model = init_params(SEED, cfg, device="cuda")
        if dtype == "float64":
            model.double()
        model.requires_grad_(True)
        loss, _ = loss_fn(model, batch,
                          dataclasses.replace(cfg, compute_dtype=dtype))
        loss.backward()
        loss = loss.detach()
        out[dtype] = (loss, {k: p.grad for k, p in
                             model.named_parameters()})
        torch.cuda.synchronize()
        print(f"[train:grad] {dtype}: loss {loss.item():.9f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del model, loss
    (l32, g32), (l64, g64) = out["float32"], out["float64"]
    loss_err = abs(float(l32) - float(l64)) / abs(float(l64))
    errs = {k: float((g32[k].double() - g64[k]).abs().max()
                     / g64[k].abs().max()) for k in g64}
    worst = max(errs, key=errs.get)
    print(f"[train:grad] [{card}] {cfg.name} full width, {GRAD_LAYERS} "
          f"layers, {sum(g.numel() for g in g64.values()):,} parameters, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, float32 (TF32 off) vs "
          f"float64 on the card: loss rel err {loss_err:.3e} (limit "
          f"{GRAD_LOSS_TOL:g}); largest gradient error {errs[worst]:.3e} "
          f"of max |g_f64| at {worst} (limit {GRAD_TOL:g}); median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)} "
          f"tensors", flush=True)
    if not (loss_err <= GRAD_LOSS_TOL and errs[worst] <= GRAD_TOL):
        raise SystemExit("[train:grad] float32 gradients off float64")
    del out, g32, g64
    torch.cuda.empty_cache()


def _annotated_ms(prof, name: str) -> float:
    """Device ms of the kernels launched inside the ``record_function``
    ranges called ``name`` (their host-side events' kernels)."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def _step_profile(torch, fn) -> dict:
    """Two calls of ``fn`` under ``torch.profiler``.  The first traces the
    device alone (host tracing slows the host, which would read as device
    idle time): the device time of its kernels, the device's idle share
    between its first and last kernel, the top kernels.  The second traces
    the host too, for the optimiser's and the clip's kernel time (their
    ``record_function`` ranges, ``optim/adamw.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise SystemExit("[train:step] torch.profiler recorded no device "
                         "time")
    spans = sorted((s, e) for s, e, _ in ops)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:MODEL_TOP_OPS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window,
            "device_ms": sum(by_name.values()) / 1e3,
            "adamw_ms": _annotated_ms(prof, "adamw_update"),
            "clip_ms": _annotated_ms(prof, "clip_by_global_norm"),
            "top": [(name[:90], us / 1e3) for name, us in top]}


def train_full_width(torch, card: str, root: Path) -> None:
    """8c: llama3-8b at full width and the depth of :data:`TRAIN_CUTS`
    (12 of its 32 layers) at the config's own numerics
    (float32 parameters, bf16 compute, remat ``nested``, ``ce_chunk``
    2048), ``launch/train.py``'s defaults (batch 8, seq 128, lr 3e-4, the
    schedule its ``main`` derives for :data:`TRAIN_STEPS` steps), from
    ``SyntheticLMDataset``: :data:`TRAIN_STEPS` ``TrainLoop.step_fn``
    steps, then one more under the profiler.  Fails unless every loss and
    gradient norm is finite, the first loss lies within 1.0 of ln V, every
    parameter moved, no hand-written kernel launched and the peak memory
    stayed under the card's."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_device_batch
    from repro_torch.kernels import introspect
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    full = get_config("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_CUTS["llama3-8b"])
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED)
    loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(
        lr=3e-4, total_steps=TRAIN_STEPS,
        warmup_steps=max(TRAIN_STEPS // 20, 5)),
        ckpt=Checkpointer(root / "full_width"), dataset=ds)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.init_state(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    named = dict(state["params"].named_parameters())
    n_params = sum(p.numel() for p in named.values())
    state_gb = 16 * n_params / 1e9     # f32 parameters, grads, two moments
    before = _param_samples(state["params"])
    introspect.reset_launches()
    mem0 = torch.cuda.memory_stats()
    losses, norms, times = [], [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = make_device_batch(ds.batch_at(step), loop.device)
        p, o, ef, m = loop.step_fn(state["params"], state["opt"],
                                   state["ef"], batch)
        state = {"params": p, "opt": o, "ef": ef}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = sum(introspect.launch_counts().values())
    mem1 = torch.cuda.memory_stats()
    # the caching allocator's cudaMalloc calls and its retries (a retry
    # frees the cache and synchronises the host with the card)
    allocs = {k: mem1.get(k, 0) - mem0.get(k, 0)
              for k in ("num_device_alloc", "num_alloc_retries")}
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    unmoved = _unmoved(torch, state["params"], before)
    batch = make_device_batch(ds.batch_at(TRAIN_STEPS), loop.device)
    prof = _step_profile(torch, lambda: loop.step_fn(
        state["params"], state["opt"], state["ef"], batch))
    step_ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs of a step: 6 N T over the matmul parameters (all but
    # the embedding table, a gather), plus attention's 12 L S d T (QK^T
    # and PV, forward and backward, over the full S x S); no recompute
    n_matmul = n_params - named["embed.table"].numel()
    flops = tokens * (6 * n_matmul
                      + 12 * cfg.n_layers * TRAIN_SEQ * cfg.d_model)
    tflops = flops / (step_ms / 1e3) / 1e12
    ln_v = math.log(cfg.vocab)
    print(f"[train:step] [{card}] {cfg.name} full width (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) at "
          f"{cfg.n_layers} of {full.n_layers} layers: {n_params:,} "
          f"parameters ({state_gb:.2f} GB of f32 parameters, gradients and "
          f"moments), {cfg.compute_dtype} compute, remat {cfg.remat}, "
          f"ce_chunk {cfg.ce_chunk}; drawn in {init_s:.1f} s", flush=True)
    print(f"[train:step] losses {' '.join(f'{x:.4f}' for x in losses)} "
          f"(ln V = {ln_v:.4f}); grad norms "
          f"{' '.join(f'{x:.4f}' for x in norms)}", flush=True)
    print(f"[train:step] [{card}] step ms {step_ms:.3f} (median of steps "
          f"2-{TRAIN_STEPS}; all: {' '.join(f'{t * 1e3:.1f}' for t in times)}"
          f"), {tokens / (step_ms / 1e3):.1f} tokens/s ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ} a step); model {tflops:.2f} TFLOP/s "
          f"({flops / 1e12:.3f} TFLOP a step: 6 N T over {n_matmul:,} "
          f"matmul parameters + attention, no recompute) = "
          f"{tflops / BF16_PEAK_TFLOPS:.4f} of the dense bf16 peak "
          f"{BF16_PEAK_TFLOPS} TFLOP/s (NVIDIA's H100 SXM data sheet)",
          flush=True)
    print(f"[train:step] [{card}] profiled steps {TRAIN_STEPS + 1}-"
          f"{TRAIN_STEPS + 2}: device {prof['device_ms']:.3f} ms of kernels "
          f"over a {prof['window_ms']:.3f} ms window, idle share "
          f"{prof['idle_share']:.4f}; adamw_update {prof['adamw_ms']:.3f} "
          f"ms of kernels ({prof['adamw_ms'] / prof['device_ms']:.4f} of "
          f"the step's), of which clip_by_global_norm "
          f"{prof['clip_ms']:.3f} ms", flush=True)
    for name, ms in prof["top"]:
        print(f"[train:top] {ms:9.3f} ms  {name}")
    print(f"[train:step] peak memory {peak / 1e9:.2f} GB of the card's "
          f"{card_bytes / 1e9:.2f} GB (state {state_gb:.2f} GB); "
          f"allocator over the {TRAIN_STEPS} steps: {allocs}; "
          f"hand-written kernel launches {launches}; "
          f"{len(before) - len(unmoved)}/{len(before)} parameters moved",
          flush=True)
    if not all(map(math.isfinite, losses + norms)):
        raise SystemExit("[train:step] a loss or gradient norm is not "
                         "finite")
    if not abs(losses[0] - ln_v) <= 1.0:
        raise SystemExit(f"[train:step] first loss {losses[0]:.4f} is not "
                         f"within 1.0 of ln V {ln_v:.4f}")
    if unmoved or launches or not peak < card_bytes:
        raise SystemExit(f"[train:step] unmoved {unmoved}, launches "
                         f"{launches}, peak {peak}")
    if not prof["adamw_ms"] > 0:
        raise SystemExit("[train:step] the profile holds no optimiser time")


def train_main(root: str) -> None:
    """Phases 8a-8c in a fresh process (:func:`train_families`,
    :func:`train_gradient`, then :func:`train_full_width`, the 8b models
    freed before the 12-layer one is built; their checkpointers under
    ``root``, never written); each prints its ``[train:*]`` lines and
    exits non-zero when a gate fails."""
    faulthandler.dump_traceback_later(TRAIN_TIMEOUT_S - 10, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    for phase in (train_families, train_gradient, train_full_width):
        t0 = time.perf_counter()
        phase(torch, card, Path(root))
        print(f"[train] {phase.__name__} {time.perf_counter() - t0:.1f} s",
              flush=True)


def resume_main(root: str) -> None:
    """8d in a fresh process with ``CUBLAS_WORKSPACE_CONFIG`` set, under
    ``torch.use_deterministic_algorithms(True)``: the example's reduced
    config (``examples/torch_train_lm.py``) through ``TrainLoop.run`` with
    a preemption notice during step :data:`RESUME_AT`, a checkpoint there
    and a clean exit, then ``restore_or_init`` and ``run`` to
    :data:`RESUME_STEPS`; and :data:`RESUME_STEPS` steps uninterrupted.
    Fails unless the restored state equals the saved one and the losses
    and final parameters equal the uninterrupted run's, bit for bit."""
    faulthandler.dump_traceback_later(RESUME_TIMEOUT_S - 10, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import importlib.util
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import PreemptionGuard
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    torch.use_deterministic_algorithms(True)
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.reduced_config()
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=8)
    guard = PreemptionGuard(install_handlers=False)

    class Preempting:                 # the notice arrives during a step
        def batch_at(self, step):
            if step == RESUME_AT - 1:
                guard.simulate()
            return ds.batch_at(step)

    def loop(name, dataset):
        return TrainLoop(cfg=cfg, adamw=AdamWConfig(lr=1e-3, total_steps=100,
                                                    warmup_steps=5),
                         ckpt=Checkpointer(Path(root) / name),
                         dataset=dataset, ckpt_every=4, log_every=1)

    first = loop("resumed", Preempting())
    res = first.run(RESUME_STEPS, guard=guard)
    saved_steps = first.ckpt.steps()
    second = loop("resumed", ds)
    step, state = second.restore_or_init()
    saved, restored = res["state"], state
    same_state = step == RESUME_AT and all(
        torch.equal(a, b) for a, b in zip(
            [*saved["params"].parameters(), saved["opt"].step,
             *saved["opt"].mu.values(), *saved["opt"].nu.values()],
            [*restored["params"].parameters(), restored["opt"].step,
             *restored["opt"].mu.values(), *restored["opt"].nu.values()],
            strict=True))
    res2 = second.run(RESUME_STEPS, start_step=step, state=state)
    plain = loop("plain", ds).run(RESUME_STEPS)
    resumed = [h["loss"] for h in res["history"] + res2["history"]]
    straight = [h["loss"] for h in plain["history"]]
    same_params = all(torch.equal(a, b) for a, b in zip(
        res2["state"]["params"].parameters(),
        plain["state"]["params"].parameters(), strict=True))
    print(f"[train:resume] deterministic algorithms on, "
          f"CUBLAS_WORKSPACE_CONFIG {os.environ.get('CUBLAS_WORKSPACE_CONFIG')}"
          f": preempted at step {res['final_step']} (checkpoints "
          f"{saved_steps}), restored step {step}, state bit-equal "
          f"{same_state}; resumed to step {res2['final_step']}: losses "
          f"{' '.join(f'{x:.6f}' for x in resumed)}; uninterrupted "
          f"{' '.join(f'{x:.6f}' for x in straight)}; losses bit-equal "
          f"{resumed == straight}, final parameters bit-equal "
          f"{same_params}", flush=True)
    if not (same_state and res2["final_step"] == RESUME_STEPS
            and resumed == straight and same_params):
        raise SystemExit("[train:resume] the resumed run differs")


# -- phase 9 ----------------------------------------------------------------

def mesh_step(torch, card: str, root: Path, device, mesh) -> dict:
    """9a: llama3-8b at full width and :data:`GRAD_LAYERS` layers, float32
    compute with TF32 off, one batch of :data:`TRAIN_BATCH` x
    :data:`TRAIN_SEQ`: one ``TrainLoop.step_fn`` step on ``mesh`` against
    one unsharded step from the same draw.  The gradients are taken as the
    optimiser reads them (``adamw_update``'s argument, after the
    redistribution to the parameters' placements).  Fails unless the loss
    is within :data:`MESH_TOL` relative and each gradient within
    :data:`MESH_TOL` of its max |g|."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_global_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=GRAD_LAYERS,
                              compute_dtype="float32")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED)
    real = train.adamw_update
    seen = {}

    def spy(params, grads, state, cfg_):
        seen["grads"] = {k: _whole(g).detach().clone()
                         for k, g in grads.items()}
        return real(params, grads, state, cfg_)

    out = {}
    train.adamw_update = spy
    try:
        for name, m in (("mesh", mesh), ("unsharded", None)):
            loop = train.TrainLoop(
                cfg=cfg, adamw=AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS),
                ckpt=Checkpointer(root / name), dataset=ds, device=device,
                mesh=m)
            state = loop.init_state(SEED)
            batch = make_global_batch(ds.batch_at(0), m,
                                      None if m is None else batch_axes(m),
                                      device=device)
            t0 = time.perf_counter()
            _, _, _, metrics = loop.step_fn(state["params"], state["opt"],
                                            state["ef"], batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            out[name] = (loss, seen.pop("grads"), time.perf_counter() - t0)
            if m is not None:
                placements = {str(p.placements) for p in
                              state["params"].parameters()}
            del loop, state, batch, metrics
            torch.cuda.empty_cache()
    finally:
        train.adamw_update = real
    (ls, gs, ts), (lu, gu, tu) = out["mesh"], out["unsharded"]
    loss_err = abs(ls - lu) / abs(lu)
    errs = {k: float((gs[k] - g).abs().max() / g.abs().max())
            for k, g in gu.items()}
    worst = max(errs, key=errs.get)
    bit_equal = ls == lu and all(torch.equal(gs[k], g)
                                 for k, g in gu.items())
    print(f"[mesh:grad] [{card}] {cfg.name} full width, {GRAD_LAYERS} "
          f"layers, {sum(g.numel() for g in gu.values()):,} parameters, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, float32 (TF32 off): one "
          f"TrainLoop step on the (1, 1) mesh (parameter placements "
          f"{sorted(placements)}) against one unsharded step: loss "
          f"{ls:.9f} vs {lu:.9f}, rel err {loss_err:.3e} (limit "
          f"{MESH_TOL:g}); largest gradient error {errs[worst]:.3e} of max "
          f"|g| at {worst} (limit {MESH_TOL:g}) over {len(errs)} tensors; "
          f"bit-equal {bit_equal}; step {ts * 1e3:.1f} ms vs "
          f"{tu * 1e3:.1f} ms (first steps)", flush=True)
    if not (loss_err <= MESH_TOL and errs[worst] <= MESH_TOL):
        raise SystemExit("[mesh:grad] the sharded step differs from the "
                         "unsharded one")
    return {"bit_equal": bit_equal}


def mesh_full_width(torch, card: str, root: Path, device, mesh) -> dict:
    """9b: llama3-8b at full width and the depth of :data:`TRAIN_CUTS` at
    its own numerics, :data:`MESH_STEPS` ``step_fn`` steps of
    :data:`TRAIN_BATCH` x :data:`TRAIN_SEQ` on ``mesh``, as 8c on one
    device.  Fails unless every loss and gradient norm is finite, the
    first loss lies within 1.0 of ln V, every parameter moved, no
    hand-written kernel launched and the peak memory stayed under the
    card's."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_global_batch
    from repro_torch.kernels import introspect
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    full = get_config("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_CUTS["llama3-8b"])
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED)
    loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(
        lr=3e-4, total_steps=TRAIN_STEPS,
        warmup_steps=max(TRAIN_STEPS // 20, 5)),
        ckpt=Checkpointer(root / "mesh_full_width"), dataset=ds,
        device=device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.init_state(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    before = _param_samples(state["params"])
    introspect.reset_launches()
    losses, norms, times = [], [], []
    for step in range(MESH_STEPS):
        t0 = time.perf_counter()
        batch = make_global_batch(ds.batch_at(step), mesh, batch_axes(mesh),
                                  device=device)
        p, o, ef, m = loop.step_fn(state["params"], state["opt"],
                                   state["ef"], batch)
        state = {"params": p, "opt": o, "ef": ef}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = sum(introspect.launch_counts().values())
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    unmoved = _unmoved(torch, state["params"], before)
    step_ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    ln_v = math.log(cfg.vocab)
    print(f"[mesh:step] [{card}] {cfg.name} full width at {cfg.n_layers} of "
          f"{full.n_layers} layers on the (1, 1) mesh: {n_params:,} "
          f"parameters, {cfg.compute_dtype} compute, remat {cfg.remat}; "
          f"drawn and laid out in {init_s:.1f} s; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (ln V = {ln_v:.4f}); "
          f"grad norms {' '.join(f'{x:.4f}' for x in norms)}", flush=True)
    print(f"[mesh:step] [{card}] step ms {step_ms:.3f} (median of steps "
          f"2-{MESH_STEPS}; all: {' '.join(f'{t * 1e3:.1f}' for t in times)}"
          f"), {tokens_s:.1f} tokens/s ({TRAIN_BATCH} x {TRAIN_SEQ} a "
          f"step); peak memory {peak / 1e9:.2f} GB of the card's "
          f"{card_bytes / 1e9:.2f} GB; hand-written kernel launches "
          f"{launches}; {len(before) - len(unmoved)}/{len(before)} "
          f"parameters moved", flush=True)
    if not all(map(math.isfinite, losses + norms)):
        raise SystemExit("[mesh:step] a loss or gradient norm is not finite")
    if not abs(losses[0] - ln_v) <= 1.0:
        raise SystemExit(f"[mesh:step] first loss {losses[0]:.4f} is not "
                         f"within 1.0 of ln V {ln_v:.4f}")
    if unmoved or launches or not peak < card_bytes:
        raise SystemExit(f"[mesh:step] unmoved {unmoved}, launches "
                         f"{launches}, peak {peak}")
    return {"step_ms": step_ms, "tokens_s": tokens_s}


def _state_values(state) -> list:
    return [_whole(t).detach() for t in
            [*state["params"].parameters(), state["opt"].step,
             *state["opt"].mu.values(), *state["opt"].nu.values()]]


def mesh_checkpoint(torch, card: str, root: Path, device, mesh) -> dict:
    """9c: the llama3 smoke config trained 2 steps on ``mesh`` and saved;
    the unsharded ``TrainLoop`` restores it (over a draw from another
    seed), trains to step 4 and saves; a loop on ``mesh`` restores that.
    Fails unless both restores equal the saved states bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    cfg = get_smoke_config("llama3-8b")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=4)

    def loop(m):
        return TrainLoop(cfg=cfg, adamw=AdamWConfig(lr=1e-3, warmup_steps=1),
                         ckpt=Checkpointer(root / "mesh_ckpt"), dataset=ds,
                         device=device, mesh=m, log_every=100)

    saved = loop(mesh).run(2, start_step=0,
                           state=loop(mesh).init_state(SEED))["state"]
    one = loop(None)
    step1, state1 = one.restore_or_init(SEED + 1)
    into_one = step1 == 2 and all(
        torch.equal(a, b) for a, b in zip(_state_values(saved),
                                          _state_values(state1), strict=True))
    again = one.run(4, start_step=step1, state=state1)["state"]
    step2, state2 = loop(mesh).restore_or_init(SEED + 1)
    into_mesh = step2 == 4 and all(
        torch.equal(a, b) for a, b in zip(_state_values(again),
                                          _state_values(state2), strict=True))
    print(f"[mesh:ckpt] [{card}] {cfg.name}: saved on the (1, 1) mesh at "
          f"step 2, restored unsharded: step {step1}, bit-equal {into_one}; "
          f"saved unsharded at step 4, restored on the mesh: step {step2}, "
          f"bit-equal {into_mesh}", flush=True)
    if not (into_one and into_mesh):
        raise SystemExit("[mesh:ckpt] a restore across meshes differs")
    return {"ckpt_bit_equal": True}


def dryrun_count(torch, card: str, root: Path, device, mesh) -> dict:
    """10a: 9b's model (llama3-8b at :data:`TRAIN_CUTS` depth, bf16
    compute) and batch on ``mesh``, counted by ``count_step`` as the dry
    run's step on fake DTensors and as a real ``step_fn`` step on the card
    (untimed, after the timed ones).  Fails unless the FLOPs are equal,
    the dry peak bytes lie in :data:`DRYRUN_PEAK_BAND` of the real step's
    ``max_memory_allocated`` and the measured step is not below the
    roofline's ``max(t_compute, t_memory)`` of the dry count."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import Shape, get_config
    from repro_torch.data import SyntheticLMDataset, make_global_batch
    from repro_torch.launch.dryrun import (_active_params, build_step,
                                           fake_mode)
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.specs import rules_for
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline.analysis import model_flops, roofline
    from repro_torch.roofline.counting import count_step
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_CUTS["llama3-8b"])
    shape = Shape("train_128", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    with fake_mode():
        fn, args = build_step(cfg, shape, mesh,
                              rules_for(mesh, "train", cfg), device=device)
        dry = count_step(fn, *args)
    del fn, args
    trace_s = time.perf_counter() - t0
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED)
    loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(
        lr=3e-4, total_steps=TRAIN_STEPS,
        warmup_steps=max(TRAIN_STEPS // 20, 5)),
        ckpt=Checkpointer(root / "dryrun_count"), dataset=ds, device=device,
        mesh=mesh)
    state = loop.init_state(SEED)
    batch = make_global_batch(ds.batch_at(0), mesh, batch_axes(mesh),
                              device=device)
    times, peaks = [], []
    for _ in range(DRYRUN_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, o, ef, _ = loop.step_fn(state["params"], state["opt"],
                                   state["ef"], batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        state = {"params": p, "opt": o, "ef": ef}
    real = count_step(loop.step_fn, state["params"], state["opt"],
                      state["ef"], batch)
    torch.cuda.synchronize()
    step_ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    peak = max(peaks[1:])
    rep = roofline(arch=cfg.name, shape=shape.name, mesh="1x1", chips=1,
                   hlo_flops=float(dry["flops"]),
                   hlo_bytes=float(dry["bytes"]),
                   collective_bytes=float(dry["coll"]["total_operand_bytes"]),
                   model_flops_=model_flops(cfg, shape,
                                            _active_params(cfg)))
    bound_ms = max(rep.t_compute, rep.t_memory) * 1e3
    ratio = dry["peak_bytes"] / peak
    print(f"[dryrun:count] [{card}] {cfg.name} at {cfg.n_layers} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.compute_dtype} compute, the "
          f"(1, 1) mesh: FLOPs dry {dry['flops']:,} vs real {real['flops']:,}"
          f" (equal {dry['flops'] == real['flops']}); dry trace "
          f"{trace_s:.1f} s", flush=True)
    print(f"[dryrun:count] [{card}] peak bytes dry {dry['peak_bytes']:,} "
          f"(argument {dry['argument_bytes']:,} + temp "
          f"{dry['temp_bytes']:,}) vs max_memory_allocated {peak:,} of a "
          f"real step: {ratio:.4f}x (band {DRYRUN_PEAK_BAND[0]}-"
          f"{DRYRUN_PEAK_BAND[1]})", flush=True)
    print(f"[dryrun:count] [{card}] step ms {step_ms:.3f} (median of "
          f"{DRYRUN_TIMED_STEPS} after a warm-up: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times)}) vs the roofline "
          f"bound {bound_ms:.3f} ms (compute {rep.t_compute * 1e3:.3f}, "
          f"memory {rep.t_memory * 1e3:.3f} of {dry['bytes']:,} bytes, "
          f"collective {rep.t_collective * 1e3:.3f}; {rep.bottleneck}); "
          f"share of the bound {bound_ms / step_ms:.4f}; useful_ratio "
          f"{rep.useful_ratio:.4f}", flush=True)
    if dry["flops"] != real["flops"]:
        raise SystemExit("[dryrun:count] the dry count's FLOPs differ from "
                         "the real step's")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise SystemExit(f"[dryrun:count] dry peak {ratio:.4f}x the real "
                         f"step's, outside {DRYRUN_PEAK_BAND}")
    if step_ms < bound_ms:
        raise SystemExit(f"[dryrun:count] the card beat the bound: "
                         f"{step_ms:.3f} < {bound_ms:.3f} ms")
    return {"dryrun_step_ms": step_ms, "dryrun_bound_ms": bound_ms}


def dryrun_main() -> None:
    """10b and 10c in a process of their own: each cell of
    :data:`DRYRUN_CELLS` through ``run_cell`` on the card's device type
    (fake tensors: nothing allocated, no kernel launched), printing a
    ``[dryrun]`` line a cell; then the ``cpu_blocked`` install on the host
    (``[cpu_blocked]`` lines).  Exits non-zero when a cell is not ``ok``."""
    faulthandler.dump_traceback_later(DRYRUN_TIMEOUT_S - 10, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.dryrun import run_cell
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, mesh, tmp / "cells")
            if rec["status"] != "ok":
                raise SystemExit(f"[dryrun] {arch} x {shape} x {mesh}: "
                                 f"{rec['status']} ({rec.get('reason')})")
            r, c, m = rec["roofline"], rec["cost"], rec["memory"]
            coll = {k: (v["count"], v["operand_bytes"])
                    for k, v in rec["collectives"].items()
                    if isinstance(v, dict)}
            print(f"[dryrun] [{card}] {arch} x {shape} x {mesh} "
                  f"({rec['chips']} ranks): ok, trace_s {rec['trace_s']}, "
                  f"cell {time.perf_counter() - t0:.1f} s; peak "
                  f"{m['peak_bytes'] / 1e9:.3f} GB a rank (argument "
                  f"{m['argument_bytes'] / 1e9:.3f}, temp "
                  f"{m['temp_bytes'] / 1e9:.3f}); a rank: FLOPs "
                  f"{c['flops_per_device']:.6g}, bytes "
                  f"{c['bytes_per_device']:.6g}, collective bytes "
                  f"{c['collective_bytes']:.6g}; t_compute "
                  f"{r['t_compute'] * 1e3:.3f} ms, t_memory "
                  f"{r['t_memory'] * 1e3:.3f} ms, t_collective "
                  f"{r['t_collective'] * 1e3:.3f} ms, bottleneck "
                  f"{r['bottleneck']}, useful_ratio {r['useful_ratio']:.4f};"
                  f" collectives (count, operand bytes) {coll}", flush=True)
        cpu_blocked_phase(tmp / "cpu_blocked")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cpu_blocked_phase(out: Path) -> None:
    """10c: the ``cpu_blocked`` gemm install at precisions s and d on this
    host's CPU, loaded into a fresh runtime; its tuned knob against its
    default on :data:`CPU_BLOCKED_HELD_OUT`, timed alike (a reading)."""
    import torch
    from repro_torch.backends import get_backend
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core.timing import time_callable
    from repro_torch.launch import calibrate
    info = dict(line.split(":", 1) for line in
                Path("/proc/cpuinfo").read_text().splitlines()
                if ":" in line)
    info = {k.strip(): v.strip() for k, v in info.items()}
    # a virtualised host may report its model name as "unknown"
    cpu = (f"{info.get('vendor_id', '?')} family "
           f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
           f"(model name {info.get('model name', '?')!r}, "
           f"{info.get('cpu MHz', '?')} MHz, "
           f"{'avx512f' if 'avx512f' in info.get('flags', '') else 'no avx512f'}"
           f"{', amx' if 'amx_tile' in info.get('flags', '') else ''})")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        calibrate.main(["--out", str(out), *CPU_BLOCKED_ARGS])
    install_s = time.perf_counter() - t0
    rt = AdsalaRuntime()
    loaded = ModelRegistry(out / "models").load_into(rt)
    be = get_backend("cpu_blocked")
    reports = json.loads((out / "calibration_report.json").read_text())
    print(f"[cpu_blocked] host CPU {cpu}, {os.cpu_count()} cores, numpy "
          f"BLAS on {os.environ.get('OMP_NUM_THREADS', 'all')} thread(s); "
          f"install of gemm at s and d in {install_s:.1f} s, {loaded} "
          f"artifacts: " + ", ".join(
              f"{r['prec']}: {r['best_model']} of {r['n_samples']} dims x "
              f"{r['n_knobs']} knobs" for r in reports), flush=True)
    for prec, dtype in (("s", torch.float32), ("d", torch.float64)):
        for dims in CPU_BLOCKED_HELD_OUT:
            operands = be.make_operands("gemm", dims, dtype, seed=7)
            tuned = rt.select("gemm", dims, dtype.itemsize,
                              backend="cpu_blocked")
            default = be.default_knob("gemm")
            t_tuned = time_callable(lambda: be.execute("gemm", operands,
                                                       tuned),
                                    device=be.device, warmup=1, repeats=3)
            t_default = time_callable(lambda: be.execute("gemm", operands,
                                                         default),
                                      device=be.device, warmup=1, repeats=3)
            print(f"[cpu_blocked] {prec} gemm {dims}: tuned {tuned.dict} "
                  f"{t_tuned * 1e3:.3f} ms, default {default.dict} "
                  f"{t_default * 1e3:.3f} ms, default / tuned "
                  f"{t_default / t_tuned:.3f}", flush=True)


def mesh_main(root: str) -> None:
    """Phase 9 in a fresh process: a world of one under NCCL, the (1, 1)
    mesh ``best_mesh`` gives it, then 9a-9c (:func:`mesh_step`,
    :func:`mesh_full_width`, :func:`mesh_checkpoint`), each printing its
    ``[mesh:*]`` lines and exiting non-zero when a gate fails; the last
    line ``MESH_RESULT`` and a JSON object."""
    faulthandler.dump_traceback_later(MESH_TIMEOUT_S - 10, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import best_mesh, close_world, init_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    t0 = time.perf_counter()
    device = init_world("cuda")
    mesh = best_mesh(model_parallel=1)
    print(f"[mesh] world of {dist.get_world_size()} under "
          f"{dist.get_backend()} on {device} in "
          f"{time.perf_counter() - t0:.1f} s; mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    res = {}
    try:
        for phase in (mesh_step, mesh_full_width, mesh_checkpoint,
                      dryrun_count):
            t0 = time.perf_counter()
            res.update(phase(torch, card, Path(root), device, mesh))
            torch.cuda.empty_cache()
            print(f"[mesh] {phase.__name__} {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        close_world()
    print("MESH_RESULT " + json.dumps(res), flush=True)


# -- phase 2 ----------------------------------------------------------------

def _ptxas_entries(name: str) -> list[tuple[str, int, int]]:
    """(template arguments, registers, spill bytes stored + loaded, with
    those of the functions it calls) of every kernel instantiation in the
    ``-Xptxas -v`` report of ``name``."""
    import re
    from repro_torch.kernels import _build
    entries = []
    for seg in _build.ptxas_report(name).split("Compiling entry function")[1:]:
        args = re.search(r"I((?:Li\d+E)+)E", seg.split("'")[1])
        tile = "x".join(re.findall(r"Li(\d+)E", args.group(1))) \
            if args else "?"
        regs = re.search(r"Used (\d+) registers", seg)
        # the entry's own line and one for each function it calls
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", seg)
        entries.append((tile, int(regs.group(1)) if regs else -1,
                        sum(int(a) + int(b) for a, b in spills)
                        if spills else -1))
    return entries


def check_build() -> None:
    """No spill in any instantiation of the kernels, and the launch
    parameters and split-k plan compiled into the kernels equal their
    Python mirrors."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    # trsm.cu: the substitution under each tile, the inverses under each bm
    trsm_count = len(T.TILES) + len({bm for bm, _ in T.TILES})
    for name, count in (("gemm", len(G.TILES)), ("symm", len(S.TILES)),
                        ("rank_k", len(K.TILES)),
                        ("rank_k_packed", len(K.TILES)),
                        ("trmm", len(TM.TILES)),
                        ("trmm_packed", len(TM.TILES)),
                        ("trsm", trsm_count)):
        entries = _ptxas_entries(name)
        spilled = [e for e in entries if e[2] != 0]
        if len(entries) != count or spilled:
            raise SystemExit(f"[build:{name}] {len(entries)} instantiations "
                             f"(expected {count}), spilling or unreported: "
                             f"{spilled}")
        print(f"[build:{name}] {count} instantiations, 0 spill bytes; "
              f"registers " + ", ".join(f"{t} {r}" for t, r, _ in entries),
              flush=True)
    out = (ctypes.c_int * 4)()
    configs = [("gemm", (bm, bk, bn), lambda o, t=(bm, bk, bn):
                _build.load("gemm").repro_gemm_f32_config(*t, o))
               for bm, bk, bn in sorted(G.TILES)]
    configs += [(name, (bm, 64, bn), lambda o, t=(bm, bn), name=name:
                 getattr(_build.load(name), f"repro_{name}_f32_config")(*t,
                                                                        o))
                 for name, tiles in (("symm", S.TILES), ("trmm", TM.TILES),
                                     ("trmm_packed", TM.TILES))
                 for bm, bn in sorted(tiles)]
    configs += [(name, (bm, bk, bm), lambda o, t=(bm, bk), name=name:
                 getattr(_build.load(name), f"repro_{name}_f32_config")(*t,
                                                                        o))
                 for name in ("rank_k", "rank_k_packed")
                 for bm, bk in sorted(K.TILES)]
    for name, (bm, bk, bn), query in configs:
        p = K.rank_k_params(bm, bk) if name.startswith("rank_k") \
            else G.mainloop_params(bm, bk, bn)
        want = [p["threads"], p["stages"], p["smem"], p["passes"]]
        if query(out) != 0 or list(out) != want:
            raise SystemExit(f"[build:{name}] tile {(bm, bk, bn)}: built "
                             f"with {list(out)}, mainloop_params {want}")
    trsm_out = (ctypes.c_int * 7)()
    for bm, bn in sorted(T.TILES):
        p = T.trsm_params(bm, bn)
        want = [p[key] for key in ("threads", "stages", "smem", "passes",
                                   "inv_threads", "inv_smem",
                                   "block_workspace")]
        if _build.load("trsm").repro_trsm_f32_config(bm, bn, trsm_out) != 0 \
                or list(trsm_out) != want:
            raise SystemExit(f"[build:trsm] tile {(bm, bn)}: built with "
                             f"{list(trsm_out)}, trsm_params {want}")
    split = _build.load("gemm").repro_gemm_f32_split
    dims = [*KERNEL_DIMS, *UNALIGNED_DIMS, *CONTRACT_DIMS["gemm"],
            *((t, k, n) for t in TOKENS for k, n in LINEARS),
            *((128, 128 * i, D_FF) for i in range(1, 32))]
    for (m, k, n), (bm, _bk, bn) in itertools.product(dims, sorted(G.TILES)):
        split(m, n, k, bm, bn, out)
        if (out[0], out[1]) != G.split_plan(m, n, k, bm, bn):
            raise SystemExit(f"[build:gemm] split at {(m, k, n)} tile "
                             f"{bm}x{bn}: C {(out[0], out[1])}, Python "
                             f"{G.split_plan(m, n, k, bm, bn)}")
    print(f"[build] launch parameters of {len(configs) + len(T.TILES)} "
          f"tiles and the split plan at {len(dims)} dims x {len(G.TILES)} "
          f"tiles equal their Python mirrors", flush=True)


# -- phase 3 ----------------------------------------------------------------

def check_gemm(torch, rand) -> None:
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
    space = ops.knob_space_for("gemm")
    worst, worst_abs, checks, tf32_least = 0.0, 0.0, 0, math.inf
    for m, k, n in KERNEL_DIMS:
        a, b, c = rand(m, k), rand(k, n), rand(m, n)
        # the limit must reject a product of TF32-rounded inputs
        tf32_err = _rel_err(_tf32(a).double() @ _tf32(b).double(),
                            a.double() @ b.double())
        tf32_least = min(tf32_least, tf32_err)
        if not tf32_err > F32_TOL:
            raise SystemExit(f"[kernel] TF32-rounded inputs at {(m, k, n)} "
                             f"pass the limit ({tf32_err:.3e})")
        sa, sb, sc = rand(STACK, m, k), rand(STACK, k, n), rand(STACK, m, n)
        cases = [((a, b, None), 1.0, 0.0), ((a, b, c), 0.5, 2.0),
                 ((sa, sb, sc), 0.5, 2.0), ((sa, b, sc), 0.5, 2.0)]
        for knob in space:
            kd = knob.dict
            tile = dict(bm=kd["bm"], bk=kd["bk"], bn=kd["bn"])
            for (x, y, z), alpha, beta in cases:
                got = G.gemm(x, y, z, alpha=alpha, beta=beta, **tile)
                plain = G.gemm_plain(x, y, z, alpha=alpha, beta=beta)
                oracle = alpha * torch.matmul(x.double(), y.double())
                if z is not None:
                    oracle = oracle + beta * z.double()
                err = _rel_err(got, oracle)
                worst = max(worst, err)
                worst_abs = max(worst_abs, (got - plain).abs().max().item())
                checks += 1
                if not err < F32_TOL:
                    raise SystemExit(f"[kernel] {kd} {tuple(x.shape)}@"
                                     f"{tuple(y.shape)}: rel err {err:.3e}")
                if x.dim() == 3:
                    for i in range(STACK):
                        one = G.gemm(x[i], y[i] if y.dim() == 3 else y, z[i],
                                     alpha=alpha, beta=beta, **tile)
                        if not torch.equal(one, got[i]):
                            raise SystemExit(f"[kernel] {kd}: stacked item "
                                             f"{i} differs from per-item")
    # the unaligned path (4-byte copies) equals the aligned one (16-byte)
    for m, k, n in UNALIGNED_DIMS:
        a, b, c = rand(m, k), rand(k, n), rand(m, n)
        wa, wb = rand(m, k + 1), rand(k, n + 1)
        wa[:, :k], wb[:, :n] = a, b
        for knob in space:
            tile = {key: knob[key] for key in ("bm", "bk", "bn")}
            aligned = G.gemm(a, b, c, alpha=0.5, beta=2.0, **tile)
            unaligned = G.gemm(wa[:, :k], wb[:, :n], c, alpha=0.5, beta=2.0,
                               **tile)
            checks += 1
            if not torch.equal(aligned.view(torch.int32),
                               unaligned.view(torch.int32)):
                raise SystemExit(f"[kernel] {tile} at {(m, k, n)}: unaligned "
                                 f"strides differ from aligned bit for bit")
    torch.cuda.synchronize()
    print(f"[kernel:gemm] {checks} checks over {len(space)} tiles: max rel "
          f"err {worst:.3e} (< {F32_TOL}), max abs err vs plain "
          f"{worst_abs:.3e}, stacked == per-item bit for bit, unaligned == "
          f"aligned strides bit for bit at {UNALIGNED_DIMS}; TF32-rounded "
          f"inputs: least rel err {tf32_least:.3e} (> {F32_TOL})", flush=True)
    # a yardstick only: the library's product with TF32 allowed
    a, b = rand(256, 512), rand(512, 384)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib_tf32 = _rel_err(torch.matmul(a, b), a.double() @ b.double())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[kernel:gemm] torch.matmul with TF32 allowed at (256,512,384): "
          f"rel err {lib_tf32:.3e}", flush=True)


def check_2d_ops(torch, rand) -> None:
    """symm, syrk/syr2k, trmm and trsm under every candidate of their
    spaces."""
    from repro_torch.backends import conformance as C
    from repro_torch.kernels import ops
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    for op in ("symm", "syrk", "syr2k", "trmm", "trsm"):
        space = ops.knob_space_for(op)
        dims_list = (*C.RAGGED_DIMS[op], ALIGNED_2D)
        worst, checks = 0.0, 0
        for knob in space:
            for dims in dims_list:
                for stacked, with_c in ((0, False), (0, True),
                                        (STACK, True)):
                    res = C.check_backend_op(
                        "hopper", op, dims=dims, tol=F32_TOL, knob=knob,
                        stacked=stacked, with_c=with_c, alpha=0.5, beta=2.0,
                        seed=checks)
                    checks += 1
                    if not res.ok:
                        raise SystemExit(f"[kernel:{op}] {res.line()}")
                    worst = max(worst, res.rel_err)
            # the stack equals its items bit for bit
            x = [rand(STACK, *s) for s in _shapes_2d(op, (129, 257))]
            if op == "trsm":
                x[0].diagonal(dim1=-2, dim2=-1).add_(129)
            kw = {"alpha": 0.5} if op in ("trmm", "trsm") \
                else {"alpha": 0.5, "beta": 2.0}
            if op not in ("trmm", "trsm"):
                x.append(rand(STACK, 129, 257 if op == "symm" else 129))
            got = ops.HOPPER_OPS[op](*x, knob=knob, **kw)
            for i in range(STACK):
                one = ops.HOPPER_OPS[op](*(t[i] for t in x), knob=knob, **kw)
                if not torch.equal(one, got[i]):
                    raise SystemExit(f"[kernel:{op}] {knob}: stacked item "
                                     f"{i} differs from per-item")
        torch.cuda.synchronize()
        print(f"[kernel:{op}] {checks} conformance checks over {len(space)} "
              f"candidates x {dims_list} (single, C, stack of {STACK}): max "
              f"rel err vs float64 {worst:.3e} (< {F32_TOL}); stacked == "
              f"per-item bit for bit", flush=True)
    # tri_packed == tri, bit for bit
    pairs = 0
    for op, fn in (("syrk", K.syrk), ("syr2k", K.syr2k)):
        for n, k in (*C.RAGGED_DIMS[op], ALIGNED_2D):
            x = [rand(n, k) for _ in range(1 if op == "syrk" else 2)]
            c = rand(n, n)
            for bm, bk in sorted(K.TILES):
                for cc, beta in ((None, 0.0), (c, 2.0)):
                    tri = fn(*x, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                             variant="tri")
                    packed = fn(*x, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                                variant="tri_packed")
                    pairs += 1
                    if not torch.equal(tri.view(torch.int32),
                                       packed.view(torch.int32)):
                        raise SystemExit(f"[kernel:{op}] tri_packed != tri "
                                         f"at {(n, k)} tile {bm}x{bk}")
    for m, n in (*C.RAGGED_DIMS["trmm"], ALIGNED_2D):
        a, b = rand(m, m), rand(m, n)
        for bm, bn in sorted(TM.TILES):
            tri = TM.trmm(a, b, bm=bm, bn=bn, alpha=0.5, variant="tri")
            packed = TM.trmm(a, b, bm=bm, bn=bn, alpha=0.5,
                             variant="tri_packed")
            pairs += 1
            if not torch.equal(tri.view(torch.int32),
                               packed.view(torch.int32)):
                raise SystemExit(f"[kernel:trmm] tri_packed != tri at "
                                 f"{(m, n)} tile {bm}x{bn}")
    torch.cuda.synchronize()
    print(f"[kernel:rank_k,trmm] tri_packed == tri bit for bit in {pairs} "
          f"pairs (syrk, syr2k with and without C; trmm)", flush=True)


def _unaligned(torch, x):
    """``x``'s values in a view whose leading stride is one float longer:
    not a multiple of 4 where x's is, so the kernels take 4-byte copies."""
    wide = torch.zeros(*x.shape[:-1], x.shape[-1] + 1, device=x.device)
    wide[..., :x.shape[-1]] = x
    return wide[..., :x.shape[-1]]


def check_trmm_paths(torch, rand) -> None:
    """trmm under every knob, single and stacked: operands with unaligned
    leading strides (the 4-byte copies) equal aligned ones bit for bit, and
    an A with NaN everywhere above its diagonal, or zeros there, gives the
    bits of the A it came from, on both copy paths: the triangle limit
    never reads past the diagonal."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
    from repro_torch.kernels import trmm as TM
    space = ops.knob_space_for("trmm")
    checks, vec_dims = 0, []
    for m, n in TRMM_PATH_DIMS:
        for lead in ((), (STACK,)):
            a, b = rand(*lead, m, m), rand(*lead, m, n)
            upper = torch.ones(m, m, dtype=torch.bool,
                               device=a.device).triu(1)
            nans = torch.where(upper, math.nan, a)
            zeros = torch.where(upper, 0.0, a)
            sab, sbb = (m * m, m * n) if lead else (0, 0)
            if G.vec_aligned((a, m, sab), (b, n, sbb)):
                vec_dims.append((*lead, m, n))
            ua, ub, unans = (_unaligned(torch, x) for x in (a, b, nans))
            for knob in space:
                kw = dict(bm=knob["bm"], bn=knob["bn"], alpha=0.5,
                          variant=knob["variant"])
                want = TM.trmm(a, b, **kw).view(torch.int32)
                for x, y, what in ((ua, b, "unaligned A"),
                                   (a, ub, "unaligned B"),
                                   (ua, ub, "unaligned A and B"),
                                   (nans, b, "NaN above the diagonal"),
                                   (zeros, b, "zeros above the diagonal"),
                                   (unans, ub, "unaligned, NaN above the "
                                    "diagonal")):
                    checks += 1
                    if not torch.equal(TM.trmm(x, y, **kw).view(torch.int32),
                                       want):
                        raise SystemExit(f"[kernel:trmm] {knob} at "
                                         f"{(*lead, m, n)}: {what} differs "
                                         f"from A aligned bit for bit")
    if not vec_dims:
        raise SystemExit("[kernel:trmm] no aligned operands: the 16-byte "
                         "copies were not held")
    torch.cuda.synchronize()
    print(f"[kernel:trmm] {checks} checks over {len(space)} candidates at "
          f"{TRMM_PATH_DIMS} (single, stack of {STACK}): unaligned == "
          f"aligned strides bit for bit (16-byte copies at {vec_dims}), and "
          f"NaN or zeros above A's diagonal change no bit, on both copy "
          f"paths", flush=True)


def check_rank_k_paths(torch, rand) -> None:
    """syrk and syr2k under every knob, single and stacked, with and without
    C: operands with unaligned leading strides (the 4-byte copies) and
    operands zero-padded to multiples of 128 in n and k (sliced back) give
    the bits of aligned, unpadded operands, and ``tri``/``tri_packed``
    outputs equal their transposes bit for bit (the epilogue's mirror)."""
    import torch.nn.functional as F
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
    from repro_torch.kernels import syrk as K

    def rup(v):
        return -(-v // 128) * 128

    checks, vec_dims = 0, []
    for op, fn in (("syrk", K.syrk), ("syr2k", K.syr2k)):
        space = ops.knob_space_for(op)
        for n, k in RANK_K_PATH_DIMS:
            for lead in ((), (STACK,)):
                xs = [rand(*lead, n, k) for _ in range(1 if op == "syrk"
                                                       else 2)]
                c = rand(*lead, n, n)
                sb = n * k if lead else 0
                if op == "syrk" and G.vec_aligned((xs[0], k, sb)):
                    vec_dims.append((*lead, n, k))
                pad_n, pad_k = rup(n) - n, rup(k) - k
                padded = [F.pad(x, (0, pad_k, 0, pad_n)) for x in xs]
                cpad = F.pad(c, (0, pad_n, 0, pad_n))
                ua = _unaligned(torch, xs[0])
                inputs = [(padded, "zero-padded n and k"),
                          ([ua, *xs[1:]], "unaligned A")]
                if op == "syr2k":
                    ub = _unaligned(torch, xs[1])
                    inputs += [([xs[0], ub], "unaligned B"),
                               ([ua, ub], "unaligned A and B")]
                for knob in space:
                    kw = dict(bm=knob["bm"], bk=knob["bn"], alpha=0.5,
                              variant=knob["variant"])
                    for cc, cp, beta in ((None, None, 0.0), (c, cpad, 2.0)):
                        want = fn(*xs, cc, beta=beta, **kw).view(torch.int32)
                        for ys, what in inputs:
                            got = fn(*ys, cp if ys is padded else cc,
                                     beta=beta, **kw)[..., :n, :n]
                            checks += 1
                            if not torch.equal(got.contiguous()
                                               .view(torch.int32), want):
                                raise SystemExit(
                                    f"[kernel:{op}] {knob} at "
                                    f"{(*lead, n, k)}: {what} differs from "
                                    f"aligned, unpadded operands bit for "
                                    f"bit")
                        if knob["variant"] != "full" and not torch.equal(
                                want, want.mT):
                            raise SystemExit(f"[kernel:{op}] {knob} at "
                                             f"{(*lead, n, k)}: output not "
                                             f"symmetric bit for bit")
    if not vec_dims:
        raise SystemExit("[kernel:rank_k] no aligned operands: the 16-byte "
                         "copies were not held")
    torch.cuda.synchronize()
    print(f"[kernel:rank_k] {checks} checks over the 18 syrk and 18 syr2k "
          f"candidates at {RANK_K_PATH_DIMS} (single, stack of {STACK}, "
          f"with and without C): unaligned strides and zero-padded n, k == "
          f"aligned, unpadded bit for bit (16-byte copies at {vec_dims}); "
          f"tri and "
          f"tri_packed symmetric bit for bit", flush=True)


def check_trsm_kernels(torch, rand) -> None:
    """trsm's two kernels apart under every knob, on the conformance dims
    and one aligned shape, single and stacked: ``trsm_inv`` with
    ``tril(D_i) D_i^-1 = I`` (within ``F32_TOL``, relative to the largest
    ``|D_i| |D_i^-1|`` product) and within ``F32_TOL`` of
    ``diag_inverses_plain``; ``trsm`` within ``F32_TOL`` of
    ``substitute_plain`` fed the same inverses; each kernel's stack equal to
    its items bit for bit.  The ragged n of (129, 257) takes the 4-byte
    copies that read the block's own X rows back through L1."""
    from repro_torch.backends import conformance as C
    from repro_torch.kernels import ops
    from repro_torch.kernels import trsm as T
    worst = {"eye": 0.0, "inv": 0.0, "sub": 0.0}
    checks = 0
    for knob in ops.knob_space_for("trsm"):
        bm, bn = knob["bm"], knob["bn"]
        for m, n in (*C.RAGGED_DIMS["trsm"], ALIGNED_2D):
            for lead in ((), (STACK,)):
                a, b = rand(*lead, m, m), rand(*lead, m, n)
                a.diagonal(dim1=-2, dim2=-1).add_(m)
                inv = T.diag_inverses(a, bm=bm)
                full, last = T.diag_inverses_plain(a, bm)
                for got, want in zip(T.inverse_blocks(inv, m, bm),
                                     (full, last)):
                    if want is not None:
                        worst["inv"] = max(worst["inv"], _rel_err(got, want))
                for i in range(-(-m // bm)):
                    lo, hi = i * bm, min(m, (i + 1) * bm)
                    d = torch.tril(a[..., lo:hi, lo:hi]).double()
                    di = inv[..., i, :hi - lo, :hi - lo].double()
                    eye = torch.eye(hi - lo, dtype=torch.float64,
                                    device=a.device)
                    scale = (d.abs() @ di.abs()).max().item()
                    worst["eye"] = max(worst["eye"], (d @ di - eye).abs()
                                       .max().item() / scale)
                x = T.substitute(a, b, inv, bm=bm, bn=bn, alpha=0.5)
                want = torch.empty_like(b)
                T.substitute_plain(a, b, want, *T.inverse_blocks(inv, m, bm),
                                   bm=bm, bn=bn, alpha=0.5)
                worst["sub"] = max(worst["sub"], _rel_err(x, want))
                checks += 1
                if not max(worst.values()) < F32_TOL:
                    raise SystemExit(f"[kernel:trsm] {knob} at "
                                     f"{(*lead, m, n)}: {worst}")
                if lead:
                    for k in range(STACK):
                        one_inv = T.diag_inverses(a[k], bm=bm)
                        one = T.substitute(a[k], b[k], inv[k], bm=bm, bn=bn,
                                           alpha=0.5)
                        if not (torch.equal(one_inv.view(torch.int32),
                                            inv[k].view(torch.int32))
                                and torch.equal(one.view(torch.int32),
                                                x[k].view(torch.int32))):
                            raise SystemExit(f"[kernel:trsm] {knob} at "
                                             f"{(*lead, m, n)}: stacked item "
                                             f"{k} differs from per-item")
    torch.cuda.synchronize()
    print(f"[kernel:trsm] {checks} checks of trsm_inv and trsm over the 8 "
          f"candidates at {(*C.RAGGED_DIMS['trsm'], ALIGNED_2D)} (single, "
          f"stack of {STACK}): tril(D) D^-1 - I {worst['eye']:.3e}, "
          f"trsm_inv vs diag_inverses_plain {worst['inv']:.3e}, trsm vs "
          f"substitute_plain {worst['sub']:.3e} (< {F32_TOL}); stacked == "
          f"per-item bit for bit", flush=True)


#: the ragged and one-row dims of the reference's zero-copy tests
#: (tests/test_zero_copy_kernels.py RAGGED and its one-row dims), and a GEMM
#: whose contraction splits under the padded run's 128 x 128 tile
CONTRACT_DIMS = {"gemm": ((129, 65, 257), (1, 300, 384), (7, 1300, 1000)),
                 "symm": ((129, 257), (1, 384)),
                 "syrk": ((129, 65), (1, 384)),
                 "syr2k": ((129, 65), (1, 384)),
                 "trmm": ((129, 257), (1, 384)),
                 "trsm": ((129, 257),)}


def check_contracts(torch, rand) -> list[str]:
    """The zero-copy and packed-grid contracts on the card: ``run_op`` ==
    the padded run bit for bit (trsm within 1e-5), no copy op on the
    dispatch path (trsm: no pad), every recorded grid equal to its formula
    and ``tri_packed`` launching fewer blocks than ``tri``.  Returns the
    ``packed_slot_ratio`` lines."""
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels import ops
    from repro_torch.kernels.padded_ref import block_knob, padded_run
    checks = 0
    for op, dims_list in CONTRACT_DIMS.items():
        variants = ("full", "tri", "tri_packed") \
            if op in ("syrk", "syr2k", "trmm") else ("full",)
        for dims in dims_list:
            if op == "gemm":
                xs = (rand(dims[0], dims[1]), rand(dims[1], dims[2]))
            elif op in ("symm", "trmm", "trsm"):
                xs = (rand(dims[0], dims[0]), rand(*dims))
                if op == "trsm":
                    xs[0].diagonal().add_(dims[0])
            else:
                xs = tuple(rand(*dims) for _ in range(1 + (op == "syr2k")))
            for var in variants:
                knob = block_knob(op, 128, var)
                counts = I.copy_op_counts(ops.run_op, op, xs, knob=knob)
                with I.capture_launches() as launched:
                    got = ops.run_op(op, xs, knob=knob)
                want = padded_run(op, xs, variant=var)
                checks += 1
                if op == "trsm":
                    if "constant_pad_nd" in counts:
                        raise SystemExit(f"[contract] trsm pads: {counts}")
                    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                        raise SystemExit("[contract] trsm masked != padded "
                                         "within 1e-5")
                    grids = [("trsm_inv", I.full_grid_for("trsm_inv", dims,
                                                          128)),
                             ("trsm", I.full_grid_for("trsm", dims, 128,
                                                      128))]
                    if launched != grids:
                        raise SystemExit(f"[contract] trsm at {dims}: "
                                         f"launched {launched}, formulas "
                                         f"{grids}")
                    continue
                if counts:
                    raise SystemExit(f"[contract] {op} {var} at {dims}: copy "
                                     f"ops on the dispatch path {counts}")
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise SystemExit(f"[contract] {op} {var} at {dims}: "
                                     f"masked != padded bit for bit")
                packed = var == "tri_packed"
                grid = (I.packed_grid_for if packed else I.full_grid_for)(
                    op, dims, 128, 128)
                if launched != [(kernel_of(op, {"variant": var}), grid)]:
                    raise SystemExit(f"[contract] {op} {var} at {dims}: "
                                     f"launched {launched}, formula {grid}")
    torch.cuda.synchronize()
    print(f"[contract] {checks} runs: masked == padded bit for bit (trsm "
          f"within 1e-5), no copy op in run_op's dispatch (trsm: no pad), "
          f"recorded grids == formulas", flush=True)
    lines = []
    for op, dims, bm, bn in (("syrk", (D_MODEL, D_FF), 128, 64),
                             ("syrk", (D_FF, D_MODEL), 128, 64),
                             ("syr2k", (D_MODEL, D_MODEL), 128, 64),
                             ("trmm", (D_MODEL, D_FF), 128, 128),
                             ("syrk", STACKED_2D[1:], 128, 64),
                             ("trmm", STACKED_2D[1:], 128, 128)):
        full = I.grid_slots(I.full_grid_for(op, dims, bm, bn))
        packed = I.grid_slots(I.packed_grid_for(op, dims, bm, bn))
        if not packed < full:
            raise SystemExit(f"[contract] {op} tri_packed launches {packed} "
                             f"blocks, tri {full}")
        lines.append(f"{op} {dims} bm={bm}: tri {full} blocks, tri_packed "
                     f"{packed}, packed_slot_ratio "
                     f"{I.packed_slot_ratio(op, dims, bm, bn):.4f}")
    # and on a launch: the recorded grids of the stacked calls
    for op, shapes in (("syrk", [STACKED_2D]),
                       ("trmm", [STACKED_2D, STACKED_2D])):
        xs = tuple(rand(*s) for s in shapes)
        for var in ("tri", "tri_packed"):
            knob = block_knob(op, 128, var)
            with I.capture_launches() as launched:
                ops.run_op(op, xs, knob=knob)
            grid = (I.packed_grid_for if var == "tri_packed"
                    else I.full_grid_for)(op, STACKED_2D[1:], 128, 128,
                                          batch=STACKED_2D[0])
            if launched != [(kernel_of(op, {"variant": var}), grid)]:
                raise SystemExit(f"[contract] {op} {var}: launched "
                                 f"{launched}, formula {grid}")
    torch.cuda.synchronize()
    for line in lines:
        print(f"[contract] {line}", flush=True)
    return lines


def _shapes_2d(op: str, dims) -> list:
    a, b = dims
    if op in ("symm", "trmm", "trsm"):
        return [(a, a), (a, b)]
    return [(a, b)] * (1 if op == "syrk" else 2)


# -- phase 7 ----------------------------------------------------------------

def _kernel_fn(op: str, kd: dict, kw: dict):
    """The kernel of ``op`` under the knob ``kd``, called on operands."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    if op == "gemm":
        return lambda x, y: G.gemm(x, y, bm=kd["bm"], bk=kd["bk"],
                                   bn=kd["bn"])
    if op == "symm":
        return lambda x, y: S.symm(x, y, bm=kd["bm"], bn=kd["bn"])
    if op == "trmm":
        return lambda x, y: TM.trmm(x, y, bm=kd["bm"], bn=kd["bn"],
                                    variant=kd["variant"])
    if op == "trsm":
        return lambda x, y: T.trsm(x, y, bm=kd["bm"], bn=kd["bn"])
    fn = K.syrk if op == "syrk" else K.syr2k
    return lambda *xs: fn(*xs, bm=kd["bm"], bk=kd["bn"],
                          variant=kd["variant"], **kw)


def _library_fn(torch, op: str, kw: dict, shapes):
    """One PyTorch call (or two matmuls for syr2k) computing the same
    function, and the operand transform it needs outside the timing."""
    if op == "gemm":
        return torch.matmul, None
    if op == "symm":
        from repro_torch.kernels.ref import sym_lower
        return torch.matmul, lambda xs: [sym_lower(xs[0]), xs[1]]
    if op == "trmm":
        return torch.matmul, lambda xs: [torch.tril(xs[0]), xs[1]]
    if op == "trsm":
        return (lambda a, b: torch.linalg.solve_triangular(a, b,
                                                           upper=False),
                None)
    if op == "syrk":
        if len(shapes) == 2:
            return (lambda a, c: torch.addmm(c, a, a.mT, beta=kw["beta"],
                                             alpha=kw["alpha"]), None)
        return (lambda a: torch.matmul(a, a.mT)), None
    return (lambda a, b: torch.matmul(a, b.mT) + torch.matmul(b, a.mT)), None


def time_rows(torch, card: str, rows: list[dict]) -> dict:
    """Phase 7: time every served call; returns per-kernel totals."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "ops_bound_ms": 0.0}
              for name in KERNELS}
    per_op = {}
    for row in rows:
        op, kw, shapes = row["op"], row["kw"], row["shapes"]
        per_set = 4 * sum(math.prod(s) for s in shapes)
        sets = [make_operands(torch, gen, op, shapes)
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        big = per_set > 200e6
        ms = _time_ms(torch, _kernel_fn(op, row["knob"], kw), sets,
                      iters=3 if big else 10)
        plain = plain_of(op, row["knob"])
        plain_ms = _time_ms(torch, lambda *xs: plain(*xs, **kw), sets,
                            iters=3 if big else 10)
        lib, prep = _library_fn(torch, op, kw, shapes)
        lib_sets = [prep(s) for s in sets] if prep else sets
        library_ms = _time_ms(torch, lib, lib_sets, iters=3 if big else 10)
        del lib_sets
        bound_ms, bound_by = _bound(op, shapes, kw)
        # trsm's two kernels count apart (the substitution against the
        # solve's bound and library call)
        parts = time_trsm_kernels(torch, card, row, sets, library_ms,
                                  iters=3 if big else 10) \
            if op == "trsm" else \
            {row["kernel"]: (ms, plain_ms, library_ms, bound_ms, bound_by)}
        for name, (k_ms, k_plain, k_lib, k_bound, k_by) in parts.items():
            t = totals[name]
            t["ms"] += k_ms
            t["plain_ms"] += k_plain
            t["library_ms"] += k_lib
            t["bound_ms"] += k_bound
            if k_by == "operations":
                t["ops_bound_ms"] += k_bound
        line = (f"[times] [{card}] {row['label']}: {op} knob "
                f"{_knob_str(op, row['knob'])} {ms:.4f} ms")
        if row.get("pinned"):
            print(f"{line} (pinned) | plain {plain_ms:.4f} ms | library "
                  f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms "
                  f"({bound_by}) | launches {row['launches']}", flush=True)
            if op in RATE_OPS:
                print(f"[rate] [{card}] {row['label']}: " + _rate(
                    op, shapes, kw, row["knob"], ms, bound_ms, bound_by,
                    "pinned"), flush=True)
            del sets
            continue
        default = ops.default_knob(op).dict
        default_ms = _time_ms(torch, _kernel_fn(op, default, kw), sets,
                              iters=3 if big else 10)
        # every candidate of the space: the best the knob could have done
        best_ms, best = min(
            ((_time_ms(torch, _kernel_fn(op, k.dict, kw), sets,
                       iters=1 if big else 3), k.dict)
             for k in ops.knob_space_for(op)), key=lambda v: v[0])
        del sets
        acc = per_op.setdefault(op, {"ms": 0.0, "default_ms": 0.0,
                                     "best_ms": 0.0})
        acc["ms"] += ms
        acc["default_ms"] += default_ms
        acc["best_ms"] += best_ms
        print(f"{line} | default {_knob_str(op, default)} "
              f"{default_ms:.4f} ms | tuned/default {default_ms / ms:.3f}x "
              f"| best {_knob_str(op, best)} {best_ms:.4f} ms (best/default "
              f"{default_ms / best_ms:.3f}x) | plain {plain_ms:.4f} ms | "
              f"library {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
              f"({bound_by}) | launches {row['launches']}", flush=True)
        if op in RATE_OPS:
            rates = [(name, kd, t) for name, kd, t in
                     (("served", row["knob"], ms), ("default", default,
                                                     default_ms),
                      ("best", best, best_ms), ("library", None, library_ms))]
            print(f"[rate] [{card}] {row['label']}: " + " | ".join(
                _rate(op, shapes, kw, kd, t, bound_ms, bound_by, name)
                for name, kd, t in rates), flush=True)
    for op, acc in per_op.items():
        print(f"[times] [{card}] {op} served calls: tuned {acc['ms']:.4f} "
              f"ms, default {acc['default_ms']:.4f} ms "
              f"({acc['default_ms'] / acc['ms']:.3f}x), best knobs "
              f"{acc['best_ms']:.4f} ms", flush=True)
    host_cost(torch, card)
    return totals


def _inverse_work(m: int, bm: int, batch: int) -> tuple[float, float]:
    """Operations and bytes of the diagonal-block inverses: r^3 / 3 for a
    lower-triangular r x r block solved against I, its lower triangle read
    and the inverse's written."""
    blocks = [min(bm, m - lo) for lo in range(0, m, bm)]
    flops = batch * sum(r ** 3 / 3 for r in blocks)
    nbytes = 4.0 * batch * sum(r * (r + 1) for r in blocks)
    return flops, nbytes


def time_trsm_kernels(torch, card: str, row: dict, sets, library_ms: float,
                      iters: int) -> dict:
    """A served trsm call's two kernels apart, on its operand ``sets``:
    ``trsm_inv`` against ``diag_inverses_plain``, its bound and one
    ``solve_triangular`` of the stacked diagonal blocks against I (the
    main path's m is a multiple of every bm, so every block is full); and
    ``trsm`` from those inverses against ``substitute_plain`` fed the same
    ones, the solve's bound and ``library_ms``, the solve's library call.
    The inverses' three times are device times (:func:`_device_ms`).
    Returns ``{kernel: (ms, plain_ms, library_ms, bound_ms, bound_by)}``
    and books the inverses' largest absolute error against their plain
    version in ``row["inv_abs_err"]``."""
    from repro_torch.kernels import trsm as T
    bm, bn = row["knob"]["bm"], row["knob"]["bn"]
    shapes = row["shapes"]
    m = shapes[0][-1]
    batch = shapes[0][0] if len(shapes[0]) == 3 else 1
    if m % bm:
        raise SystemExit(f"[times] {row['label']}: m={m} not a multiple of "
                         f"bm={bm}")
    inv_events_ms = _time_ms(torch, lambda a, _b: T.diag_inverses(a, bm=bm),
                             sets, iters)
    # device times: the inverses take less than their calls' host time
    inv_ms = _device_ms(torch, lambda a, _b: T.diag_inverses(a, bm=bm), sets,
                        iters)
    inv_plain_ms = _device_ms(torch, lambda a, _b: T.diag_inverses_plain(
        a, bm), sets, iters)
    eye = torch.eye(bm, device="cuda")
    blocks = [(a.as_strided((batch, m // bm, bm, bm),
                            (m * m if batch > 1 else 0, (m + 1) * bm, m, 1)),
               eye) for a, _b in sets]
    inv_lib_ms = _device_ms(torch, lambda d, e: torch.linalg.solve_triangular(
        d, e, upper=False), blocks, iters)
    invs = [(a, b, T.diag_inverses(a, bm=bm)) for a, b in sets]
    row["inv_abs_err"] = max(
        (T.inverse_blocks(inv, m, bm)[0]
         - T.diag_inverses_plain(a, bm)[0]).abs().max().item()
        for a, _b, inv in invs)
    sub_ms = _time_ms(torch, lambda a, b, inv: T.substitute(
        a, b, inv, bm=bm, bn=bn), invs, iters)

    def sub_plain(a, b, inv):
        x = torch.empty_like(b)
        T.substitute_plain(a, b, x, *T.inverse_blocks(inv, m, bm), bm=bm,
                           bn=bn, alpha=1.0)
        return x

    sub_plain_ms = _time_ms(torch, sub_plain, invs, iters)
    flops, nbytes = _inverse_work(m, bm, batch)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    inv_bound = 1e3 * max(t_ops, t_bytes)
    inv_by = "operations" if t_ops >= t_bytes else "bytes"
    bound_ms, bound_by = _bound("trsm", shapes, row["kw"])
    print(f"[times:trsm] [{card}] {row['label']}: knob "
          f"{_knob_str('trsm', row['knob'])} | trsm_inv {inv_ms:.4f} ms "
          f"(device; {inv_events_ms:.4f} ms a call from CUDA events), "
          f"plain {inv_plain_ms:.4f} ms, library {inv_lib_ms:.4f} ms "
          f"(solve_triangular of the {batch * (m // bm)} blocks against I), "
          f"bound {inv_bound:.4f} ms ({inv_by}), max abs err vs plain "
          f"{row['inv_abs_err']:.2e} | trsm {sub_ms:.4f} ms, plain "
          f"{sub_plain_ms:.4f} ms (substitute_plain), bound {bound_ms:.4f} "
          f"ms ({bound_by}), {100 * bound_ms / sub_ms:.1f} % of bound",
          flush=True)
    return {"trsm_inv": (inv_ms, inv_plain_ms, inv_lib_ms, inv_bound,
                         inv_by),
            "trsm": (sub_ms, sub_plain_ms, library_ms, bound_ms, bound_by)}


def host_cost(torch, card: str) -> None:
    """The time per call of the GEMM wrapper and of ``torch.matmul`` on a
    product too small for the card to matter, (8,64)@(64,64): CUDA events
    around 500 calls, so the host's work per call."""
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn(8, 64, generator=gen, device="cuda")
    y = torch.randn(64, 64, generator=gen, device="cuda")
    wrapper = _time_ms(torch, lambda a, b: G.gemm(a, b, bm=64, bk=16, bn=64),
                       [(x, y)], iters=500)
    library = _time_ms(torch, torch.matmul, [(x, y)], iters=500)
    print(f"[host] [{card}] per call at (8,64)@(64,64): gemm wrapper "
          f"{1e3 * wrapper:.2f} us, torch.matmul {1e3 * library:.2f} us",
          flush=True)


def _rate(op: str, shapes, kw, kd, ms: float, bound_ms: float,
          bound_by: str, name: str) -> str:
    """A call's rate under the knob ``kd`` (None: the library call) at
    ``ms``: TFLOP/s when operations bound it, else GB/s; its share of the
    bound; and for the GEMM the split-k plan it launched."""
    from repro_torch.kernels import gemm as G
    flops, nbytes = _work(op, shapes, kw)
    rate = (f"{flops / ms / 1e9:.2f} TFLOP/s" if bound_by == "operations"
            else f"{nbytes / ms / 1e6:.1f} GB/s")
    text = f"{name} {rate}, {100 * bound_ms / ms:.1f} % of bound"
    if kd is None:
        return text
    text = f"{text} ({_knob_str(op, kd)}"
    if op == "gemm":
        m, k = shapes[0][-2:]
        slices, length = G.split_plan(m, shapes[1][-1], k, kd["bm"], kd["bn"])
        text += f", split {slices} x {length}"
    return text + ")"


def _knob_str(op: str, kd: dict) -> str:
    """A GEMM tile as bm x bk x bn; a 2-dim knob as bm x bn (its bk only
    repeats bm), with the variant of syrk/syr2k/trmm."""
    if op == "gemm":
        return f"{kd['bm']}x{kd['bk']}x{kd['bn']}"
    if op in ("syrk", "syr2k", "trmm"):
        return f"{kd['bm']}x{kd['bn']}/{kd['variant']}"
    return f"{kd['bm']}x{kd['bn']}"


# -- the main run -------------------------------------------------------------

def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, introspect, ops
    from repro_torch.launch import calibrate

    if tuple(KERNELS) != introspect.KERNELS:
        raise SystemExit(f"chip_smoke.KERNELS {tuple(KERNELS)} differs from "
                         f"the recorder's {introspect.KERNELS}")
    repeats = 0
    if argv:
        if len(argv) != 2 or argv[0] != "--repeat-checks":
            raise SystemExit("usage: chip_smoke.py [--repeat-checks N]")
        repeats = int(argv[1])

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    # within the runner's 1200 s: a stuck phase prints every thread's stack
    faulthandler.dump_traceback_later(1150, exit=True)

    # 1. environment
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    print(f"[env] {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print("[env] " + _sh(_build.nvcc_path(), "--version").splitlines()[-1],
          flush=True)

    # 2. build every kernel source, all nvcc runs started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for name, _ in zip(KERNEL_SOURCES,
                           pool.map(_build.build, KERNEL_SOURCES)):
            for line in _build.ptxas_report(name).splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    print(f"[build:{name}] {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    check_build()

    # 3. every kernel against a float64 oracle and its plain version
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if repeats:
        for i in range(repeats):
            faulthandler.dump_traceback_later(120, exit=True)
            t0 = time.perf_counter()
            check_gemm(torch, rand)
            check_2d_ops(torch, rand)
            check_trmm_paths(torch, rand)
            check_rank_k_paths(torch, rand)
            check_trsm_kernels(torch, rand)
            check_contracts(torch, rand)
            print(f"[repeat {i + 1}/{repeats}] clean in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    check_gemm(torch, rand)
    check_2d_ops(torch, rand)
    check_trmm_paths(torch, rand)
    check_rank_k_paths(torch, rand)
    check_trsm_kernels(torch, rand)
    check_contracts(torch, rand)
    print(f"[kernel] {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. install on the card, 5. serve from a fresh process
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (str(ROOT / "src"), os.environ.get("PYTHONPATH"))))}
    try:
        for op in ops.HOPPER_OPS:
            calibrate.main(["--out", str(tmp), "--ops", op, "--samples",
                            str(CALIBRATE_SAMPLES[op]), *CALIBRATE_ARGS])
        reports = json.loads((tmp / "calibration_report.json").read_text())
        for report in reports:
            print(f"[install] {report['artifact']}: best "
                  f"{report['best_model']}, {report['n_samples']} dims x "
                  f"{report['n_knobs']} knobs, gather "
                  f"{report['gather_seconds']:.1f} s, total "
                  f"{report['wall_seconds']:.1f} s", flush=True)
            for row in report["models"]:
                print(f"[install:{report['op']}] {row['name']}: estimated "
                      f"mean speedup {row['estimated_mean_speedup']:.3f}, "
                      f"ideal {row['ideal_mean_speedup']:.3f}, normalized "
                      f"rmse {row['normalized_rmse']:.3f}, eval "
                      f"{row['eval_time_us']:.1f} us")
        # the prewarm: every model phase's keys, the decision cache
        prewarm_phase(card, tmp)
        # the retune phase's copy of the registry and the install datasets
        for part in ("models", "datasets"):
            shutil.copytree(tmp / part, tmp / "retune" / part)
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.serve_main("
             f"{str(tmp / 'models')!r}, {str(tmp / 'retune')!r}, "
             f"{str(tmp / 'fleet')!r})"],
            cwd=ROOT, capture_output=True, text=True,
            timeout=SERVE_TIMEOUT_S)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"[serve] fresh process failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}")
        # 6 to 6f. each model from a fresh process of its own, once the
        # last has exited: their weights (32 GB, 62.83 GB, 4.88 GB, 6.46 GB,
        # 3.24 GB, 63.44 GB) never meet each other, phase 5's operands or
        # what this process's allocator holds
        models = {}
        for arch, (tag, *_, timeout) in MODEL_PHASES.items():
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            mproc = subprocess.run(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.model_main("
                 f"{str(tmp / 'models')!r}, {arch!r})"],
                cwd=ROOT, capture_output=True, text=True, timeout=timeout)
            sys.stderr.write(mproc.stderr[-4000:])
            if mproc.returncode != 0:
                raise SystemExit(f"[{tag}] fresh process failed "
                                 f"({mproc.returncode}):\n"
                                 f"{mproc.stdout[-4000:]}")
            models[arch] = (mproc.stdout, time.perf_counter() - t0)
        # 8. training, once phase 6f's process has exited: 8a-8c in a
        # fresh process; then 8d in another (cuBLAS reads its workspace
        # setting when it starts) beside the example, neither timed

        def train_process(job):
            tag, cmd, extra, timeout = job
            t0 = time.perf_counter()
            tproc = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                                   env={**env, **extra}, capture_output=True,
                                   text=True, timeout=timeout)
            sys.stderr.write(tproc.stderr[-4000:])
            if tproc.returncode != 0:
                raise SystemExit(f"[{tag}] fresh process failed "
                                 f"({tproc.returncode}):\n"
                                 f"{tproc.stdout[-4000:]}")
            return tag, tproc.stdout, time.perf_counter() - t0

        torch.cuda.empty_cache()
        training = [train_process((
            "train", ["-c", f"import chip_smoke; chip_smoke.train_main("
                            f"{str(tmp / 'train')!r})"], {},
            TRAIN_TIMEOUT_S))]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            training += pool.map(train_process, (
                ("train:resume", ["-c", f"import chip_smoke; chip_smoke."
                                        f"resume_main({str(tmp / 'resume')!r})"],
                 {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, RESUME_TIMEOUT_S),
                ("train:example", ["examples/torch_train_lm.py", "--ckpt",
                                   str(tmp / "example")], {},
                 EXAMPLE_TIMEOUT_S)))
        # 9. training under a mesh, once phase 8's processes have exited
        torch.cuda.empty_cache()
        training.append(train_process((
            "mesh", ["-c", f"import chip_smoke; chip_smoke.mesh_main("
                           f"{str(tmp / 'mesh')!r})"], {}, MESH_TIMEOUT_S)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served = json.loads(next(line for line in proc.stdout.splitlines()
                             if line.startswith("SERVE_RESULT "))
                        .split(" ", 1)[1])
    for row in served["rows"]:
        print(f"[serve] {row['label']}: knob "
              f"{_knob_str(row['op'], row['knob'])} "
              f"launches {row['launches']} rel err vs plain "
              f"{row['rel_err']:.2e}")
    print(f"[serve] model_evals {served['model_evals']} default_calls "
          f"{served['default_calls']} eval_failures "
          f"{served['eval_failures']} calls {served['calls']} for "
          f"{served['served']} served calls; launches {served['launches']}",
          flush=True)
    if served["model_evals"] <= 0 or served["default_calls"] != 0 \
            or served["eval_failures"] != 0:
        raise SystemExit("[serve] decisions did not come from the model")
    for row in served["rows"]:
        if row["launches"] != row["expected_launches"]:
            raise SystemExit(f"[serve] {row['label']}: launches "
                             f"{row['launches']}, expected "
                             f"{row['expected_launches']}")
        if not row["rel_err"] < F32_TOL:
            raise SystemExit(f"[serve] {row['label']}: rel err "
                             f"{row['rel_err']:.3e}")
    unlaunched = [k for k in KERNELS if served["launches"][k] < 1]
    if unlaunched:
        raise SystemExit(f"[serve] the main paths never launched "
                         f"{unlaunched}")
    svc = served["service"]
    print(f"[service] [{card}] {svc['requests']} requests in "
          f"{SERVICE_WINDOWS} windows of {svc['window_requests']} from "
          f"{SERVICE_THREADS} threads (max_batch {SERVICE_MAX_BATCH}, "
          f"{SERVICE_WORKERS} workers, a CUDA stream each): completed "
          f"{svc['completed']}, failed {svc['failed']}, {svc['batches']} "
          f"buckets, mean batch {svc['mean_batch']:.3f}, mean bucket span "
          f"{svc['mean_bucket_ms']:.4f} ms (CUDA events on the worker's "
          f"stream); knobs {svc['knobs']}; max rel err vs plain "
          f"{svc['max_rel_err']:.2e}", flush=True)
    print(f"[service] [{card}] mean bucket span per op (ms): "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in
                      sorted(svc["bucket_ms"].items())), flush=True)
    rates = {}
    for name, key in (("through the service", "service_s"),
                      ("as one run_op each", "single_s")):
        per_window = sorted(svc["window_requests"] / s for s in svc[key])
        rates[key] = per_window[len(per_window) // 2]
        print(f"[service] [{card}] requests/s {name}: median "
              f"{rates[key]:.1f}, min {per_window[0]:.1f}, max "
              f"{per_window[-1]:.1f} over {len(per_window)} windows "
              f"({' '.join(f'{r:.1f}' for r in per_window)})", flush=True)
    print(f"[service] [{card}] service / single (medians) "
          f"{rates['service_s'] / rates['single_s']:.3f}x", flush=True)
    print(f"[service] launches {svc['launches']} (expected from the buckets "
          f"{svc['expected_launches']}); model_evals {svc['model_evals']} "
          f"default_calls {svc['default_calls']} eval_failures "
          f"{svc['eval_failures']}", flush=True)
    if svc["completed"] != svc["requests"] or svc["failed"] \
            or not svc["mean_batch"] > 1.0:
        raise SystemExit("[service] lost or failed requests, or no batching")
    if svc["launches"] != svc["expected_launches"]:
        raise SystemExit("[service] launches differ from the buckets")
    if svc["default_calls"] or svc["eval_failures"]:
        raise SystemExit("[service] decisions did not come from the model")
    report_retune(card, served["retune"])
    report_fleet(card, served["fleet"])

    model_launches = {}
    for arch, (stdout, seconds) in models.items():
        res = json.loads(next(line for line in stdout.splitlines()
                              if line.startswith("MODEL_RESULT "))
                         .split(" ", 1)[1])
        report_model(card, arch, res)
        model_launches[arch] = res["launches"]["gemm"]
        print(f"[{MODEL_PHASES[arch][0]}] phase {seconds:.1f} s (a fresh "
              f"process)", flush=True)

    for tag, stdout, seconds in training:
        lines = stdout.splitlines()
        if tag == "train:example":
            lines = [f"[{tag}] [{card}] {lines[-1]}"]
        for line in lines:
            if line.startswith(("[train", "[mesh", "[dryrun")):
                print(line)
        print(f"[{tag}] phase {seconds:.1f} s (a fresh process)", flush=True)
    # 9b beside 8c: the same model, batch and numerics, with and without
    # the mesh (DTensor's host cost)
    outs = {tag: stdout for tag, stdout, _ in training}
    one_ms = float(re.search(r"\[train:step\] \[[^]]*\] step ms ([0-9.]+)",
                             outs["train"]).group(1))
    meshed = json.loads(next(line for line in outs["mesh"].splitlines()
                             if line.startswith("MESH_RESULT "))
                        .split(" ", 1)[1])
    print(f"[mesh:vs] [{card}] llama3-8b at {TRAIN_CUTS['llama3-8b']} "
          f"layers, {TRAIN_BATCH} x {TRAIN_SEQ}: step ms {meshed['step_ms']:.3f}"
          f" on the (1, 1) mesh against {one_ms:.3f} unsharded (8c), "
          f"{meshed['step_ms'] / one_ms:.3f}x; tokens/s "
          f"{meshed['tokens_s']:.1f} against "
          f"{TRAIN_BATCH * TRAIN_SEQ / (one_ms / 1e3):.1f}; 9a bit-equal "
          f"{meshed['bit_equal']}", flush=True)

    # 7. times on the main paths' shapes
    totals = time_rows(torch, card, served["rows"])
    # 10b, 10c: host work on fake tensors and numpy, after the last timed
    # phase, in a fresh process with the host to itself
    t0 = time.perf_counter()
    dproc = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                                                  "chip_smoke.dryrun_main()"],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=DRYRUN_TIMEOUT_S)
    sys.stderr.write(dproc.stderr[-4000:])
    if dproc.returncode != 0:
        raise SystemExit(f"[dryrun] fresh process failed "
                         f"({dproc.returncode}):\n{dproc.stdout[-4000:]}")
    for line in dproc.stdout.splitlines():
        if line.startswith(("[dryrun", "[cpu_blocked")):
            print(line)
    print(f"[dryrun] 10b and 10c {time.perf_counter() - t0:.1f} s (a fresh "
          f"process)", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        t = totals[name]
        # trsm_inv: its inverses against their plain version, per call
        errs = [r["inv_abs_err"] if name == "trsm_inv" else r["abs_err"]
                for r in served["rows"]
                if r["kernel"] == (name if name != "trsm_inv" else "trsm")]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if 2 * t["ops_bound_ms"]
                         >= t["bound_ms"] else "bytes"),
            "library_ms": t["library_ms"]})
    # the model paths' GEMM launches (phases 6 to 6f fail unless they are
    # these)
    entry = next(k for k in kernels if k["name"] == "gemm")
    entry["model_launches"] = model_launches["llama3-8b"]
    entry["moe_model_launches"] = model_launches["deepseek-v2-lite-16b"]
    entry["zamba2_model_launches"] = model_launches["zamba2-1.2b"]
    entry["rwkv6_model_launches"] = model_launches["rwkv6-1.6b"]
    entry["whisper_model_launches"] = model_launches["whisper-medium"]
    entry["vlm_model_launches"] = model_launches["internvl2-76b"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
