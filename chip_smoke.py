#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the port's
CUDA kernels from the sources in this checkout.  Phases:

1. Card and build: the card's name and power limit from ``nvidia-smi``;
   ``kernels/csrc/flash_fwd.cu``, ``flash_bwd.cu``, ``distill_kl_fwd.cu``,
   ``distill_kl_bwd.cu``, ``ssd_fwd.cu`` and ``ssd_bwd.cu`` built by one
   ``nvcc`` each, started together; the counts of ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions in the SASS of the flash forward and backward, KL
   forward and backward and SSD forward and backward libraries, each of
   which must have both: their bf16 paths run on the tensor cores from
   TMA-fed shared memory, their float32 paths on the CUDA cores; and the
   bytes ``ptxas -v`` spills in the SSD backward's tensor-core kernels,
   printed (its gradient kernel spills at n = 128; not yet a check).
2. The flash kernel against its plain version (``kernels/ref.py``) on the
   card, over a sweep of shapes, masks and dtypes (bf16 through the
   tensor-core path, float32 through the CUDA-core path), and at the
   main-path shapes, granite-3-8b's serving prefill, qwen1.5-0.5b's
   training and distillation attention, a multi-teacher microbatch's, and
   an MLLM microbatch's in the ViT (non-causal, 4096 patches) and in the
   pixtral-12b-width LM, each held within a limit scaled to its output
   that a planted fault (o * 0.9) must fail, and where the kernel, the plain
   version and PyTorch's ``scaled_dot_product_attention`` are timed.  At
   each training shape the backward kernel (``csrc/flash_bwd.cu``) too:
   dq, dk and dv against its plain version (``ref.flash_bwd_ref``) row by
   row, each query or key row within SHAPE_REL_TOL of its own scale, each
   gradient's last 128-row tile zeroed as a planted fault failing that,
   two calls equal bit for bit, and its time beside the plain version's
   and SDPA's backward.  Then its gradients: autograd
   through ``ops.flash_attention[_lse]`` (the forward and backward
   kernels) against autograd through the plain version, over a sweep and
   at the training shape.
3. The distillation-KL kernel against its plain version over a sweep
   (ragged N and V, Ds != Dt, T in {1, 2}, f32 and bf16, with and without
   a mask, W contiguous and W as ``embed.T``), then at the main-path
   shapes (N = 8192 and 4096, D = 1024, V = 151936, bf16), where the
   kernel, the plain version and the materialised form in PyTorch calls
   are timed.  At each of these shapes the backward too
   (``csrc/distill_kl_bwd.cu``, the logit gradients a vocabulary chunk at
   a time, and its two cuBLAS products, through the op
   ``repro_torch::distill_kl_bwd``): both sides' dh and dW against
   ``ref.distill_kl_bwd_ref``, each row of dh and each vocabulary column
   of dW within KL_BWD_TOL of its own scale, the last chunk's dW zeroed
   and its part of dh dropped as planted faults that must fail, two calls
   equal bit for bit; at the main-path shapes its time on the student
   side (split into the dz kernels and the products) beside the plain
   version's, autograd's through the materialised form and the bound.
4. Serving: ``launch.serve.serve`` runs granite-3-8b at full width in bf16
   (random weights from a seed), batch 4, prompt 2048, 32 generated
   tokens; the flash kernel must be launched once per layer in prefill.
   A warm run is timed and traced with ``torch.profiler``; prefill of S-2
   tokens then 2 decode steps must give ``forward``'s logits (4 layers,
   float32).
5. Training: ``launch.train.run`` trains qwen1.5-0.5b at full width in
   bf16, batch 4 x seq 2048; losses and grad norms finite, weights
   changed, the flash kernel launched twice per layer and step (forward
   and the recompute of the checkpointed layer).  One warm step of the
   same model is traced.  Then checkpoint and resume through the same
   entry point (``phase_checkpoint``), under deterministic algorithms: 4
   steps uninterrupted against 2 steps that save asynchronously and stop
   on SIGTERM, then a freshly built model and optimizer state that resume
   from that directory for steps 2-3 on the batches from index 2 on;
   losses, parameters, master, mu, nu and step must be equal bit for bit,
   the step-2 checkpoint must restore bit for bit, one leaf moved by one
   ulp must fail that comparison and a manifest missing a leaf must raise
   KeyError.  It prints the bytes a checkpoint writes, the save's copy
   and write seconds, the restore seconds and the step time with a save
   in flight.  Then data parallelism (``phase_dp``) on a one-rank NCCL
   process group in this process, destroyed after: ``launch.train.run(...,
   mesh=section_mesh([0], ParallelConfig(dp=1, mbs=2, zero_opt=True)))``,
   FSDP and ZeRO blocks, all-gathers, reduce-scatters and the sharded
   norm through NCCL, 3 steps against 3 steps of the single-device step,
   under deterministic algorithms: losses and every leaf of params,
   master, mu, nu and step equal bit for bit, flash launched as often; the
   first gradient leaf scaled by 0.99 must break that; ``grad_compress``
   bf16 and int8, 3 steps each, within ``tests/drivers/
   driver_compression.py``'s tolerances of the uncompressed losses, a
   non-zero int8 residual, the wire counters at 1/2 and 1/4 of the float32
   payload, and a traced fourth step with the device time under the
   quantize and dequantize ranges; the sharded state saved through the
   collective save and restored with ``shardings=`` on the same mesh and
   with none, bit for bit.  World size 1 is all one card can run: NCCL
   refuses two ranks on one GPU.
6. Distillation: ``distill.workload.build_colocated_step``, teacher
   qwen1.5-0.5b (seed 1, frozen) and student qwen1.5-0.5b (seed 0) at full
   width in bf16, batch 4 x seq 2048, alpha 0.5, T 2, 3 steps; the KL
   kernel and its backward launched once per step; one warm step traced.
   Then one
   distillation step's gradients at full width (2 layers, float32) on the
   kernels against the same step on CPU copies, which take the plain
   versions.
7. The SSD scan kernel against its plain version (``ssd_scan_ref``) over
   a sweep (lengths below, at and above its 64-token chunk, ragged, f32
   and bf16, with and without the final state, x/B/C as strided slices of
   one tensor; each case prints its route: CUDA cores for f32, tensor
   cores with TMA or threads' loads for bf16) and 1024 chunks (bf16, the
   final state), then at mamba2-130m's shape (b=4, s=4096, h=24, p=64,
   n=128, bf16, by TMA), where the kernel and the plain version are timed
   and its kernels' device times traced.  The backward kernel
   (``csrc/ssd_bwd.cu``, the op ``repro_torch::ssd_bwd``) against its
   plain version (``ref.ssd_bwd_ref``) over a sweep (f32 on the CUDA cores
   and bf16 on the tensor cores, each bf16 case printing its route, TMA or
   threads' loads; ragged, a partial group of heads, with and without the
   final state's gradient, x/B/C as strided slices; the threads' route
   against TMA's bit for bit):
   f32 within SSD_BWD_TOL of each leaf's largest element, bf16 dx, dB and
   dC row by row within SHAPE_REL_TOL of each row's own scale, two calls
   bit for bit, and planted faults (the final state's gradient dropped,
   the last chunk's rows zeroed) failing that; then at mamba2-130m's
   shape, where the backward, its kernels (traced), the plain version,
   autograd through ``ssd_chunked`` at chunk 128 (the backward before this
   kernel) and the bound are timed.  Its gradients: autograd through
   ``ops.ssd_scan`` (the forward and backward kernels) against autograd
   through the sequential ``ssd_reference``, over a sweep, in ROADMAP
   C3's case (chunk 128, A = -1) and at A = -4, where cum passes 88.7
   inside one 64-token chunk; every gradient must be finite.
8. mamba2-130m at full width in bf16: ``launch.train.run``, batch 4 x seq
   4096, 4 steps (SSD kernel launched twice per layer and step, its
   backward kernel once, flash never), one warm step traced; ``launch.serve.serve``, batch 4, prompt
   4096, 32 tokens (SSD launched once per layer in prefill, never in
   decode), then timed warm.  Prefill of S-2 tokens and 2 decode steps
   against ``forward`` (4 layers, float32), and one train step's
   gradients (2 layers, float32) against the same step on the CPU.
9. The section-centric compound runtime at full width in bf16, each
   section on its own worker thread and CUDA stream, all on the one card.
   qwen1.5-0.5b self-distillation (teacher seed 1, student seed 0, batch
   4 x 2048, 3 iterations): (a) the colocated step, (b)
   ``DistillRuntime.train_iteration``, (c) ``CompoundRuntime(distill_spec,
   lookahead=1)`` streamed; (b) against (a) and (c) against (b) within one
   bf16 step, launches checked for (b) and (c), cold and warm times, each
   section's busy time and utilization, the queue's stats, and two warm
   streamed iterations traced: device busy against wall and the time the
   teacher's and the student's streams both ran kernels.  The affinity
   pass holds the runtime's wiring (one worker and one stream of its own a
   section) and the traced kernels (each on its section's stream; a
   planted task that launches on the other section's stream must be
   reported).  Then the same distillation through section meshes
   (``phase_sections``): ``DistillRuntime(..., ranks=[0, 0])`` on a
   one-rank NCCL group in this process, destroyed after, both sections on
   rank 0, each with its own ``section_mesh``, worker thread and stream,
   against ``DistillRuntime(devices=[cuda:0] * 2)``, 3 iterations under
   deterministic algorithms: losses, ce, kl, grad norms and every student
   leaf equal bit for bit, flash and KL launched as often, the
   collectives (gathers, reduce-scatters, all-reduces) run and counted an
   iteration; the first gradient leaf scaled by 0.99 must break that;
   ``grad_compress="bf16"`` on the student equal bit for bit to the exact
   run (one rank, one microbatch and bf16 parameters: the bf16 round trip
   of the float32 accumulator loses nothing here) with the wire counter
   at 1/2 of the float32 payload; one traced iteration through the
   affinity pass (ROADMAP.md, C10); and the device-carved runtime at a
   reduced size built, run and shut down four times, after which the
   card's reserved memory must not grow (with the runtime's release of
   the cuBLAS workspaces turned off it must: the planted fault).  Then
   context parallelism at world size 1 (``phase_cp``, a one-rank NCCL
   group whose mesh has a ``seq`` axis of 1, all one H100 allows; every
   mode runs ulysses there): (a) ``dist.context.cp_attention`` against
   ``ops.flash_attention``, forward and (dq, dk, dv), float32 and bf16
   within GRAD_TOL, o also within SHAPE_REL_TOL of its scale and row by
   row (a planted o * 0.9 must fail), in the ulysses mode with 1 and 4
   chunks (4 flash launches a call, each on the chunk's keys with their
   ``kv_positions``, merged by ``merge_flash_partials``), at the MLLM
   ViT's non-causal (2, 4096, 4096, 16, 16, 64) and qwen1.5-0.5b's causal
   (4, 2048, 2048, 16, 16, 64), each call timed beside the plain call;
   (b) qwen1.5-0.5b at full width with ``cp_attention_impl(mesh,
   mode="ulysses", overlap_chunks=4)`` installed through the attention
   hook, against the same model without it: loss and every gradient leaf
   at 2 layers in float32 within CP_GRAD_TOL; at full depth in bf16,
   batch 4 x 2048, every gradient leaf of the first batch within
   CP_BF16_GRAD_TOL (with one chunk's lse planted ln 2 high in the merge
   it must fail), then one train step, its loss within RT_TOL and its
   warm ms beside the plain step's; (c) ``MLLMRuntime(..., ranks=[0,
   0])`` with the ViT at ``cp=1`` against the device-carved runtime, bit
   for bit (the cp-aware exchange between sections changes nothing at
   world size 1).  The flash kernel is also checked and timed at the
   chunks' shapes through ``phase_flash_shape``, (2, 4096, 1024, 16, 16,
   64) non-causal and (4, 2048, 512, 16, 16, 64) causal, with the strided
   key positions of cp 4 and 4 chunks, beside SDPA with a boolean mask.
   Then pipeline and tensor parallelism at world size 1 (``phase_pp``, a
   one-rank NCCL group, every axis of its mesh 1: NCCL refuses two ranks
   on one card, so pp and tp above 1 are held on the CPU by gloo ranks):
   ``dist.pipeline.build_pp_loss(..., n_micro=2, vocab_parallel=True)``
   and its ``value_and_grad`` (the explicit GPipe backward, the
   distributed logsumexp over a one-stage ``pipe`` group) on qwen1.5-0.5b
   at full width and depth in bf16, 4 x 2048, against ``model.loss`` and
   autograd on the whole batch: the loss within PP_BF16_LOSS_TOL, each
   leaf within PP_BF16_GRAD_TOL of its largest gradient, flash launched 2
   x 24 x 2 times, the warm staged value-and-gradient timed beside the
   plain one; the same at 4 layers in float32 within the reference
   driver's bounds, where a planted micro-batch layout (every micro-batch
   the first's rows) must fail them; the Megatron sub-layer with a
   one-rank model group bit for bit against the plain one, forward and
   backward; and moonshot-v1-16b-a3b at full width with 2 of its 48
   layers: the aux rebuilt from ``moe(..., return_stats=True)`` against
   ``moe``'s own, and the staged loss (the aux from the micro-batches'
   statistics) against ``model.loss``.  Then the
   two-stage planner (``phase_plan``) with the H100's
   numbers for the compound configurations at the JAX package's test
   budgets (every section fits, eq. 2 on every edge) and for qwen1.5-0.5b
   on one card beside the measured student busy time and peak memory (a
   calibration record).  Then routed
   multi-teacher distillation (``CompoundRuntime(multi_teacher_spec)``,
   three qwen1.5-0.5b sections, batch 8 x 2048 in microbatches of 2,
   specialist ratio 0.3, wavefront order): the specialist's dispatches
   equal the plan's active microbatches (printed beside FIFO's count), the
   launches the formula, the losses the colocated oracle's on the same
   microbatches.
10. MLLM training (``mllm.workload``): the ViT section
   (``vit_config(out_dim=1024)`` at 12 of its 24 layers) feeding
   pixtral-12b at full width with 2 layers, bf16, batch 8 x 2048 in
   microbatches of 2, vision ratio 0.5, each section on its own worker
   thread and stream of the card, from one host-side initial parameter
   set: (a) the colocated step, (b) ``MLLMRuntime`` serialized, (c) streamed with lookahead 1, run one
   after the other (two training states do not fit the card); (b)
   against (a) and (c) against (b) as in phase 9, launch counts, an
   all-text batch (the ViT runs only its update; the queue carries only
   the grad-norm pair), wavefront against FIFO (ViT microbatches and
   realized makespan), and one traced iteration with the time both
   sections' streams ran kernels, held by the affinity pass; installing
   two sections' states that share a master tensor must be refused.
11. The MoE family at full width with its depth cut. Serving:
   mixtral-8x22b (8 of 56 layers, bf16, 20.4 B parameters) through
   ``launch.serve.generate``, batch 2, prompt 8192 past its 4096-token
   window, 32 tokens: flash once per layer in prefill, never in decode;
   then warm, and a warm prefill and 8 decode steps traced with the device
   time under the MoE layer's ranges.  Prefill of 4352 tokens and 4
   decode steps, the rolling cache wrapping, against ``forward`` (4
   layers, float32, no-drop capacity), every MoE call's routing compared
   first.  Training: moonshot-v1-16b-a3b (4 of 48 layers, bf16, 2.95 B
   parameters) through ``train.step.build_train_step``, batch 4 x 2048 in
   microbatches of 2, 3 steps: finite loss, grad norm and aux, aux > 0,
   weights moved, flash launched layers x 2 x microbatches a step; one warm
   step traced.  Then one loss's gradients (float32) on the card against
   the CPU at the reduced config and at full width with 2 layers, the
   routing of every MoE call compared first (a difference is a tie flip
   and fails as one).  The flash kernel is also held at mixtral's windowed
   prefill (2, 8192, 8192, 48, 8, 128), window 4096, against the plain
   version over 1024 query rows at a time, where the kernel run without
   the window must fail, and at moonshot's training shapes (4 and 2, 2048,
   2048, 16, 16, 128).
12. The last two families at full width. whisper-small (12 encoder and
   12 decoder layers, 1500 frames of 768 from the stubbed frontend):
   training through ``train.step.build_train_step`` and
   ``train.loop.train`` on ``audio_batches`` (bf16, batch 32 x 448 tokens
   in microbatches of 16, 4 steps; finite metrics, weights moved, flash
   launched steps x microbatches x 2 x (12 + 2 x 12) times; one warm step
   traced); serving through ``launch.serve.generate(..., frames=)``
   (batch 16, prompt 64, 64 tokens: flash 36 times a prefill, never in
   decode); prefill of S-2 tokens and 2 decode steps against ``forward``
   (float32, full depth) and one loss's gradients on the card against the
   CPU (float32, reduced and full width with 2 + 2 layers), each also run
   with layer 0's cross-attention ``wk`` scaled by 0.99, which must fail.
   jamba-v0.1-52b (8 of 32 layers: 1 attention, 7 Mamba-2 at d_state 16,
   4 MoE; 13.27 B parameters in bf16): serving through
   ``launch.serve.generate``, batch 2, prompt 16384, 32 tokens (flash once
   and SSD 7 times a prefill, neither in decode), warm, and a traced warm
   prefill and 8 decode steps; prefill + 2 decode steps against
   ``forward`` (float32, no-drop capacity, routes compared first) at the
   reduced config and at full width (B 1, S 512); the reduced config's
   gradients on the card against the CPU; both with the first MoE layer's
   gates scaled by 0.99, which must fail.  The flash kernel is held at
   whisper's encoder (16, 1500, 1500, 12, 12, 64) non-causal, decoder
   self-attention (16, 448, 448, ...), cross-attention (16, 448, 1500, ...)
   and prefill cross-attention (16, 64, 1500, ...), and at jamba's (2,
   16384, 16384, 32, 8, 128) against the plain version over 1024 query
   rows at a time; the SSD kernel at jamba's (2, 16384, 128, 64, 16),
   and in the sweep at jamba's heads over 1024 and 4096 tokens (each bf16
   case prints its worst element in bf16 steps of its value).
13. The sharded serving steps and the dry-run (``phase_serve_mesh``,
   ``phase_dryrun``).  granite-3-8b at full width and depth in bf16 (the
   parameters of ``phase_serve``'s seed) through
   ``train.step.build_prefill_step``/``build_decode_step`` on a one-rank
   NCCL mesh (every axis 1), 4 x 2048 prompts and 32 decoded tokens:
   prefill logits and cache and every decoded token's logits equal
   ``Model.prefill``/``decode`` bit for bit, 40 flash launches a
   prefill and none in decode, each step's time and peak memory beside
   the plain calls'.  Then ``launch.dryrun``'s predicted per-device peak
   bytes, run in subprocesses on a fake process group (started after the
   build, collected here), against the bytes the card allocated for the
   same step (the step's argument bytes plus ``max_memory_allocated``
   above what was allocated just before it): the qwen1.5-0.5b train step
   at 4 x 2048 on a one-rank mesh (``phase_dp``'s) and the granite
   prefill above, each within DRYRUN_MEM_TOL; the train cell's record
   without its optimizer state must miss that bound.  The production
   cell granite-3-8b ``train_4k`` on the 16 x 16 mesh (256 fake ranks,
   DRYRUN_PROD_MBS rows a micro-batch) is printed with its seconds; each
   kernel op's shape function gives a real launch's output shapes, dtypes
   and strides.
14. The colocated compound steps on a mesh and the compound dry-run
   (``phase_dryrun_compound``), on a one-rank NCCL mesh under
   deterministic algorithms: phase_distill's qwen1.5-0.5b
   self-distillation (teacher seed 1, 4 x 2048, alpha 0.5, T 2) through
   ``distill.workload.build_colocated_step(..., mesh=)`` for
   DISTILL_STEPS steps, and phase_mllm's MLLM colocated step (the ViT at 12
   of 24 layers, pixtral-12b width at 2 layers, 8 x 2048 in microbatches of
   2) through ``mllm.workload.build_colocated_step(..., mesh=)`` for
   MESH_MLLM_ITERS iterations, each equal bit for bit (metrics and
   parameters) to its meshless step and launching flash and the KL kernel
   as often; ``launch.dryrun_compound``'s predicted peak bytes for that
   distill step at world size 1 (a subprocess started after the build)
   against the card's bytes for its first mesh step, within
   DRYRUN_MEM_TOL, the record's ops holding the KL op; and the production
   compound cells (distillation granite-3-8b -> granite-3-8b ``train_4k``
   at full depth, MLLM at phase_mllm's depths, multi-teacher at
   phase_multi_teacher's models) on the 16 x 16 mesh, recorded one after
   another in one background subprocess and printed with their seconds
   and depths.
15. Tensor parallelism past the KV heads (``phase_tp_repeat``): the
   granite-3-8b attention sub-layer at full width in bf16, 4 x 2048, as
   the 16 model ranks of tp 16 compute it, one after another on the card:
   each rank's blocks from its coordinate alone
   (``dist.pipeline.tp_rank_blocks``: 2 query heads on the one KV head of
   their group, so flash at (4, 2048, 2048, 2, 1, 128)); the 16 partial
   outputs summed (the row-parallel all-reduce) against the whole
   sub-layer within TP_REPEAT_TOL of its largest element, and the 16
   ranks' ``wk``/``wv`` gradients summed over each KV head's 2 ranks
   (``dist.sharding.fold_repeats``) against autograd of the whole within
   TP_REPEAT_GRAD_TOL; a share left out and one copy's gradient must miss
   them; flash launched at least once a share.  The flash kernel is also
   held and timed at that shape, and ``phase_dryrun`` and
   ``phase_dryrun_compound`` print the production cells, now with each KV
   head repeated over its query-head group, beside their records with
   attention whole.
16. Vocab-parallel cross-entropy (``phase_vocab_parallel``): qwen1.5-0.5b
   at full width and depth in bf16, 4 x 2048, its final hidden states from
   a forward through the flash kernel (24 launches), then the
   cross-entropy as the 8 model ranks of tp 8 compute it with the tied
   embedding split into 8 slices of 18992 rows, one slice after another
   on the card: each slice's row maxima, then its exponential sums and
   gold logits at the maximum over the slices, summed over the slices as
   the all-reduces do (``dist.pipeline.vocab_max``, ``vocab_partials``,
   ``vocab_nll``), and each slice's gradient (``vocab_grad``) through its
   own logits into ``h`` (summed over the slices, Megatron's ``f``) and
   its ``embed`` rows.  The loss, ``h``'s gradient and each slice's
   ``embed`` gradient against the whole-vocabulary ``cross_entropy`` and
   autograd, within VP_LOSS_TOL and VP_GRAD_TOL; the first slice left out
   of the exponential sum must miss them.  Then the peak bytes and time
   of one rank's share (``vocab_parallel_nll`` on a one-rank NCCL group,
   forward and backward) against the whole cross-entropy's.
   ``phase_dp``, ``phase_dryrun`` and ``phase_dryrun_compound`` feed the
   mesh steps this rank's block of each batch (``step.block``; at world
   size 1 the whole batch), and the production cells print beside their
   records with the whole batch on every rank and the whole vocabulary on
   every model rank (PRODUCTION_BEFORE).
17. A ``{"kernels": [...]}`` line with each kernel's launches on the main
   paths, error and times (the flash and SSD kernels' at each of their
   main-path shapes under ``at``, the flash backward's at each training
   shape, the KL backward's at N = 8192 and 4096, the SSD backward's at
   mamba2-130m's; the top-level times are
   granite's serving prefill's, mamba2-130m's, qwen1.5-0.5b's training
   attention's and its distillation step's KL), then the ``{"ok": true,
   ...}`` line.  Every path that trains through attention must have
   launched the flash backward, and no serving or forward-only path may
   have; every path's KL backward launches must equal its KL forward
   launches (some on each distillation path, none elsewhere); the SSD
   backward must be launched steps x layers times training mamba2-130m
   and no time on any other path.  Each phase
   prints its wall time.

Any failed check raises, so the script exits non-zero and prints no
result.  It exits non-zero without a CUDA card, and when run from a
directory that holds no ``src/repro_torch``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet (dense): bf16 tensor-core peak and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the libraries whose bf16 path runs wgmma on TMA-fed shared memory, and the
# SASS instructions that show it
TENSOR_CORE_LIBS = ("flash_fwd", "flash_bwd", "distill_kl_fwd",
                    "distill_kl_bwd", "ssd_fwd", "ssd_bwd")
# the libraries whose tensor-core kernels' (``*_tc``) spills are printed
SPILL_REPORT_LIBS = ("ssd_bwd",)
SASS_OPS = ("HGMMA", "UTMALDG")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# At a main-path flash shape the bf16 limit is also at most this share of
# max|o_ref|, four bf16 ulps of the largest output: where a softmax spreads
# over thousands of keys (the ViT's non-causal rows) |o| is about 0.2 at
# most, and the absolute 2e-2 would pass an epilogue that scales o by 0.85.
# A planted fault, o * 0.9, must fail the limit at each shape.  At the
# ViT's (2, 4096, 4096, 16, 16, 64) on an H100 80GB HBM3 at 700 W:
# max|o_ref| 0.2188, limit 6.836e-3, the kernel 9.766e-4 (one bf16 ulp),
# the planted fault 2.188e-2; at the causal shapes the absolute 2e-2
# stays the lower limit (max|o_ref| 3.1-4.3, errors 7.8e-3-1.56e-2).
# There max|o_ref| comes from the first rows, which see a few keys, while
# rows that see thousands have |o| near 0.02; so each query row is also
# held to this share of its own max|o_ref|, and o * 0.9 on the rows past
# the window (or the second half) must fail that.  At every main-path
# shape, the same card: the kernel 7.812e-3 (one bf16 ulp of a row's
# largest output), the planted fault 1.096e-1.
SHAPE_REL_TOL = 2.0 ** -5
# The backward at the training shapes is held row by row to SHAPE_REL_TOL
# (``_bwd_at``), a dq row's scale floored at this share of dq's largest
# element: a causal shape's first query row sees one key, so its
# dS = P (dP - delta) cancels to rounding noise on both sides (exactly 0
# in the plain version), while a row that sees more keys has a dq of its
# own.  dk and dv rows have no floor: no key's gradient cancels, and the
# last keys' rows, far below the first keys', are held to their own
# scale.  ``_bwd_at`` prints how many dq rows fall under the floor beside
# how many query rows see one key, and each gradient's smallest row.
BWD_ROW_FLOOR = 2.0 ** -10
# rows a block of the backward owns (the dK/dV kernel's KV tile, the dQ
# kernel's q tile): the planted faults zero the last such tile
BWD_TILE = 128
# tests/test_kernels_flash.py's sweep (B, S, T, H, KV, D), plus a ragged
# length and a cross-attention case: S != T with T ragged (whisper's 1500
# encoder frames)
SWEEP = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
         (2, 128, 64, 4, 1, 16), (1, 64, 64, 6, 3, 8),
         (2, 200, 200, 4, 2, 64), (2, 96, 1500, 4, 4, 64)]
MODES = [(True, 0), (False, 0), (True, 32)]
PREFILL = (4, 2048, 2048, 32, 8, 128)    # granite-3-8b serving prefill
TRAIN_ATTN = (4, 2048, 2048, 16, 16, 64)  # qwen1.5-0.5b train and distill
ARCH = "granite-3-8b"
# flash gradients: f32 (TF32 off) within 1e-4; bf16 within 2e-2, about one
# bf16 step at the gradients' magnitude (up to ~4): both sides compute in
# f32, the kernel's o is rounded to bf16 before the backward reads it
GRAD_SWEEP = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
              (2, 200, 200, 4, 2, 64), (2, 96, 1500, 4, 4, 64)]
GRAD_MODES = [(True, 0), (False, 0), (True, 32)]
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# distill_kl statistics and KL: both sides sum f32 products of the same
# inputs in other orders, over D <= 1024 and V <= 151936, on values up to
# ~15 (lse); 2e-4 is far below what a wrong max, scale or tile moves
KL_TOL = 2e-4
# N, Ds, Dt, V, dtype, T, W layout, masked
KL_SWEEP = [(200, 64, 96, 1000, torch.float32, 1.0, "rows", False),
            (333, 128, 64, 5003, torch.bfloat16, 2.0, "embed_t", True),
            (64, 256, 256, 64, torch.float32, 2.0, "embed_t", True),
            (1000, 1024, 1024, 4099, torch.bfloat16, 1.0, "embed_t", False),
            (129, 96, 160, 2000, torch.float32, 1.0, "rows", True),
            (77, 1024, 512, 30000, torch.bfloat16, 2.0, "rows", False)]
# The KL backward (``csrc/distill_kl_bwd.cu`` and its products) against
# ``ref.distill_kl_bwd_ref``, one row of dh and one vocabulary column of
# dW at a time, each held to its own scale (max |ref| of the row or
# column): bf16 within SHAPE_REL_TOL (the kernel rounds dz to bf16, both
# sides round dW to bf16), float32 (TF32 off) within 1e-4 (sums in other
# orders over up to 151936 columns or 8192 tokens).  A row or column
# whose scale is 0 (a masked token's dh) reads 0 on both sides.  Planted
# faults, the last vocabulary chunk's dW columns zeroed and its
# contribution to dh dropped, must fail the limit.
KL_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: SHAPE_REL_TOL}
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS = 4
DISTILL_STEPS = 3
# SSD scan kernel against ssd_scan_ref, both f32 inside: f32 inputs (TF32
# off) within 1e-4 of 1 + |ref| (sums in other orders over n <= 128 and
# 64-token chunks); bf16 within 1e-2, past the one bf16 step (at most
# 2**-7 relative) by which two roundings of nearly equal f32 sums differ:
# y is rounded to bf16 once on each side, from f32 sums taken in other
# orders (the kernel's chunk states pass between its two kernels as bf16
# hi + lo parts, whose sum keeps 16 bits).
# The final state is f32 on both sides: 1e-4 in both dtypes.
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 1e-4
# (b, s, h, p, n): tests/test_kernels_ssd.py's sweep, a ragged length, one
# chunk's, mamba2-130m's p and n at the consistency check's ragged 4094,
# jamba's p and n (n = 16, padded to 64 on the tensor cores)
SSD_SWEEP = [(2, 64, 3, 8, 16), (1, 128, 2, 16, 8), (2, 48, 4, 8, 4),
             (1, 200, 2, 16, 8), (2, 4094, 4, 64, 128), (1, 130, 3, 80, 72),
             (1, 200, 4, 64, 16)]
SSD_MAIN = (4, 4096, 24, 64, 128)       # mamba2-130m training and prefill
SSD_JAMBA = (2, 16384, 128, 64, 16)     # jamba-v0.1-52b's prefill
# jamba's heads at shorter prompts: does y's error grow with the length?
SSD_JAMBA_SHORT = [(2, 1024, 128, 64, 16), (2, 4096, 128, 64, 16)]
# 1024 chunks: 2048 blocks of the bf16 output kernel, far more than the
# card holds at once, each reading a state the state kernel carried
# through up to 1023 chunks
SSD_LONG = (2, 65536, 8, 64, 128)
# SSD gradients through ops.ssd_scan against autograd through the
# sequential oracle, relative to the leaf's largest gradient: f32 within
# 1e-3 (the backward sums over up to 256 tokens in other orders); bf16
# within 2e-2, a few bf16 steps (x, B, C and their gradients are bf16)
SSD_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
SSD_GRAD_SWEEP = [((2, 64, 3, 8, 16), 16), ((2, 64, 3, 8, 16), 128),
                  ((1, 128, 2, 16, 8), 32), ((2, 48, 4, 8, 4), 16),
                  ((1, 200, 2, 16, 8), 64), ((1, 200, 4, 64, 16), 64)]
# The SSD backward (``csrc/ssd_bwd.cu``) against ``ref.ssd_bwd_ref``: both
# sides f32 arithmetic from the same inputs, sums in other orders.  Each
# f32 output within 1e-4 of its leaf's largest element; a bf16 dx, dB or
# dC row (dx over p, dB and dC over n) within SHAPE_REL_TOL of its own
# scale, as the KL backward's rows (both sides round once to bf16).
# (shape, A): a constant A = -0.05 keeps ~0.1 of a chunk's state past the
# next chunk, so the carries between chunks weigh in the gradients; None
# draws A = -exp(N(0,1)) as the forward's sweep does
SSD_BWD_TOL = 1e-4
SSD_BWD_SWEEP = [((2, 64, 3, 8, 16), None), ((1, 200, 2, 16, 8), -0.05),
                 ((2, 48, 4, 8, 4), None), ((1, 130, 3, 80, 72), -0.05),
                 ((2, 4094, 4, 64, 128), -0.05), ((1, 200, 4, 64, 16), None),
                 ((2, 700, 26, 64, 128), -0.05)]
# (shape, A) at which the bf16 backward also runs with gy moved off TMA's
# 16-byte alignment, so that every tile loads by threads: its outputs must
# equal TMA's bit for bit
SSD_BWD_ROUTE = ((1, 200, 4, 64, 16), None)
MAMBA = "mamba2-130m"
MAMBA_B, MAMBA_S = 4, 4096


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _randn(rng, shape, dtype, device="cuda"):
    x = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
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


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib: Path) -> dict:
    """Counts of HGMMA and UTMALDG instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr}")
    return {op: sum(1 for line in out.stdout.splitlines() if op in line)
            for op in SASS_OPS}


def tc_spills(log: str) -> dict:
    """Spill bytes (stores + loads) of each tensor-core kernel (an entry
    function with ``_tc`` in its name) in an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill stores" in line and name and "_tc" in name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name] = nums[1] + nums[2]    # stack, stores, loads
            name = None
    check(bool(out), "no tensor-core kernel in the ptxas log")
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build
    print(f"card: {card()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    builds = _build.build_all()            # every csrc source
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(builds)} sources in parallel")
    for name, built in builds.items():
        print(f"build {name}: {built.seconds:.1f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
            elif ("Compiling entry function" in line
                  or "Performance Loss" in line):
                print("  ptxas:", line.strip()[:200])
    # the bf16 paths must run on the tensor cores (HGMMA) from TMA loads
    # (UTMALDG): count both in the SASS of each library that has them
    for name in TENSOR_CORE_LIBS:
        counts = sass_counts(builds[name].path)
        print(f"sass {name}: " + ", ".join(f"{k} {v}"
                                          for k, v in counts.items()))
        check(all(counts.values()),
              f"{name}'s SASS lacks one of {SASS_OPS}: {counts}")
    for name in SPILL_REPORT_LIBS:
        spills = tc_spills(builds[name].log)
        print(f"spills {name} (tensor-core kernels, bytes stored + loaded): "
              + ", ".join(f"{k.split('2tc')[-1][:40]} {v}"
                          for k, v in spills.items()))
    # the float32 plain versions must not round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmuls and cuDNN")


def compare(o, lse, o_ref, lse_ref, vis, dtype) -> float:
    """Max |o - o_ref| over rows with a visible key; lse checked beside it."""
    vis = vis.to(o.device)
    check(bool(torch.isfinite(o).all()), "kernel output not finite")
    err = 0.0
    if vis.any():
        err = (o.float() - o_ref.float())[:, vis].abs().max().item()
        lerr = (lse - lse_ref)[:, vis].abs().max().item()
        check(err <= TOL[dtype], f"o error {err:.3e} > {TOL[dtype]}")
        check(lerr <= LSE_TOL, f"lse error {lerr:.3e} > {LSE_TOL}")
    if not vis.all():
        check(bool((lse[:, ~vis] <= -1e29).all())
              and bool((o[:, ~vis] == 0).all()),
              "rows with no visible key must give o = 0, lse <= -1e29")
    return err


def row_rel_err(o, o_ref, floor: float = 0.0) -> float:
    """Max over rows (every index but the last axis's: a query row (b, s,
    h) of o or dq, a key row (b, t, kv) of dk or dv) of max_d |o - o_ref|
    / max_d |o_ref|: each row held to its own scale, or to ``floor`` where
    that is larger (a row with no visible key, 0 on both sides, reads
    0)."""
    ref = o_ref.float()
    num = (o.float() - ref).abs().amax(dim=-1)
    den = ref.abs().amax(dim=-1).clamp_min(max(floor, 1e-30))
    return (num / den).max().item()


def plain_rows(q, k, v, *, rows: int, q_offset: int = 0, **kw):
    """The plain version over ``rows`` query rows at a time (each slice at
    its own ``q_offset``, all keys), for a shape whose [B, H, S, T] float32
    scores do not fit the card."""
    from repro_torch.kernels.ref import flash_attention_ref
    outs = [flash_attention_ref(q[:, i:i + rows], k, v, q_offset=q_offset + i,
                                **kw) for i in range(0, q.shape[1], rows)]
    return (torch.cat([o for o, _ in outs], dim=1),
            torch.cat([lse for _, lse in outs], dim=1))


def run_case(rng, shape, dtype, causal, window, q_offset=0, positions=None,
             strided=False, rows=0):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref, visible_mask
    B, S, T, H, KV, D = shape
    if strided:     # [B, H, S, D] storage seen as [B, S, H, D]
        q = _randn(rng, (B, H, S, D), dtype).transpose(1, 2)
        k = _randn(rng, (B, KV, T, D), dtype).transpose(1, 2)
        v = _randn(rng, (B, KV, T, D), dtype).transpose(1, 2)
    else:
        q = _randn(rng, (B, S, H, D), dtype)
        k = _randn(rng, (B, T, KV, D), dtype)
        v = _randn(rng, (B, T, KV, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_positions=positions)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    plain = (functools.partial(plain_rows, rows=rows) if rows
             else flash_attention_ref)
    o_ref, lse_ref = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    vis = visible_mask(S, T, causal=causal, window=window, q_offset=q_offset,
                       kv_positions=positions, device=q.device).any(dim=1)
    err = compare(o, lse, o_ref, lse_ref, vis, dtype)
    print(f"  flash {shape} {str(dtype)[6:]} causal={causal} window={window}"
          f" q_offset={q_offset} positions={positions is not None}"
          f"{' strided' if strided else ''}: "
          f"max|o-ref| {err:.3e} (tol {TOL[dtype]:.0e}), "
          f"hidden rows {int((~vis).sum())}")
    return q, k, v, o, o_ref, err


def phase_sweep(rng) -> None:
    print("flash kernel vs plain version (f32 tol 2e-5, bf16 tol 2e-2, "
          f"lse tol {LSE_TOL:.0e})")
    for shape in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in MODES:
                run_case(rng, shape, dtype, causal, window)
    perm = torch.from_numpy(rng.permutation(128).astype(np.int32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in MODES:
            run_case(rng, (1, 64, 128, 4, 2, 32), dtype, causal, window,
                     q_offset=32, positions=perm)
        run_case(rng, (2, 200, 200, 4, 2, 64), dtype, True, 0, strided=True)
    # segment ids (packed sequences): the kernel has no segment operand, so
    # CUDA tensors with segment ids must raise, not reach the plain version
    from repro_torch.kernels import ops
    q = torch.zeros((1, 64, 2, 16), device="cuda")
    seg = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    try:
        ops.flash_attention(q, q, q, segment_q=seg, segment_kv=seg)
    except ValueError as e:
        check("B5" in str(e), f"segment-id refusal names no ROADMAP item: {e}")
    else:
        check(False, "CUDA tensors with segment ids did not raise")
    print("  flash with segment ids on CUDA tensors: ValueError (B5)")


def phase_flash_shape(rng, shape, causal: bool = True, bwd: bool = True,
                      window: int = 0, rows: int = 0,
                      positions=None) -> dict:
    """The kernel at one main-path shape (bf16; causal, or bidirectional as
    in the ViT and whisper's encoder, or cross-attention with S != T; with
    a sliding ``window``): checked against its plain version within
    SHAPE_REL_TOL of the output's scale and, row by row, of each query
    row's own scale, then timed beside the plain version and PyTorch's
    ``scaled_dot_product_attention``.  With ``bwd`` (a training shape) the
    backward kernel is checked and timed there too (``_bwd_at``).  With
    ``rows`` the plain version
    runs over that many query rows at a time (``plain_rows``).  With a
    window the kernel run without it must fail the same limit, and it is
    timed without it too (``nowindow_ms``: what skipping the tiles outside
    the window saves).  ``positions`` are explicit key positions (a CP
    chunk's, ``cp_positions``); SDPA then takes their boolean mask."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref, visible_mask
    B, S, T, H, KV, D = shape
    q, k, v, o, o_ref, err = run_case(rng, shape, torch.bfloat16, causal,
                                      window, positions=positions, rows=rows)
    kw = dict(causal=causal, window=window, kv_positions=positions)
    top = o_ref.float().abs().max().item()
    tol = min(TOL[torch.bfloat16], SHAPE_REL_TOL * top)
    planted = (0.9 * o.float() - o_ref.float()).abs().max().item()
    print(f"  max|o_ref| {top:.3e}: limit {tol:.3e}; max|o-ref| {err:.3e}, "
          f"planted o*0.9 {planted:.3e}")
    check(err <= tol, f"flash at {shape}: max|o-ref| {err:.3e} > {tol:.3e}")
    check(planted > tol, f"flash at {shape}: the limit {tol:.3e} passes a "
          f"planted o*0.9 ({planted:.3e})")
    # row by row: the rows past the window (or, without one, the second
    # half) attend to thousands of keys and their |o| is far below the
    # first rows'; a fault that touches only them must fail too
    rerr = row_rel_err(o, o_ref)
    s0 = window or S // 2
    bad = o.clone()
    bad[:, s0:] *= 0.9
    rplanted = row_rel_err(bad, o_ref)
    del bad
    print(f"  row by row: max over rows of max|o-ref| / max|o_ref| "
          f"{rerr:.3e} (limit {SHAPE_REL_TOL:.3e}); planted o*0.9 on rows "
          f">= {s0} {rplanted:.3e}")
    check(rerr <= SHAPE_REL_TOL, f"flash at {shape}: a row's max|o-ref| is "
          f"{rerr:.3e} of its max|o_ref| > {SHAPE_REL_TOL:.3e}")
    check(rplanted > SHAPE_REL_TOL, f"flash at {shape}: the row limit "
          f"passes o*0.9 on rows >= {s0} ({rplanted:.3e})")
    out = {}
    if window:
        o_nw = fa.flash_fwd(q, k, v, causal=causal,
                            kv_positions=positions)[0]
        unwindowed = (o_nw.float() - o_ref.float()).abs().max().item()
        rnw = row_rel_err(o_nw, o_ref)
        del o_nw
        print(f"  planted: the kernel without the window {unwindowed:.3e} "
              f"from the windowed plain version, row by row {rnw:.3e}")
        check(unwindowed > tol and rnw > SHAPE_REL_TOL,
              f"flash at {shape}: the limits pass the kernel run without "
              f"its window ({unwindowed:.3e}, row by row {rnw:.3e})")
        out["nowindow_ms"] = time_ms(
            lambda: fa.flash_fwd(q, k, v, causal=causal,
                                 kv_positions=positions), iters=10)
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, **kw), iters=10)
    plain = (functools.partial(plain_rows, rows=rows) if rows
             else flash_attention_ref)
    plain_ms = time_ms(lambda: plain(q, k, v, **kw), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    # the rows with a visible key (SDPA gives NaN on the others)
    vis = visible_mask(S, T, **kw, device=q.device).any(dim=1)
    if window or positions is not None:
        # a boolean mask, and K/V repeated to H heads beforehand: the
        # backend that takes an arbitrary mask takes no grouped heads
        mask = visible_mask(S, T, **kw, device=q.device)
        kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  for x in (k, v))

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask)
    else:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

    lib_err = (library().transpose(1, 2).float()
               - o.float())[:, vis].abs().max().item()
    library_ms = time_ms(library, iters=10)
    if bwd:
        _, lse = fa.flash_fwd(q, k, v, **kw)
        out["bwd"] = _bwd_at(rng, shape, q, k, v, o, lse, kw)
    # query-key pairs the mask lets through
    pairs = int(visible_mask(S, T, **kw, device=q.device).sum())
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * T * KV * D) + 4 * B * S * H \
        + (4 * T if positions is not None else 0)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"flash at {shape} bf16 {'causal' if causal else 'non-causal'}"
          f"{f' window {window}' if window else ''}"
          f"{' kv_positions' if positions is not None else ''}: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"sdpa {library_ms:.3f} ms (|sdpa-kernel| {lib_err:.3e}), "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)"
          + (f"; backward kernel {out['bwd']['ms']:.3f} ms" if bwd else "")
          + (f"; without the window {out['nowindow_ms']:.3f} ms"
             if window else ""))
    return {"shape": list(shape), "causal": causal, "window": window,
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **out}


#: the flash backward's three kernels, each launched once a call
FLASH_BWD_PARTS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")


def flash_bwd_parts(split: dict) -> dict:
    """``_kernel_split``'s ms by kernel name summed into the backward's
    three parts, keyed ``delta``, ``dkdv`` and ``dq``."""
    return {part.removeprefix("flash_bwd_"): sum(
        t for name, t in split.items() if part in name)
        for part in FLASH_BWD_PARTS}


def sdpa_backward(q, k, v, do, causal: bool):
    """A call of the backward of ``scaled_dot_product_attention`` (the
    flash backward's library yardstick) on [B, S, H, D] inputs: its forward
    runs once here, each call computes dq, dk and dv."""
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal, enable_gqa=True)
    do_t = do.transpose(1, 2)
    return lambda: torch.autograd.grad(o, leaves, do_t, retain_graph=True)


def _bwd_at(rng, shape, q, k, v, o, lse, kw) -> dict:
    """The backward kernel at one training shape (bf16): dq row by row, each
    query row within SHAPE_REL_TOL of its own scale, and dk and dv each key
    row within SHAPE_REL_TOL of its own (at a causal shape the first rows'
    and keys' gradients are tens of times a typical row's, so a limit on
    the largest element alone would pass most rows wrong).  A dq row's
    scale is floored at BWD_ROW_FLOOR of dq's largest element: a query row
    that sees one key has dS = P (dP - delta) = 0 in exact arithmetic, and
    its dq is rounding noise on both sides.  Planted faults, each
    gradient's last BWD_TILE rows zeroed (one block's rows in either
    kernel), must fail the row limit; two calls are equal bit for bit (the
    kernels use no atomics).  Then timed beside the plain version and the
    backward of ``scaled_dot_product_attention`` (the yardstick,
    ``library_ms``: PyTorch's fused attention, which the port never
    calls).  The bound counts 10 D FLOP a visible pair and query head at
    the bf16 peak, against q, k, v, o, do and lse read and dq, dk, dv
    written once at the HBM rate; its delta, dK/dV and dQ kernels are
    traced apart (``kernels``), each beside its share of the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, visible_mask
    B, S, T, H, KV, D = shape
    do = _randn(rng, (B, S, H, D), torch.bfloat16)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    want = flash_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs, rows, planted, smallest = {}, {}, {}, {}
    for name, g, w in zip(names, got, want):
        check(bool(torch.isfinite(g).all()), f"flash_bwd {name} at {shape} "
              "not finite")
        errs[name] = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().amax(dim=-1)
        top = scale.max().item()
        floor = BWD_ROW_FLOOR * top if name == "dq" else 0.0
        smallest[name] = scale.min().item() / top
        if name == "dq":
            under = int((scale < floor).sum())
        del scale
        rows[name] = row_rel_err(g, w, floor)
        bad = g.clone()
        bad[:, -BWD_TILE:] = 0
        planted[name] = row_rel_err(bad, w, floor)
        del bad
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    one_key = int((visible_mask(S, T, **kw, device=q.device).sum(dim=1)
                   == 1).sum()) * B * H
    print(f"  backward: {under} dq rows under the floor, {one_key} query "
          "rows see one key; smallest row / largest " + ", ".join(
              f"{n} {smallest[n]:.3e}" for n in names))
    print(f"  backward row by row (limit {SHAPE_REL_TOL:.3e}): " + ", ".join(
        f"{n} {rows[n]:.3e} (max|g-ref| {errs[n]:.3e}), planted last "
        f"{BWD_TILE} rows zeroed {planted[n]:.3e}" for n in names)
        + f"; two calls bitwise equal {bitwise}")
    for n in names:
        check(rows[n] <= SHAPE_REL_TOL, f"flash_bwd at {shape}: a row's "
              f"max|{n}-ref| is {rows[n]:.3e} of its scale > "
              f"{SHAPE_REL_TOL:.3e}")
        check(planted[n] > SHAPE_REL_TOL, f"flash_bwd at {shape}: the row "
              f"limit passes {n} with its last {BWD_TILE} rows zeroed "
              f"({planted[n]:.3e})")
    check(bitwise, f"flash_bwd at {shape}: two calls differ")
    del got, again, want
    ms = time_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw), iters=10)
    plain_ms = time_ms(lambda: flash_bwd_ref(q, k, v, o, lse, do, **kw),
                       iters=3, warmup=1)
    library_ms = time_ms(sdpa_backward(q, k, v, do, kw["causal"]), iters=10)
    pairs = int(visible_mask(S, T, **kw, device=q.device).sum())
    flops = 10 * B * H * D * pairs
    nbytes = 2 * (4 * B * S * H * D + 4 * B * T * KV * D) + 4 * B * S * H
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    # the three kernels apart, traced over a few calls, each beside its
    # share of the bound: delta reads o and do once and writes delta; dK/dV
    # does 8 D of the 10 D FLOP a pair; dQ does 2 D of work, and recomputes
    # S and dP (4 D more) where a fused kernel would not
    split = flash_bwd_parts(_kernel_split(
        lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw), iters=5,
        key="flash_bwd_", once=FLASH_BWD_PARTS))
    shares = {"delta": (2 * 2 * B * S * H * D + 4 * B * S * H)
              / HBM_BYTES_PER_S * 1e3, "dkdv": 0.8 * t_ops, "dq": 0.2 * t_ops}
    kernels = {part: {"ms": split[part], "bound_ms": share}
               for part, share in shares.items()}
    kernels["dq"]["bound_with_recompute_ms"] = 0.6 * t_ops
    print(f"flash backward at {shape} bf16 "
          f"{'causal' if kw['causal'] else 'non-causal'}: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s counted), plain {plain_ms:.3f} "
          f"ms, sdpa backward {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    print("  its kernels (traced): " + ", ".join(
        f"{part} {x['ms']:.4f} ms (bound share {x['bound_ms']:.4f}"
        + (f", {x['bound_with_recompute_ms']:.4f} with the recompute"
           if part == "dq" else "") + ")" for part, x in kernels.items()))
    return {"max_abs_err": max(errs.values()), "errs": errs,
            "row_errs": rows, "planted_tile_zeroed": planted,
            "dq_rows_under_floor": under, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "kernels": kernels}


def flash_entry(at: dict) -> dict:
    """The flash kernel's line: the serving prefill shape's numbers at the
    top, each main-path shape's under ``at``, the worst error of all."""
    at = {name: {k: v for k, v in a.items() if k != "bwd"}
          for name, a in at.items()}
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:51",
            "launches": None,
            **{k: v for k, v in at["serve"].items()
               if k not in ("shape", "causal", "window")},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def flash_bwd_entry(at: dict) -> dict:
    """The backward kernel's line: qwen1.5-0.5b's training shape's numbers
    at the top, each training shape's under ``at``, the worst error."""
    at = {name: {"shape": a["shape"], "causal": a["causal"], **a["bwd"]}
          for name, a in at.items() if "bwd" in a}
    top = at["train_distill"]
    return {"name": "flash_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:203",
            "launches": None,
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def reset_counts() -> None:
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    dk.distill_kl_fwd.launches = 0
    dk.distill_kl_bwd.launches = 0
    ssd.ssd_fwd.launches = 0
    ssd.ssd_bwd.launches = 0


def read_counts() -> tuple[int, int, int]:
    """(flash_fwd, distill_kl_fwd, ssd_fwd) launches since reset_counts;
    the backward's are read beside them by ``note_bwd``."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    return (fa.flash_fwd.launches, dk.distill_kl_fwd.launches,
            ssd.ssd_fwd.launches)


#: flash_bwd and distill_kl_bwd launches on each main path, keyed as
#: main()'s ``paths``, read where the path's forward counts are read
#: (``note_bwd``); main() checks them and puts them on the kernels line
BWD_LAUNCHES: dict = {}
KL_BWD_LAUNCHES: dict = {}
SSD_BWD_LAUNCHES: dict = {}


def read_bwd() -> int:
    """flash_bwd launches since reset_counts (one a backward call, its
    three kernels launched together)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_bwd.launches


def read_kl_bwd() -> int:
    """distill_kl_bwd launches since reset_counts (one a backward call, its
    chunks' kernels and products together)."""
    from repro_torch.kernels import distill_kl as dk
    return dk.distill_kl_bwd.launches


def read_ssd_bwd() -> int:
    """ssd_bwd launches since reset_counts (one a backward call, its
    kernels launched together: three for bf16, four for float32)."""
    from repro_torch.kernels import ssd_scan as ssd
    return ssd.ssd_bwd.launches


def note_bwd(path: str) -> int:
    """Record read_bwd(), read_kl_bwd() and read_ssd_bwd() as ``path``'s
    launches, and return the first."""
    BWD_LAUNCHES[path] = read_bwd()
    KL_BWD_LAUNCHES[path] = read_kl_bwd()
    SSD_BWD_LAUNCHES[path] = read_ssd_bwd()
    return BWD_LAUNCHES[path]


def phase_serve() -> int:
    from repro_torch.launch import serve as serve_mod
    torch.cuda.reset_peak_memory_stats()
    B, S, _, _, _, _ = PREFILL
    reset_counts()
    t0 = time.perf_counter()
    res = serve_mod.serve(ARCH, batch=B, prompt_len=S, gen=32,
                          dtype="bfloat16", device="cuda", seed=0)
    wall = time.perf_counter() - t0
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("serve")
    check(kl_launches == ssd_launches == 0,
          "serving granite launched the distill_kl or the SSD kernel")
    cfg = res.cfg
    print(res.summary())
    print(f"serve wall (init + prefill + decode): {wall:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res.prefill_launches == cfg.num_layers,
          f"prefill launched the kernel {res.prefill_launches} times, "
          f"expected {cfg.num_layers}")
    check(launches == cfg.num_layers, f"{launches} launches on the main path")
    check(tuple(res.tokens.shape) == (B, 32), f"tokens {res.tokens.shape}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "generated token outside the vocabulary")
    check(res.logits_finite, "non-finite logits")
    return launches


def _kernel_event(evt) -> bool:
    """A device event that is a kernel or a copy: not the device-side span
    that the profiler also records for each ``record_function`` range
    (``is_user_annotation``), which covers its kernels and the gaps between
    them and would count them twice."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def _range_ms(prof, keys) -> dict:
    """Device time of the kernels launched under each named range or
    autograd node (label -> key), read from the range's host-side events.
    Read from ``prof.events()``: ``key_averages()`` aggregates every event
    of the trace, seconds a trace, tens of seconds for one that records
    every thread."""
    per = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        for label, key in keys:
            if evt.name == key or evt.name.endswith(key):
                per[label] = per.get(label, 0.0) + evt.device_time_total / 1e3
    return per


def _device_ms(prof) -> tuple[float, dict]:
    """Total device time of a trace and its time by kernel, in ms."""
    per = {}
    for evt in prof.events():
        if _kernel_event(evt):
            per[evt.name] = (per.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / 1e3)
    per = {k: v for k, v in per.items() if v > 0}
    return sum(per.values()), per


def phase_profile(rng) -> None:
    """Where the time of a warm prefill and decode step goes: host wall time
    beside device time by kernel (torch.profiler), same model and shapes as
    the main path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    B, S = PREFILL[:2]
    cfg = serve_mod.resolve_config(ARCH, dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    serve_mod.generate(model, prompts, 2)                      # warm-up
    print("warm " + serve_mod.generate(model, prompts, 32).summary())
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts}, extra_cache=9)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            logits, cache = model.decode(cache, tok, S + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_d = (time.perf_counter() - t0) * 1e3 / 8
    for name, p, wall, per_what in (("prefill", prof, wall_p, "prefill"),
                                    ("decode", prof_d, wall_d, "token")):
        busy, per = _device_ms(p)
        if name == "decode":
            busy, per = busy / 8, {k: v / 8 for k, v in per.items()}
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        check(busy > 0, f"the profiler saw no device time in {name}")
        print(f"traced {name}: wall {wall:.1f} ms/{per_what}, device busy "
              f"{busy:.1f} ms ({100 * busy / wall:.0f}%, idle "
              f"{100 * (1 - busy / wall):.0f}%), {len(per)} kernel kinds")
        for key, ms in top:
            print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")


def phase_consistency(rng) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(ARCH).replace(num_layers=4, dtype="float32")
    model = build_model(cfg, device="cuda", seed=1)
    B, S = 2, 130
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    full = model({"tokens": tokens})
    logits, cache = model.prefill({"tokens": tokens[:, :S - 2]},
                                  extra_cache=2)
    errs = [(logits - full[:, S - 3]).abs().max().item()]
    for pos in (S - 2, S - 1):
        logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
        errs.append((logits - full[:, pos]).abs().max().item())
    scale = full.abs().max().item()
    # float32 with TF32 off: the kernel, cuBLAS and decode's einsums sum the
    # 4096-wide contractions in different orders; 1e-3 is far above that
    # rounding and far below what a wrong mask or cache slot moves (O(0.1))
    tol = 1e-3
    print(f"consistency {cfg.name} d_model={cfg.d_model} layers=4 f32, "
          f"S={S}: prefill/decode vs forward max|diff| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; "
          f"max |logit| {scale:.2f})")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")


def _grad_case(rng, shape, dtype, causal, window) -> float:
    """Worst relative gradient error of one case, with and without an lse
    cotangent; fails the run past GRAD_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, T, H, KV, D = shape
    leaves = [_randn(rng, s, dtype).requires_grad_()
              for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]
    do = _randn(rng, (B, S, H, D), torch.float32)
    dlse = _randn(rng, (B, S, H), torch.float32)
    kw = dict(causal=causal, window=window)
    worst = 0.0
    for with_lse in (False, True):
        if with_lse:
            o, lse = ops.flash_attention_lse(*leaves, **kw)
            loss = (o.float() * do).sum() + (lse * dlse).sum()
        else:
            o = ops.flash_attention(*leaves, **kw)
            loss = (o.float() * do).sum()
        check("FlashAttention" in type(o.grad_fn).__name__,
              f"CUDA attention output has grad_fn {o.grad_fn}")
        got = torch.autograd.grad(loss, leaves)
        o_r, lse_r = flash_attention_ref(*leaves, **kw)
        loss_r = (o_r.float() * do).sum()
        if with_lse:
            loss_r = loss_r + (lse_r * dlse).sum()
        want = torch.autograd.grad(loss_r, leaves)
        torch.cuda.synchronize()
        for name, g, w in zip("qkv", got, want):
            err = ((g.float() - w.float()).abs()
                   / (1 + w.float().abs())).max().item()
            worst = max(worst, err)
            check(err <= GRAD_TOL[dtype],
                  f"d{name} {shape} {dtype} causal={causal} window={window} "
                  f"lse={with_lse}: {err:.3e} > {GRAD_TOL[dtype]}")
    return worst


def phase_flash_grads(rng) -> None:
    """Gradients through the kernel's autograd Functions against autograd
    through the plain version, with and without an lse cotangent, over a
    sweep and at the training shape."""
    print("flash gradients: ops.flash_attention[_lse] (forward and "
          "backward kernels) vs autograd through the plain version "
          f"(f32 tol {GRAD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{GRAD_TOL[torch.bfloat16]:.0e})")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in GRAD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in GRAD_MODES:
                worst[dtype] = max(worst[dtype], _grad_case(
                    rng, shape, dtype, causal, window))
    print(f"  worst |grad - ref| / (1 + |ref|): f32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} "
          f"over {len(GRAD_SWEEP) * 2 * len(GRAD_MODES) * 2} cases")
    err = _grad_case(rng, TRAIN_ATTN, torch.bfloat16, True, 0)
    print(f"  at the training shape {TRAIN_ATTN} bf16 causal: "
          f"worst |grad - ref| / (1 + |ref|) {err:.3e} over 2 cases")


def _kl_inputs(rng, N, Ds, Dt, V, dtype, layout):
    h_s = _randn(rng, (N, Ds), dtype)
    h_t = _randn(rng, (N, Dt), dtype)
    ws, wt = ((_randn(rng, (V, D), torch.float32) * D ** -0.5).to(dtype).T
              if layout == "embed_t" else
              (_randn(rng, (D, V), torch.float32) * D ** -0.5).to(dtype)
              for D in (Ds, Dt))
    return h_s, ws, h_t, wt


def phase_kl_sweep(rng) -> None:
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import distill_kl_stats_ref
    print(f"distill_kl kernel vs plain version (stats and KL, tol {KL_TOL})")
    for N, Ds, Dt, V, dtype, T, layout, masked in KL_SWEEP:
        h_s, w_s, h_t, w_t = _kl_inputs(rng, N, Ds, Dt, V, dtype, layout)
        mask = (torch.from_numpy(rng.random(N) < 0.7).cuda()
                if masked else None)
        got = dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T)
        want = distill_kl_stats_ref(h_s, w_s, h_t, w_t, T)
        kl = ops.distill_kl(h_s, w_s, h_t, w_t, mask=mask, temperature=T)
        kl_ref = dk._kl_from_stats(*want, mask)
        torch.cuda.synchronize()
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        kl_err = abs(kl.item() - kl_ref.item())
        print(f"  distill_kl N={N} Ds={Ds} Dt={Dt} V={V} {str(dtype)[6:]} "
              f"T={T} {layout} mask={masked}: stats max err "
              f"{max(errs):.3e}, KL {kl.item():.5f} err {kl_err:.3e}")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "distill_kl stats not finite")
        check(max(errs) <= KL_TOL and kl_err <= KL_TOL,
              f"distill_kl disagrees with its plain version: {errs}, "
              f"{kl_err}")
        _kl_bwd_at(h_s, w_s, h_t, w_t, T, mask)


def _kl_tok_w(mask, N: int, T: float) -> torch.Tensor:
    """``DistillKL.backward``'s token weight at the cotangent g = 1."""
    if mask is None:
        return torch.full((N,), 1.0 / N / T, device="cuda")
    w = mask.float()
    return w / w.sum().clamp_min(1.0) / T


def _kl_bwd_at(h_s, w_s, h_t, w_t, T: float, mask=None) -> dict:
    """The KL backward (``distill_kl.distill_kl_bwd``: the dz kernel and its
    products) at one shape, student and teacher sides, against
    ``ref.distill_kl_bwd_ref`` on the kernel forward's statistics: each
    row of dh and each vocabulary column of dW within KL_BWD_TOL of its
    own scale.  Planted faults in the last vocabulary chunk (the columns
    of the op's last dz launch): dW's columns there zeroed, and dh without
    that chunk's part (the plain version's over those columns), must fail
    the limit.  Two calls are equal bit for bit (no atomics)."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels.ref import distill_kl_bwd_ref
    N, V = h_s.shape[0], w_s.shape[1]
    dtype = h_s.dtype
    stats = dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T)
    tok_w = _kl_tok_w(mask, N, T)
    needs = (True,) * 4
    got = dk.distill_kl_bwd(h_s, w_s, h_t, w_t, *stats, tok_w, T,
                            needs=needs)
    again = dk.distill_kl_bwd(h_s, w_s, h_t, w_t, *stats, tok_w, T,
                              needs=needs)
    want = distill_kl_bwd_ref(h_s, w_s, h_t, w_t, *stats, tok_w, T,
                              needs=needs)
    vc = dk.chunk_cols(N, V, dtype, sides=2)
    v_last = (V - 1) // vc * vc
    last = distill_kl_bwd_ref(h_s, w_s[:, v_last:], h_t, w_t[:, v_last:],
                              *stats, tok_w, T,
                              needs=(True, False, True, False))
    torch.cuda.synchronize()
    names = ("dh_s", "dw_s", "dh_t", "dw_t")
    rows, planted, errs = {}, {}, {}
    for name, g, w, part in zip(names, got, want,
                                (last[0], None, last[2], None)):
        check(bool(torch.isfinite(g).all()), f"distill_kl_bwd {name} at "
              f"N={N} V={V} not finite")
        errs[name] = (g.float() - w.float()).abs().max().item()
        if part is not None:          # dh: one row a token
            rows[name] = row_rel_err(g, w)
            planted[name] = row_rel_err(g.float() - part.float(), w)
        else:                         # dW: one row a vocabulary column
            rows[name] = row_rel_err(g.T, w.T)
            bad = g.clone()
            bad[:, v_last:] = 0
            planted[name] = row_rel_err(bad.T, w.T)
            del bad
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    tol = KL_BWD_TOL[dtype]
    print(f"    backward (both sides, {-(-V // vc)} chunk(s) of {vc}) row "
          f"by row (limit {tol:.3e}): " + ", ".join(
              f"{n} {rows[n]:.3e} (max|g-ref| {errs[n]:.3e}), planted "
              f"{planted[n]:.3e}" for n in names)
          + f"; two calls bitwise equal {bitwise}")
    for n in names:
        check(rows[n] <= tol, f"distill_kl_bwd at N={N} V={V}: a row of "
              f"{n} is {rows[n]:.3e} of its scale off > {tol:.3e}")
        check(planted[n] > tol, f"distill_kl_bwd at N={N} V={V}: the limit "
              f"passes {n} with the last chunk's part planted away "
              f"({planted[n]:.3e})")
    check(bitwise, f"distill_kl_bwd at N={N} V={V}: two calls differ")
    return {"max_abs_err": max(errs.values()), "errs": errs,
            "row_errs": rows, "planted_last_chunk": planted}


def phase_kl_main(rng, N: int) -> dict:
    """The kernel at one main-path shape: qwen1.5-0.5b's vocabulary and
    width, N tokens (a step's or a microbatch's), tied W as embed.T, T = 2;
    checked against its plain version, then timed beside it and the
    materialised form."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels.ref import distill_kl_stats_ref
    D, V, T = 1024, 151936, 2.0
    h_s, w_s, h_t, w_t = _kl_inputs(rng, N, D, D, V, torch.bfloat16,
                                    "embed_t")
    got = dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T)
    want = distill_kl_stats_ref(h_s, w_s, h_t, w_t, T)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= KL_TOL, f"distill_kl at the main shape: err {err:.3e}")
    kl = dk._kl_from_stats(*got).item()
    ms = time_ms(lambda: dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T), iters=3,
                 warmup=1)
    plain_ms = time_ms(lambda: distill_kl_stats_ref(h_s, w_s, h_t, w_t, T),
                       iters=3, warmup=1)

    def library(h_s=h_s, w_s=w_s):
        # the materialised form: both [N, V] logits in bf16, then f32
        ls = torch.log_softmax((h_s @ w_s).float() / T, dim=-1)
        lt = torch.log_softmax((h_t @ w_t).float() / T, dim=-1)
        return (lt.exp() * (lt - ls)).sum(-1).mean()

    lib_err = abs(library().item() - kl)
    library_ms = time_ms(library, iters=3, warmup=1)
    bwd = _kl_bwd_main(h_s, w_s, h_t, w_t, T, got, library)
    flops = 2 * N * V * (D + D)
    nbytes = 2 * (2 * N * D + 2 * D * V) + 4 * 4 * N
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"distill_kl main shape N={N} D={D} V={V} bf16 embed.T T={T}: "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms, materialised {library_ms:.3f} ms "
          f"(|KL diff| {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB); stats max err "
          f"{err:.3e}, KL {kl:.5f}")
    return {"N": N, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "bwd": bwd}


def _kl_bwd_main(h_s, w_s, h_t, w_t, T: float, stats, library) -> dict:
    """The backward at a main-path shape: checked as in the sweep (both
    sides), then timed on the student side, as the distillation paths run
    it (their teachers are detached): the whole op, its dz kernels alone
    and its products alone, the plain version, and autograd through the
    materialised form (``library``'s, for h_s and W_s).  The bound counts
    2 N V (Ds + Dt) + 4 N V Ds FLOP at the bf16 peak against h, W, the
    statistics and the token weight read and dh_s and dW_s written once."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels.ref import distill_kl_bwd_ref
    N, Ds = h_s.shape
    Dt, V = w_t.shape
    out = _kl_bwd_at(h_s, w_s, h_t, w_t, T)
    tok_w = _kl_tok_w(None, N, T)
    needs = (True, True, False, False)
    vc = dk.chunk_cols(N, V, h_s.dtype)
    dz = torch.empty((N, vc), dtype=h_s.dtype, device="cuda")
    dh = torch.zeros((N, Ds), dtype=torch.float32, device="cuda")
    dw = torch.empty_like(w_s)
    chunks = [(v0, min(vc, V - v0)) for v0 in range(0, V, vc)]

    def dz_only():
        for v0, n in chunks:
            dk.launch_dz(h_s, w_s, h_t, w_t, stats, tok_w, dz, None, v0, n,
                         1.0 / T)

    def products():
        for v0, n in chunks:
            dk._products(h_s, w_s, dz[:, :n], dh, dw, v0, n)

    ms = time_ms(lambda: dk.distill_kl_bwd(h_s, w_s, h_t, w_t, *stats,
                                           tok_w, T, needs=needs), iters=5)
    dz_ms = time_ms(dz_only, iters=5)
    products_ms = time_ms(products, iters=5)
    plain_ms = time_ms(lambda: distill_kl_bwd_ref(
        h_s, w_s, h_t, w_t, *stats, tok_w, T, needs=needs), iters=2,
        warmup=1)
    del dz, dh, dw
    leaves = [x.detach().requires_grad_() for x in (h_s, w_s)]
    kl_lib = library(*leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(kl_lib, leaves,
                                                     retain_graph=True),
                         iters=3, warmup=1)
    del kl_lib, leaves
    flops = 2 * N * V * (Ds + Dt) + 4 * N * V * Ds
    nbytes = 2 * (N * Ds + Ds * V + N * Dt + Dt * V) + 5 * 4 * N \
        + 2 * (N * Ds + Ds * V)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"distill_kl backward N={N} D={Ds} V={V} {str(h_s.dtype)[6:]} "
          f"embed.T T={T}, the student side: kernel and products "
          f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s counted; dz kernels "
          f"{dz_ms:.3f} ms, products "
          f"{products_ms:.3f} ms, {len(chunks)} chunks of {vc} columns, "
          f"buffer {N * vc * h_s.element_size() / 2**20:.0f} MiB), plain "
          f"{plain_ms:.3f} ms, autograd through the materialised form "
          f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)")
    return {**out, "ms": ms, "dz_ms": dz_ms, "products_ms": products_ms,
            "chunk_cols": vc,
            "chunk_buffer_bytes": N * vc * h_s.element_size(),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kl_entry(at: dict) -> dict:
    """The KL kernel's line: the distillation step's numbers at the top,
    each main-path shape's under ``at``, the worst error of all."""
    at = {name: {k: v for k, v in a.items() if k != "bwd"}
          for name, a in at.items()}
    return {"name": "distill_kl_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/distill_kl_fwd.cu",
            "replaces": "src/repro/kernels/distill_kl_pallas.py:34",
            "launches": None,
            **{k: v for k, v in at["train_distill"].items() if k != "N"},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def kl_bwd_entry(at: dict) -> dict:
    """The KL backward's line: the distillation step's shape's numbers at
    the top, each main-path shape's under ``at``, the worst error."""
    at = {name: {"N": a["N"], **a["bwd"]} for name, a in at.items()}
    top = at["train_distill"]
    return {"name": "distill_kl_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/distill_kl_bwd.cu",
            "replaces": "src/repro/kernels/distill_kl.py:98",
            "launches": None,
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def _finite(xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def _changed_leaves(new, old) -> dict:
    changed = {}

    def visit(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                visit(a[k], b[k], f"{path}/{k}")
        else:
            changed[path] = bool((a.detach() != b).any())
    visit(new, old)
    return changed


def phase_train() -> int:
    """The training entry point at full width; returns flash launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_mod.run(TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_B,
                        seq=TRAIN_S, dtype="bfloat16", device="cuda",
                        seed=0, log_every=1)
    launches, kl_launches, ssd_launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(run.summary())
    print(f"train peak device memory {peak:.2f} GiB; loop {run.seconds:.2f} s")
    res, cfg = run.result, run.cfg
    check(_finite(res.losses) and _finite(res.grad_norms),
          f"non-finite loss or grad norm: {res.losses}, {res.grad_norms}")
    # remat: each layer's forward runs once, and again in the backward
    want = TRAIN_STEPS * cfg.num_layers * 2
    check(launches == run.flash_launches == want,
          f"flash launched {launches} times in training, expected "
          f"steps x layers x 2 = {want}")
    check(kl_launches == ssd_launches == 0,
          "training qwen launched the distill_kl or the SSD kernel")
    bwd = note_bwd("train")
    check(bwd == TRAIN_STEPS * cfg.num_layers, f"flash_bwd launched {bwd} "
          f"times in training, expected steps x layers = "
          f"{TRAIN_STEPS * cfg.num_layers}")
    names = ("embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    changed = _changed_leaves(res.params,
                              build_model(cfg, device="cuda", seed=0)
                              .param_tree())
    print(f"train: {sum(changed.values())} of {len(changed)} parameter "
          f"leaves changed")
    for path, moved in changed.items():
        if path.rsplit("/", 1)[-1] in names:
            check(moved, f"parameter {path} did not change in training")
    return launches


def lm_train_setup(arch: str = TRAIN_ARCH, B: int = TRAIN_B,
                   S: int = TRAIN_S):
    """(cfg, model, step, batches): a main path's LM training at batch
    B x S in one microbatch, bf16, lr 1e-4, through
    ``train.step.build_train_step`` fed by ``lm_batches(seed=0)`` on the
    card."""
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import schedules
    from repro_torch.train import step as step_mod
    cfg = resolve_config(arch, dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    step = step_mod.build_train_step(
        model, ParallelConfig(mbs=B), ShapeConfig("train", "train", S, B),
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    batches = lm_batches(batch=B, seq_len=S, vocab=cfg.vocab_size, seed=0,
                         device="cuda")
    return cfg, model, step, batches


def phase_train_trace(arch: str = TRAIN_ARCH, B: int = TRAIN_B,
                      S: int = TRAIN_S) -> None:
    """One warm train step of a main path's model and shapes, traced."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim import adamw
    cfg, model, step, batches = lm_train_setup(arch, B, S)
    params = model.param_tree()
    opt = adamw.init(params)
    params, opt, met = step(params, opt, next(batches), 0)     # warm-up
    float(met["loss"])
    batch = next(batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch, 1)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm train step ({cfg.name})")


def _kernel_report(prof, wall_ms: float, what: str) -> None:
    """Device busy against wall time, time by part, and the top kernels."""
    busy, per = _device_ms(prof)
    check(busy > 0, f"the profiler saw no device time in {what}")
    ranges = _range_ms(prof, (
        ("flash backward (its kernels)",
         "evaluate_function: FlashAttentionBackward"),
        ("KL backward (its kernel and products)",
         "evaluate_function: DistillKLBackward"),
        ("SSD backward (its kernels)", "evaluate_function: SSDScanBackward"),
        ("AdamW update", "adamw.update")))
    kinds = {"flash forward kernel": lambda k: "flash_fwd_kernel" in k,
             "flash backward kernels": lambda k: "flash_bwd_" in k,
             "distill_kl kernels": lambda k: "distill_kl_" in k,
             "SSD forward kernels": lambda k: ("ssd_" in k
                                               and "ssd_bwd" not in k),
             "SSD backward kernels": lambda k: "ssd_bwd" in k,
             "GEMMs": lambda k: any(x in k.lower() for x in
                                    ("gemm", "xmma", "cutlass", "nvjet"))}
    print(f"traced {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%, idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {len(per)} kernel kinds")
    for label, pick in kinds.items():
        ms = sum(v for k, v in per.items() if pick(k))
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {label}")
    for label, ms in ranges.items():
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {label} "
              f"(device time under its range)")
    for key, ms in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
    # host side: the CUDA runtime calls, where a synchronising call (a
    # free, a copy from pageable memory) drains the queue the host built
    runtime = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cuda")):
            n, us = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in sorted(runtime.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"  host {us / 1e3:8.2f} ms in {n:6d} x {name}")


def phase_distill() -> tuple[int, int]:
    """Colocated self-distillation at full width; returns (flash, KL)
    launches of the 3 main-path steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    torch.cuda.reset_peak_memory_stats()
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    teacher = tree_map(lambda p: p.detach(),
                       build_model(cfg, device="cuda", seed=1).param_tree())
    params = build_model(cfg, device="cuda", seed=0).param_tree()
    step = dw.build_colocated_step(
        cfg, cfg, ShapeConfig("distill", "train", TRAIN_S, TRAIN_B),
        ParallelConfig(mbs=TRAIN_B), alpha=0.5, temperature=2.0,
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    opt = adamw.init(params)
    batches = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S,
                         vocab=cfg.vocab_size, seed=0, device="cuda")
    toks = TRAIN_B * TRAIN_S
    times, mets = [], []
    reset_counts()
    for i in range(DISTILL_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, teacher, batch, i)
        met = {k: float(v) for k, v in met.items()}
        times.append(time.perf_counter() - t0)
        mets.append(met)
        print(f"distill step {i}: loss {met['loss']:.4f} ce {met['ce']:.4f} "
              f"kl {met['kl']:.5f} gnorm {met['grad_norm']:.3f} "
              f"{times[-1] * 1e3:.1f} ms")
    launches, kl_launches, ssd_launches = read_counts()
    check(ssd_launches == 0, "distillation launched the SSD kernel")
    note_bwd("distill")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = float(np.mean(times[1:]))
    print(f"distill {cfg.name} teacher seed 1 -> student seed 0, batch "
          f"{TRAIN_B} x seq {TRAIN_S} bf16: cold {times[0] * 1e3:.1f} ms, "
          f"warm {warm * 1e3:.1f} ms/step ({toks / warm:.0f} tok/s); peak "
          f"device memory {peak:.2f} GiB")
    check(kl_launches == DISTILL_STEPS,
          f"distill_kl launched {kl_launches} times in {DISTILL_STEPS} steps")
    # teacher forward once per layer; student forward plus its recompute
    want = DISTILL_STEPS * cfg.num_layers * 3
    check(launches == want, f"flash launched {launches} times in "
          f"distillation, expected steps x layers x (1 + 2) = {want}")
    for met in mets:
        check(_finite([met["loss"], met["ce"], met["kl"],
                       met["grad_norm"]]), f"non-finite metrics {met}")
        check(met["kl"] >= -1e-4, f"negative KL {met['kl']}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = next(batches)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, teacher, batch, DISTILL_STEPS)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, "warm distill step")
    return launches, kl_launches


def grad_rel_err(g_card, g_cpu) -> float:
    """Worst per-leaf max |g_card - g_cpu| / max |g_cpu| of two gradient
    lists, the card's copied to the host."""
    return max(((a.cpu() - b).abs().max()
                / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(g_card, g_cpu))


def phase_grad_consistency(rng) -> None:
    """One distillation step's gradients at full width on the kernels
    against the same step on CPU copies (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.distill import workload as dw
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    # every leaf in float32: norm scales are bf16 by spec (as in the JAX
    # package), and a bf16 gradient would round by up to 2**-8 of itself
    gpu_t, gpu_s = (tree_map(lambda p: p.detach().float(),
                             build_model(cfg, device="cuda", seed=seed)
                             .param_tree()) for seed in (1, 0))
    B, S = 2, 64
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(
                 (rng.random((B, S)) < 0.9).astype(np.float32))}

    def grads(device):
        ps = tree_map(lambda p: p.detach().to(device).requires_grad_(),
                      gpu_s)
        pt = tree_map(lambda p: p.to(device), gpu_t)
        b = {k: v.to(device) for k, v in batch.items()}
        h_t = dw.teacher_hidden(pt, cfg, b["tokens"])
        loss, met = dw.distill_loss(ps, cfg, b, h_t,
                                    dw.teacher_unembedding(pt, cfg),
                                    alpha=0.5, temperature=2.0)
        return loss, met, torch.autograd.grad(loss, tree_leaves(ps))

    reset_counts()
    loss_g, met_g, g_gpu = grads("cuda")
    launches = read_counts()
    check(launches == (cfg.num_layers * 3, 1, 0),
          f"the CUDA step launched (flash, KL, SSD) = {launches}")
    loss_c, met_c, g_cpu = grads("cpu")
    check(read_counts() == launches, "the CPU step launched a kernel")
    rel = grad_rel_err(g_gpu, g_cpu)
    # float32 with TF32 off on both; sums in other orders over d_model 1024
    # and V = 151936: 1e-3 relative per leaf is far above that and far
    # below a wrong term of the KL backward or of attention's
    tol = 1e-3
    print(f"gradient consistency {cfg.name} 2 layers f32 B={B} S={S}: "
          f"loss {loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU), "
          f"kl {met_g['kl'].item():.6f} vs {met_c['kl'].item():.6f}; "
          f"max per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
          f"{len(g_cpu)} leaves")
    check(abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()),
          "distillation loss differs between the card and the CPU")
    check(rel <= tol, "distillation gradients differ between the card and "
          "the CPU")


# --------------------------------------------------------------------------- #
# Checkpoint and resume
# --------------------------------------------------------------------------- #
CKPT_STEPS, CKPT_STOP = 4, 2     # (b) stops after step 2 and resumes there


def _state_diff(a, b) -> list:
    """The leaf paths at which two {"params", "opt"} trees differ, compared
    bit for bit on the card."""
    from repro_torch.models.common import flatten_with_path
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    check([p for p, _ in fa] == [p for p, _ in fb], "state trees differ in "
          "structure")
    return [p for (p, x), (_, y) in zip(fa, fb)
            if not torch.equal(x.detach(), y.detach())]


def _lm_stream(vocab: int, start: int, stop_after: int = 0):
    """``lm_batches(seed=0)`` from batch ``start`` on.  With ``stop_after``
    the process receives SIGTERM as batch ``stop_after - 1`` is handed
    out, as a preempted job would: the training loop finishes that step,
    saves and stops."""
    import signal
    from repro_torch.data.synthetic import lm_batches
    gen = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S, vocab=vocab, seed=0,
                     device="cuda")
    for i, b in enumerate(gen):
        if i < start:
            continue
        if stop_after and i == stop_after - 1:
            signal.raise_signal(signal.SIGTERM)
        yield b


def phase_checkpoint() -> int:
    """qwen1.5-0.5b at full width through ``launch.train.run``, (a) 4
    steps uninterrupted against (b) 2 steps checkpointing asynchronously
    every 2 steps, stopped by SIGTERM, then a freshly built model and
    optimizer state that resume from that directory and run steps 2-3 on
    the batches from index 2 on (saving every step, so step 3 runs with a
    save in flight).  Both under deterministic algorithms: the losses of
    steps 2-3 and the final parameters, master, mu, nu and step must be
    equal bit for bit.  The step-2 checkpoint must restore bit for bit,
    and fail that comparison with one leaf moved by one ulp; a manifest
    missing a leaf must raise KeyError.  Returns (b)'s flash launches."""
    import os
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import flatten_with_path
    ckdir = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.parent.mkdir(exist_ok=True)
    disk = shutil.disk_usage(ckdir.parent)
    print(f"checkpoint: {ckdir}, {disk.free / 1e9:.1f} GB free of "
          f"{disk.total / 1e9:.1f} GB")
    # bitwise equality of two card runs: the embedding backward
    # accumulates with atomics unless deterministic algorithms are on,
    # which cuBLAS allows only with a fixed workspace configuration
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    common = dict(steps=CKPT_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                  dtype="bfloat16", device="cuda", seed=0, log_every=1)
    try:
        reset_counts()
        a = train_mod.run(TRAIN_ARCH, **common)
        launches_a = read_counts()
        vocab, L = a.cfg.vocab_size, a.cfg.num_layers
        reset_counts()
        b1 = train_mod.run(TRAIN_ARCH, ckpt_dir=str(ckdir), ckpt_every=2,
                           batches=_lm_stream(vocab, 0, CKPT_STOP), **common)
        ck1 = b1.checkpointer
        check(b1.result.final_step == CKPT_STOP
              and ck1.all_steps() == [CKPT_STOP],
              f"the SIGTERM'd run stopped at {b1.result.final_step} with "
              f"checkpoints {ck1.all_steps()}")
        state_b1 = {"params": b1.result.params, "opt": b1.result.opt_state}
        del b1
        b2 = train_mod.run(TRAIN_ARCH, ckpt_dir=str(ckdir), ckpt_every=1,
                           batches=_lm_stream(vocab, CKPT_STOP), **common)
        launches_b = read_counts()
        note_bwd("resume")
        ck2 = b2.checkpointer
        resume_s = ck2.last_restore_s
        ra, rb = a.result, b2.result
        check(rb.resumed_from == CKPT_STOP and rb.steps_run == 2
              and rb.final_step == CKPT_STEPS,
              f"resumed from {rb.resumed_from}, ran {rb.steps_run} steps")
        want = CKPT_STEPS * L * 2
        for what, n in (("(a)", launches_a), ("(b)", launches_b)):
            check(n == (want, 0, 0), f"{what} launched (flash, KL, SSD) "
                  f"= {n}, expected ({want}, 0, 0)")
        print(f"checkpoint: losses of steps 2-3 uninterrupted "
              f"{ra.losses[2:]}, resumed {rb.losses}")
        check(rb.losses == ra.losses[CKPT_STOP:], "the resumed run's "
              "losses differ from the uninterrupted run's")
        final_a = {"params": ra.params, "opt": ra.opt_state}
        final_b = {"params": rb.params, "opt": rb.opt_state}
        diff = _state_diff(final_a, final_b)
        n_leaves = len(flatten_with_path(final_a))
        print(f"checkpoint: final state, {n_leaves} leaves (params, master, "
              f"mu, nu, step): {len(diff)} differ bit for bit {diff[:4]}")
        check(not diff, f"the resumed run ends in another state: {diff[:8]}")
        # the checkpoint itself: step 2 restores bit for bit, and the
        # comparison sees one ulp of one leaf
        restored = ck2.restore(CKPT_STOP, state_b1)
        torch.cuda.synchronize()
        again_s = ck2.last_restore_s
        check(not _state_diff(restored, state_b1), "the step-2 checkpoint "
              "does not restore bit for bit")
        leaf = restored["opt"].master["embed"].view(-1)
        leaf[0] = torch.nextafter(leaf[0], torch.tensor(np.inf,
                                                        device="cuda"))
        planted = _state_diff(restored, state_b1)
        print(f"checkpoint: a restored leaf moved by one ulp differs at "
              f"{planted}")
        check(planted == ["opt.master.embed"], "one ulp of a restored leaf "
              "passed the comparison")
        manifest = ckdir / f"step_{CKPT_STOP:08d}" / "manifest.json"
        m = json.loads(manifest.read_text())
        m["leaves"] = [x for x in m["leaves"] if x["path"] != "opt.step"]
        manifest.write_text(json.dumps(m))
        try:
            ck2.restore(CKPT_STOP, state_b1)
            missing = None
        except KeyError as e:
            missing = str(e)
        print(f"checkpoint: a manifest without opt.step raises {missing}")
        check(missing is not None and "opt.step" in missing,
              "a manifest missing a leaf restored")
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(ckdir, ignore_errors=True)
    card_ = card()
    print(f"checkpoint {TRAIN_ARCH} on {card_}: {ck1.last_bytes / 1e9:.3f} GB "
          f"a checkpoint ({n_leaves} leaves); save: device-to-host copy "
          f"{ck1.last_copy_s:.3f} s (the step waits for it), write "
          f"{ck1.last_write_s:.3f} s (a thread); restore in the resume "
          f"{resume_s:.3f} s, again {again_s:.3f} s")
    print(f"checkpoint: step time uninterrupted {ra.step_times[2] * 1e3:.1f}, "
          f"{ra.step_times[3] * 1e3:.1f} ms; resumed step 2 (no save in "
          f"flight) {rb.step_times[0] * 1e3:.1f} ms, step 3 (the save of "
          f"step 3 in flight) {rb.step_times[1] * 1e3:.1f} ms; last saves "
          f"copy {ck2.last_copy_s:.3f} s, write {ck2.last_write_s:.3f} s")
    return launches_b[0]


# --------------------------------------------------------------------------- #
# Data parallelism (FSDP and ZeRO sharding, compressed gradient all-reduce)
# at world size 1 on NCCL
# --------------------------------------------------------------------------- #
DP_STEPS, DP_MBS = 3, 2
# tests/drivers/driver_compression.py:158: the relative deviation of a
# compressed trajectory's losses from the exact one's
DP_COMPRESS_TOL = {"bf16": 1e-3, "int8": 5e-2}


@contextlib.contextmanager
def scaled_first_grad(step_mod, factor: float):
    """The sharded step's first gradient leaf (the parameter tree's first,
    qwen's ``embed``) scaled by ``factor`` once reduced: a planted fault
    that the bitwise comparison with the plain step must see."""
    reduce_grads = step_mod.reduce_grads

    def planted(grads, *args, **kw):
        out = reduce_grads(grads, *args, **kw)
        out[0] = out[0] * factor
        return out

    step_mod.reduce_grads = planted
    try:
        yield
    finally:
        step_mod.reduce_grads = reduce_grads


def _compressed_steps(method: str, mesh, trace: bool):
    """``DP_STEPS`` steps of the compressed sharded step (qwen1.5-0.5b, the
    training cell's batches), and with ``trace`` one more, traced -> (losses,
    warm step ms, wire bytes of the ``DP_STEPS`` steps, payload in float32
    of one step, the residual's max, the trace and its wall ms or None)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.optim import compression as gcomp
    from repro_torch.train import step as step_mod
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    par = ParallelConfig(dp=1, mbs=DP_MBS, grad_compress=method)
    # launch.train.run's schedule for DP_STEPS steps at its default lr
    step = step_mod.build_train_step(
        model, par, ShapeConfig("train", "train", TRAIN_S, TRAIN_B),
        mesh=mesh, lr_schedule=functools.partial(
            schedules.warmup_cosine, peak_lr=3e-3,
            warmup_steps=max(DP_STEPS // 10, 1), total_steps=DP_STEPS))
    sh = step.shardings
    full = model.param_tree()
    payload = gcomp.wire_bytes(full, "none")
    opt = adamw.init(shd.shard_tree(full, sh["opt"].master, mesh))
    params = shd.shard_tree(full, sh["params"], mesh)
    del full
    ef = sh["ef_init"](params)
    batches = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S,
                         vocab=cfg.vocab_size, seed=0, device="cuda")
    gcomp.reset_wire_counts()
    losses, times = [], []
    for i in range(DP_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt, met, ef = step(params, opt, step.block(batch), i, ef)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
    wire = gcomp.wire_counts()
    res = max(float(x.abs().max()) for x in tree_leaves(ef))
    prof = wall = None
    if trace:
        batch = next(batches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, met, ef = step(params, opt, step.block(batch),
                                        DP_STEPS, ef)
            float(met["loss"])
            wall = (time.perf_counter() - t0) * 1e3
    return (losses, 1e3 * statistics.mean(times[1:]), wire, payload, res,
            prof, wall)


def phase_dp() -> int:
    """The data-parallel path at qwen1.5-0.5b's full width and depth on a
    one-rank NCCL process group (this process, ``cuda:0``), under
    deterministic algorithms: (1) ``launch.train.run(..., mesh=)`` on
    ``section_mesh([0], ParallelConfig(dp=1, mbs=2, zero_opt=True))``
    against the single-device ``run``, 3 steps each, losses and every leaf
    of params, master, mu, nu and step equal bit for bit, flash launched
    as often; (2) the same with the first gradient leaf scaled by 0.99,
    which must differ; (3) ``grad_compress`` bf16 and int8, 3 steps each,
    losses within the reference driver's tolerances of the uncompressed
    ones, a non-zero int8 residual, the wire counters at 1/2 and 1/4 of
    the float32 payload, and a traced fourth int8 step with the device time
    under the quantize and dequantize ranges; (4) the sharded state saved
    through the collective save and restored with ``shardings=`` on the
    same mesh and with none, bit for bit.  The process group is destroyed
    at the end.  Returns the sharded run's flash launches."""
    import os
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.types import ParallelConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as train_mod
    from repro_torch.train import step as step_mod
    ckdir = ROOT / "build" / "dp_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    common = dict(steps=DP_STEPS, batch=TRAIN_B, seq=TRAIN_S, mbs=DP_MBS,
                  dtype="bfloat16", device="cuda", seed=0, log_every=1)
    parts = {}                # wall seconds of each part of the phase
    t = time.perf_counter()
    try:
        mesh = shd.section_mesh([0], ParallelConfig(dp=1, mbs=DP_MBS,
                                                    zero_opt=True))
        print(f"dp: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {shd.mesh_shape(mesh)}")
        reset_counts()
        plain = train_mod.run(TRAIN_ARCH, **common)
        launches_plain = read_counts()
        parts["plain run"], t = time.perf_counter() - t, time.perf_counter()
        reset_counts()
        sharded = train_mod.run(TRAIN_ARCH, mesh=mesh, **common)
        launches = read_counts()
        bwd = note_bwd("dp")
        parts["sharded run"], t = time.perf_counter() - t, time.perf_counter()
        rp, rs = plain.result, sharded.result
        L = plain.cfg.num_layers
        want = DP_STEPS * L * 2 * (TRAIN_B // DP_MBS)
        check(launches == launches_plain == (want, 0, 0),
              f"(flash, KL, SSD) launched {launches} sharded and "
              f"{launches_plain} plain, expected ({want}, 0, 0)")
        check(bwd == want // 2, f"flash_bwd launched {bwd} times sharded, "
              f"expected {want // 2}")
        print(f"dp: losses plain {rp.losses}, sharded {rs.losses}")
        check(rs.losses == rp.losses, "the sharded step's losses differ "
              "from the single-device step's")
        state_p = {"params": rp.params, "opt": rp.opt_state}
        state_s = {"params": rs.params, "opt": rs.opt_state}
        diff = _state_diff(state_s, state_p)
        print(f"dp: final state (params, master, mu, nu, step): "
              f"{len(diff)} leaves differ bit for bit {diff[:4]}")
        check(not diff, f"the sharded run ends in another state: {diff[:8]}")
        with scaled_first_grad(step_mod, 0.99):
            planted = train_mod.run(TRAIN_ARCH, mesh=mesh, **common)
        pdiff = _state_diff({"params": planted.result.params,
                             "opt": planted.result.opt_state}, state_p)
        print(f"dp: with the first gradient leaf x 0.99, {len(pdiff)} leaves "
              f"differ {pdiff[:4]}; losses {planted.result.losses}")
        check(len(pdiff) > 0, "a gradient scaled by 0.99 passed the bitwise "
              "comparison")
        del planted
        parts["planted run"], t = time.perf_counter() - t, time.perf_counter()
        comp = {}
        for method in ("bf16", "int8"):
            free()
            comp[method] = _compressed_steps(method, mesh,
                                             trace=method == "int8")
            losses, _, wire, payload, res, _, _ = comp[method]
            dev = max(abs(a - b) / max(abs(b), 1e-8)
                      for a, b in zip(losses, rs.losses))
            print(f"dp: {method} losses {losses}, max relative deviation "
                  f"from the uncompressed {dev:.3e} (limit "
                  f"{DP_COMPRESS_TOL[method]}); wire {wire}; float32 payload "
                  f"{payload} a step; residual max {res:.3e}")
            check(dev < DP_COMPRESS_TOL[method], f"{method}: the compressed "
                  f"losses deviate by {dev:.3e}")
            key, per = {"bf16": ("bf16.bfloat16", 2),
                        "int8": ("int8.int8", 4)}[method]
            check(wire[key] * per == DP_STEPS * payload,
                  f"{method}: {wire[key]} bytes on the wire for "
                  f"{DP_STEPS} x {payload} float32 bytes")
            check(method == "bf16" or res > 0, "the int8 residual is zero")
            parts[f"{method} run"], t = (time.perf_counter() - t,
                                         time.perf_counter())
        # the elastic restore: save collectively, restore on the same mesh
        # and on no mesh
        ck = Checkpointer(ckdir, async_save=False)
        shardings = sharded.shardings
        ck.save(DP_STEPS, state_s, shardings=shardings, mesh=mesh)
        save_s = ck.last_copy_s + ck.last_write_s
        parts["save"], t = time.perf_counter() - t, time.perf_counter()
        for what, kw in (("the same mesh", dict(shardings=shardings,
                                                mesh=mesh)),
                         ("no mesh", {})):
            restored = ck.restore(DP_STEPS, state_s, **kw)
            torch.cuda.synchronize()
            rdiff = _state_diff(restored, state_s)
            print(f"dp: restored on {what} in {ck.last_restore_s:.3f} s, "
                  f"{len(rdiff)} leaves differ")
            check(not rdiff, f"the restore on {what} differs: {rdiff[:4]}")
            del restored
            parts[f"restore on {what}"], t = (time.perf_counter() - t,
                                             time.perf_counter())
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(ckdir, ignore_errors=True)
    card_ = card()
    warm = {"plain": 1e3 * statistics.mean(rp.step_times[1:]),
            "sharded": 1e3 * statistics.mean(rs.step_times[1:]),
            **{m: comp[m][1] for m in comp}}
    print(f"dp {TRAIN_ARCH} on {card_}: warm step ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in warm.items())
          + f"; flash launches {launches[0]} a run of {DP_STEPS} steps; "
          f"collective save {save_s:.3f} s")
    print("dp: wall s of each part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    prof, wall = comp["int8"][5:]
    _kernel_report(prof, wall, "warm int8-compressed sharded train step")
    ranges = _range_ms(prof, (("quantize", "compression.quantize"),
                              ("dequantize", "compression.dequantize")))
    print(f"dp: traced int8 step on {card_}: device time under "
          f"compression.quantize {ranges.get('quantize', 0.0):.2f} ms, under "
          f"compression.dequantize {ranges.get('dequantize', 0.0):.2f} ms")
    return launches[0]


# --------------------------------------------------------------------------- #
# The section-centric compound runtime: sections sharing the card
# --------------------------------------------------------------------------- #
RT_ITERS = 3
# multi-teacher distillation: batch 8 x 2048 in microbatches of 2
MT_B, MT_MBS, MT_ITERS, MT_RATIO = 8, 2, 3, 0.3
MT_ATTN = (MT_MBS, TRAIN_S, TRAIN_S, 16, 16, 64)   # a microbatch's attention
# the runtime against the colocated step (and the streamed runtime against
# the serialized one), in bf16 at full width: both run the same bf16
# arithmetic and differ only in the order of float sums (cuBLAS on other
# streams, atomics in the embedding backward, the joint grad-norm summed on
# the host against the device), which moves a bf16-rounded activation by
# at most one bf16 step, and moves the losses, f32 means over 8192 tokens
# of values made from those activations, by far less: one bf16 step of the
# value itself (2**-8 relative, 2**-8 absolute below 1) bounds them, where
# a wrong hidden state, parameter or step moves them by far more
RT_TOL = 2.0 ** -8
# the student's f32 master weights after RT_ITERS iterations, compared as
# updates from the common start, per leaf: |new - ref| / |ref - start| (L2
# norms).  AdamW's first steps are close to lr * sign(g); where two
# gradients agree to rounding, the updates agree to ~RT_TOL relative, and
# only elements whose gradient lies within rounding of zero can flip sign,
# each by at most 2 lr a step, giving about 2 sqrt(f) for a share f of such
# elements.  A skipped or lost update of a leaf reads 1, and the update of
# a different gradient about sqrt(2); 1/4 admits flips on up to 1/64 of a
# leaf's elements and fails both.  The attention key bias is left out: its
# gradient is zero in exact arithmetic (a row's scores all shift by q.bk,
# which the softmax ignores), so its update follows the rounding alone
UPD_TOL = 0.25
NOISE_LEAVES = ("bk",)


def _rt_close(a: float, b: float) -> bool:
    return abs(a - b) <= RT_TOL * max(1.0, abs(b))


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _update_gap(new, ref, start) -> tuple[float, str, float, float]:
    """The worst leaf's |new - ref| / |ref - start| over f32 weight trees,
    its name, the largest |new - ref| of any element, and the worst gap of
    the NOISE_LEAVES, which the first leaves out.  Each leaf is compared
    on the card, one at a time (the trees may lie in host memory)."""
    worst, name, most, noise = 0.0, "", 0.0, 0.0
    for (path, n), (_, r), (_, s0) in zip(_named_leaves(new),
                                          _named_leaves(ref),
                                          _named_leaves(start)):
        n, r, s0 = (x.to("cuda", non_blocking=True) for x in (n, r, s0))
        step = (r - s0.float()).norm().item()
        gap = (n - r).norm().item() / max(step, 1e-30)
        most = max(most, (n - r).abs().max().item())
        if path.rsplit("/", 1)[-1] in NOISE_LEAVES:
            noise = max(noise, gap)
        elif gap > worst:
            worst, name = gap, path
    return worst, name, most, noise


def _intervals_ms(spans) -> float:
    """Total length of the union of (start, end) spans, in ms."""
    total, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def _stream_report(prof, wall_ms: float, what: str, roles) -> None:
    """Device busy and each stream's kernel time in a trace, and the time
    during which streams of two different roles both ran kernels.
    ``roles`` names the streams: it maps each stream's kernel counts,
    {stream: {kernel name: count}}, to {stream: role} for the streams it
    knows, and fails the run if they are not what it expects."""
    spans, kernels = {}, {}
    for e in prof.events():
        if not _kernel_event(e):
            continue
        sid = e.device_resource_id
        spans.setdefault(sid, []).append((e.time_range.start,
                                          e.time_range.end))
        counts = kernels.setdefault(sid, {})
        counts[e.name] = counts.get(e.name, 0) + 1
    check(bool(spans), f"the profiler saw no device time in {what}")
    busy = _intervals_ms([x for v in spans.values() for x in v])
    role = roles(kernels)
    per = {s: _intervals_ms(v) for s, v in spans.items()}
    print(f"traced {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%, idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {len(spans)} streams")
    for sid, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"  stream {sid} ({role.get(sid, 'other')}): kernels "
              f"{ms:.1f} ms")
    named = sorted(role)
    for i, a in enumerate(named):
        for b in named[i + 1:]:
            if role[a] == role[b]:
                continue
            both = per[a] + per[b] - _intervals_ms(spans[a] + spans[b])
            print(f"  {role[a]} stream {a} and {role[b]} stream {b} both ran "
                  f"kernels for {both:.1f} ms ({100 * both / busy:.1f}% of "
                  "device busy)")


def _distill_roles(kernels) -> dict:
    """The student's stream is the one that runs distill_kl; the teachers'
    run flash_fwd without it."""
    def runs(sid, name):
        return any(name in k for k in kernels[sid])
    student = [s for s in kernels if runs(s, "distill_kl")]
    teachers = [s for s in kernels
                if s not in student and runs(s, "flash_fwd")]
    check(len(student) == 1 and teachers, "expected one student stream and "
          f"teacher streams, got {kernels}")
    return {**{s: "teacher" for s in teachers}, student[0]: "student"}


def _flash_count_roles(want: dict):
    """Name each section's stream by its count of flash kernels (``want``:
    section -> the launches the plan implies, which must match)."""
    def roles(kernels) -> dict:
        flash = {s: sum(c for k, c in n.items() if "flash_fwd" in k)
                 for s, n in kernels.items()}
        by_count = {c: s for s, c in flash.items() if c}
        check(sum(map(bool, flash.values())) == len(want)
              and set(by_count) == set(want.values()),
              f"flash kernels per stream {flash}, expected {want}")
        return {by_count[n]: name for name, n in want.items()}
    return roles


def _section_report(ex, q) -> None:
    for name in sorted(ex.dispatch_order):
        print(f"  section {name}: {ex.task_counts[name]} tasks, busy "
              f"{ex.busy(name) * 1e3:.1f} ms, utilization "
              f"{ex.utilization(name):.3f} of its span; iteration makespan "
              f"{ex.makespan * 1e3:.1f} ms")
    st = q.stats()
    print(f"  queue: {st['pushes']} pushes, {st['bytes_pushed'] / 1e6:.1f} "
          f"MB pushed, edges {st['edges']}")


def _worker_streams(rt) -> dict:
    """The current stream each section's worker thread sees."""
    from repro_torch.core.executor import Dispatch
    res = rt.executor.run([Dispatch(n, "probe", lambda: torch.cuda
                                    .current_stream().cuda_stream)
                           for n in rt.rt.workers])
    return {n: v for (n, _), v in res.results.items()}


def _log_parentless(prof, n: int = 6) -> None:
    """ROADMAP.md C15's next step, when the affinity pass reports a traced
    iteration: the launch calls with no operator above them (the kind C15
    saw filed under the main thread), grouped by thread and stream, and
    for the first of each group the ``n`` events before and after it on
    its thread and the innermost events of other threads that hold its
    start."""
    from repro_torch.analysis import affinity
    events = list(prof.events())
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    calls = {e.id: e for e in cpu if affinity._LAUNCH.match(e.name)}
    groups: dict = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        call = calls.get(e.id)
        if call is not None and call.cpu_parent is None:
            groups.setdefault((call.thread, e.device_resource_id),
                              []).append((call, e))

    def line(e, mark=" "):
        parent = e.cpu_parent.name[:40] if e.cpu_parent else None
        return (f"   {mark} {e.time_range.start:.1f} us +"
                f"{e.time_range.elapsed_us():.1f} thread {e.thread} "
                f"{e.name[:60]} (parent {parent}, forward thread "
                f"{getattr(e, 'fwd_thread', 0)})")

    for (thread, sid), pairs in sorted(groups.items()):
        call, kernel = pairs[0]
        print(f"C15: {len(pairs)} launches with no operator above them, "
              f"thread {thread} -> stream {sid}; first {call.name} -> "
              f"{kernel.name[:60]}")
        mine = sorted((e for e in cpu if e.thread == thread),
                      key=lambda e: e.time_range.start)
        i = next(j for j, e in enumerate(mine) if e is call)
        for e in mine[max(0, i - n):i + n + 1]:
            print(line(e, ">" if e is call else " "))
        t = call.time_range.start
        held = [e for e in cpu if e.thread != thread
                and e.time_range.start <= t < e.time_range.end]
        for e in sorted(held, key=lambda e: e.time_range.elapsed_us())[:n]:
            print(line(e, "|"))


def _affinity_ok(rep, what: str) -> None:
    print(rep.render())
    check(rep.ok, f"affinity: {what}")


def _stream_fault(crt, prof_acts) -> None:
    """A teacher task that launches one kernel on its own stream and one
    on the student's: ``check_profile`` must report it."""
    from torch.profiler import profile
    from repro_torch.analysis import affinity
    from repro_torch.core.executor import Dispatch
    other = crt.rt.workers["student"].stream

    def rogue():
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(4):
            x.add_(1)
        with torch.cuda.stream(other):
            x.mul_(2)
        other.synchronize()

    crt.executor.run([Dispatch("teacher", "rogue", rogue)])      # warm
    a = torch.randn(2048, 2048, device="cuda")
    with profile(activities=prof_acts,
                 experimental_config=affinity.profile_config()) as prof:
        # the profiler's device tracing can start some milliseconds after
        # the window opens: the main thread's products fill that time
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.2:
            a @ a
            torch.cuda.synchronize()
        crt.executor.run([Dispatch("teacher", f"rogue{i}", rogue)
                          for i in range(3)])
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"affinity: the rogue tasks' trace holds {len(kernels)} device "
          f"events")
    rep = affinity.check_profile(prof, crt)
    print(f"affinity: a teacher task with a kernel on the student's stream:"
          f"\n{rep.render()}")
    check(any(f.check == "affinity.foreign-stream" and f.subject == "teacher"
              for f in rep.errors),
          "a kernel on another section's stream passed check_profile")


def phase_distill_runtime() -> tuple[int, int, dict]:
    """qwen1.5-0.5b self-distillation through the compound runtime, teacher
    and student sections sharing the card (each on its own worker thread
    and stream), against the colocated step: (a) the colocated step, (b)
    ``DistillRuntime.train_iteration`` (serialized), (c) the same spec on a
    ``CompoundRuntime`` with lookahead 1, streamed, its wiring and traced
    iterations held by the affinity pass.  Returns the (flash, KL)
    launches of (c), the streamed run ((b)'s are checked here), and the
    measured numbers the planner's calibration record prints."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import affinity
    from repro_torch.core import workload as wl
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    L = cfg.num_layers
    teacher = tree_map(lambda p: p.detach(),
                       build_model(cfg, device=dev, seed=1).param_tree())
    student0 = tree_map(lambda p: p.detach(),
                        build_model(cfg, device=dev, seed=0).param_tree())
    lr = functools.partial(schedules.constant, peak_lr=1e-4)
    gen = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S, vocab=cfg.vocab_size,
                     seed=0, device="cpu")
    batches = [next(gen) for _ in range(RT_ITERS + 2)]
    toks = TRAIN_B * TRAIN_S
    w_t = dw.teacher_unembedding(teacher, cfg)
    keys = ("loss", "ce", "kl", "grad_norm")
    runs = {}

    def record(mode, i, met, ms):
        runs.setdefault(mode, []).append((met, ms))
        print(f"distill-runtime ({mode}) iteration {i}: loss "
              f"{met['loss']:.4f} ce {met['ce']:.4f} kl {met['kl']:.5f} "
              f"gnorm {met['grad_norm']:.3f} {ms:.1f} ms")

    # (a) the colocated step
    step = dw.build_colocated_step(
        cfg, cfg, ShapeConfig("distill", "train", TRAIN_S, TRAIN_B),
        ParallelConfig(mbs=TRAIN_B), alpha=0.5, temperature=2.0,
        lr_schedule=lr)
    params = tree_map(lambda p: p.clone().requires_grad_(), student0)
    opt = adamw.init(params)
    for i, b in enumerate(batches[:RT_ITERS]):
        b = {k: v.to(dev) for k, v in b.items()}
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, teacher, b, i)
        met = {k: float(met[k]) for k in keys}
        record("a colocated", i, met, (time.perf_counter() - t0) * 1e3)
    masters_a = opt.master
    del params, opt, step
    gc.collect()

    # (b) DistillRuntime.train_iteration, serialized
    parallel = ParallelConfig()
    with dw.DistillRuntime(cfg, cfg, teacher_parallel=parallel,
                           student_parallel=parallel, devices=[dev, dev],
                           alpha=0.5, temperature=2.0, lr=1e-4) as drt:
        streams = _worker_streams(drt.runtime)
        main = torch.cuda.current_stream(dev).cuda_stream
        print(f"distill-runtime section streams {streams} (main thread's "
              f"{main})")
        check(len(set(streams.values())) == 2
              and main not in streams.values(),
              "the two sections must each run on a stream of their own")
        ps = tree_map(torch.clone, student0)
        opt = adamw.init(ps)
        reset_counts()
        for i, b in enumerate(batches[:RT_ITERS]):
            t0 = time.perf_counter()
            ps, opt, m = drt.train_iteration(teacher, ps, opt, b, i,
                                             w_t=w_t)
            met = {k: float(m[k]) for k in keys}
            record("b serialized", i, met, (time.perf_counter() - t0) * 1e3)
        counts_b = read_counts()
        moved = any(bool((a != c).any()) for a, c in
                    zip(tree_leaves(ps), tree_leaves(student0)))
        check(moved, "the runtime's student weights did not move")
        print("distill-runtime (b) sections of the last iteration:")
        _section_report(m["execution"], drt.rt.queue)
        calib = {"student_busy_ms": m["execution"].busy("student") * 1e3,
                 "teacher_busy_ms": m["execution"].busy("teacher") * 1e3}
        params_b, masters_b = ps, opt.master
        del opt
    gc.collect()

    # (c) CompoundRuntime(distill_spec, lookahead=1), streamed
    spec = dw.distill_spec(cfg, cfg, teacher_parallel=parallel,
                           student_parallel=parallel, alpha=0.5,
                           temperature=2.0)
    with wl.CompoundRuntime(spec, devices=[dev, dev], lr_schedule=lr,
                            lookahead=1) as crt:
        _affinity_ok(affinity.check_wiring(crt), "distill-runtime wiring")
        ps = tree_map(torch.clone, student0)
        crt.install({"teacher": teacher, "student": ps},
                    {"student": adamw.init(ps)})
        consts = {"student": {"w_t": w_t}}
        reset_counts()
        t_start = time.perf_counter()
        for i, b in enumerate(batches[:RT_ITERS]):
            crt.submit_iteration(b, i, consts=consts)
        ms = crt.drain()
        counts_c = read_counts()
        note_bwd("distill_runtime")
        ends = [m["execution"].t0 + max(e.end for e in
                                        m["execution"].timeline)
                for m in ms]
        prev = t_start
        for i, (m, end) in enumerate(zip(ms, ends)):
            met = {k: float(m[k]) for k in keys}
            record("c streamed", i, met, (end - prev) * 1e3)
            prev = end
        params_c = crt.state()[0]["student"]
        # AdamW writes its state in place: keep these before tracing more
        masters_c = tree_map(torch.clone, crt.state()[1]["student"].master)
        print("distill-runtime (c) sections of the last iteration:")
        _section_report(ms[-1]["execution"], crt.rt.queue)
        # two more warm streamed iterations, traced: the teacher's forward
        # of the second may run beside the student's work on the first
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts,
                     experimental_config=affinity.profile_config()) as prof:
            t0 = time.perf_counter()
            for i in (RT_ITERS, RT_ITERS + 1):
                crt.submit_iteration(batches[i], i, consts=consts)
            traced = crt.drain()
            check(all(np.isfinite(float(m["loss"])) for m in traced),
                  "non-finite loss in the traced iterations")
            wall = (time.perf_counter() - t0) * 1e3
        _kernel_report(prof, wall, "2 warm streamed distill-runtime "
                       "iterations")
        _stream_report(prof, wall, "2 warm streamed distill-runtime "
                       "iterations (streams)", _distill_roles)
        _affinity_ok(affinity.check_profile(prof, crt),
                     "kernels of the traced distill-runtime iterations")
        _stream_fault(crt, acts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    calib["peak_gib"] = peak

    want_flash, want_kl = RT_ITERS * L * 3, RT_ITERS
    for mode, counts in (("b", counts_b), ("c", counts_c)):
        # per iteration: the teacher's forward (L), the student's forward
        # and its remat recompute (2L); one KL per iteration (one microbatch)
        check(counts == (want_flash, want_kl, 0),
              f"({mode}) launched (flash, KL, SSD) = {counts}, expected "
              f"({want_flash}, {want_kl}, 0)")
    for i in range(RT_ITERS):
        (ma, _), (mb, _), (mc, _) = (runs[k][i] for k in sorted(runs))
        for k in keys:
            check(all(np.isfinite([ma[k], mb[k], mc[k]])),
                  f"non-finite {k} at iteration {i}")
        check(mb["kl"] >= -1e-4 and mc["kl"] >= -1e-4, "negative KL")
        for k in keys:
            check(_rt_close(mb[k], ma[k]), f"(b) {k} {mb[k]} vs colocated "
                  f"{ma[k]} at iteration {i} (tol {RT_TOL} relative)")
            check(_rt_close(mc[k], mb[k]), f"(c) {k} {mc[k]} vs (b) {mb[k]} "
                  f"at iteration {i} (tol {RT_TOL} relative)")
    for what, new, ref in (("(b) vs (a)", masters_b, masters_a),
                           ("(c) vs (b)", masters_c, masters_b)):
        gap, leaf, most, noise = _update_gap(new, ref, student0)
        print(f"distill-runtime {what}: student master weights after "
              f"{RT_ITERS} iterations, worst leaf {leaf} |new - ref| / "
              f"|ref - start| {gap:.3e} (tol {UPD_TOL}), max |new - ref| "
              f"{most:.3e}; key biases (not checked) {noise:.3e}")
        check(gap <= UPD_TOL, f"{what}: the student's updates differ at "
              f"{leaf}: {gap:.3e} > {UPD_TOL}")
    # printed, not checked: bitwise equality needs every reduction to sum
    # in the same order on both runs, which CUDA does not promise for
    # kernels queued from other threads and streams (atomics in the
    # embedding backward); the checks above are the contract
    bitwise = all(torch.equal(a, c) for a, c in
                  zip(tree_leaves(params_b), tree_leaves(params_c)))
    same_losses = all(runs["b serialized"][i][0] == runs["c streamed"][i][0]
                      for i in range(RT_ITERS))
    print(f"distill-runtime: (c) streamed vs (b) serialized bitwise equal: "
          f"metrics {same_losses}, student params {bitwise}")
    card_ = card()
    for mode, rows in sorted(runs.items()):
        times = [t for _, t in rows]
        warm = float(np.mean(times[1:]))
        print(f"distill-runtime {cfg.name} ({mode}), batch {TRAIN_B} x seq "
              f"{TRAIN_S} bf16 on {card_}: cold {times[0]:.1f} ms, warm "
              f"{warm:.1f} ms/iteration ({toks / warm * 1e3:.0f} tok/s)")
    print(f"distill-runtime peak device memory {peak:.2f} GiB")
    return counts_c[0], counts_c[1], calib


# --------------------------------------------------------------------------- #
# Compound sections on section meshes (ranks), at world size 1 on NCCL
# --------------------------------------------------------------------------- #
#: the torch.distributed calls the mesh path makes, counted by _nccl_calls
_DIST_CALLS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
               "all_to_all_single", "broadcast", "isend", "irecv", "send",
               "recv")


@contextlib.contextmanager
def _nccl_calls(counts: dict):
    """Count every ``torch.distributed`` collective and point-to-point call
    into ``counts`` while the block runs (the port calls them through the
    module, so replacing its attributes sees every call)."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in _DIST_CALLS}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(dist, n, counted(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


@contextlib.contextmanager
def _scaled_first_accumulated(factor: float):
    """Every section's first gradient leaf scaled by ``factor`` as the
    compound runtime accumulates it: a planted fault that the bitwise
    comparison of the two runtimes must see."""
    from repro_torch.core import workload as wl
    accumulate = wl._accumulate

    def planted(acc, grads):
        grads = list(grads)
        grads[0] = grads[0] * factor
        return accumulate(acc, grads)

    wl._accumulate = planted
    try:
        yield
    finally:
        wl._accumulate = accumulate


def _rebuilds_reserved(builds: int = 4) -> list[int]:
    """The card's reserved bytes after each of ``builds`` device-carved
    ``DistillRuntime``s (qwen1.5-0.5b reduced, float32, both sections on
    the card), each built, run one iteration, shut down and dropped, with
    the caches emptied after.  Dropped: a runtime still referenced keeps
    its installed state, whose blocks sit in one more or one fewer small
    segment as its streams' timing falls, and the count would read that
    placement rather than what a shut-down runtime leaves behind."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.types import ParallelConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    dev = torch.device("cuda", 0)
    cfg = get_reduced(TRAIN_ARCH).replace(dtype="float32")
    batch = next(lm_batches(batch=8, seq_len=64, vocab=cfg.vocab_size,
                            seed=0, device="cpu"))
    out = []
    for _ in range(builds):
        with dw.DistillRuntime(cfg, cfg, teacher_parallel=ParallelConfig(),
                               student_parallel=ParallelConfig(),
                               devices=[dev, dev]) as drt:
            pt, ps, opt = drt.init(0)
            drt.train_iteration(pt, ps, opt, batch, 0,
                                w_t=drt.teacher_unembed(pt))
            del pt, ps, opt
        del drt
        free()
        out.append(torch.cuda.memory_reserved(dev))
    return out


def phase_sections() -> tuple[int, int]:
    """qwen1.5-0.5b self-distillation through section meshes
    (``DistillRuntime(..., ranks=[0, 0])``: both sections on rank 0 of a
    one-rank NCCL group in this process, each with its own mesh, worker
    thread and stream) against the device-carved ``DistillRuntime(devices=
    [cuda:0] * 2)``, full width and depth, bf16, batch 4 x 2048, 3
    iterations, under deterministic algorithms: (1) losses, ce, kl, grad
    norms and every student leaf equal bit for bit, flash and KL launched
    as often; the gathers, reduce-scatters and all-reduces run on groups
    of one (nothing skips a collective for a group's size); (2) the first
    gradient leaf scaled by 0.99, which must differ; (3) ``grad_compress=
    "bf16"`` on the student, equal bit for bit to the exact run, the wire
    counters at exactly 1/2 of the float32 payload; (4) one traced
    iteration through the affinity pass (ROADMAP.md, C10); (5) runtimes
    built one after another hold the card's reserved memory flat, and
    without the runtime's cuBLAS workspace release they do not.  Returns
    the mesh run's (flash, KL) launches."""
    import os
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import affinity
    from repro_torch.core.types import ParallelConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import compression as gcomp
    t_phase = time.perf_counter()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    dev = torch.device("cuda", 0)
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    L = cfg.num_layers
    teacher = tree_map(lambda p: p.detach(),
                       build_model(cfg, device=dev, seed=1).param_tree())
    student0 = tree_map(lambda p: p.detach(),
                        build_model(cfg, device=dev, seed=0).param_tree())
    gen = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S, vocab=cfg.vocab_size,
                     seed=0, device="cpu")
    batches = [next(gen) for _ in range(RT_ITERS + 1)]
    keys = ("loss", "ce", "kl", "grad_norm")

    def run(compress="none", trace=False, **where):
        """RT_ITERS iterations -> (metrics, student leaves, warm ms,
        (flash, KL) launches, wire counts, collective calls an iteration,
        the traced iteration's profile and runtime)."""
        with dw.DistillRuntime(
                cfg, cfg, teacher_parallel=ParallelConfig(),
                student_parallel=ParallelConfig(grad_compress=compress),
                alpha=0.5, temperature=2.0, lr=1e-4, **where) as drt:
            params, opts = drt.runtime.place(
                {"teacher": teacher,
                 "student": tree_map(torch.clone, student0)})
            pt, ps, opt = params["teacher"], params["student"], \
                opts["student"]
            w_t = drt.teacher_unembed(teacher)
            mets, times, calls = [], [], {}
            reset_counts()
            gcomp.reset_wire_counts()
            with _nccl_calls(calls):
                for i, b in enumerate(batches[:RT_ITERS]):
                    t0 = time.perf_counter()
                    ps, opt, m = drt.train_iteration(pt, ps, opt, b, i,
                                                     w_t=w_t)
                    mets.append([m[k] for k in keys])
                    float(m["loss"])
                    times.append((time.perf_counter() - t0) * 1e3)
            counts, wire = read_counts(), gcomp.wire_counts()
            bwd = (read_bwd(), read_kl_bwd(), read_ssd_bwd())
            full = tree_leaves(drt.runtime.state()[0]["student"])
            prof = None
            if trace:
                acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
                with profile(activities=acts, experimental_config=affinity
                             .profile_config()) as prof:
                    drt.train_iteration(pt, ps, opt, batches[RT_ITERS],
                                        RT_ITERS, w_t=w_t)
                rep = affinity.check_profile(prof, drt.runtime)
                if not rep.ok:
                    _log_parentless(prof)
            else:
                rep = None
        per_it = {k: v / RT_ITERS for k, v in sorted(calls.items())}
        return (mets, full, float(np.mean(times[1:])), counts, wire, per_it,
                rep, bwd)

    parts = {}
    t = time.perf_counter()
    try:
        ref = run(devices=[dev, dev])
        parts["device-carved"], t = time.perf_counter() - t, \
            time.perf_counter()
        got = run(ranks=[0, 0], trace=True)
        parts["section meshes"], t = time.perf_counter() - t, \
            time.perf_counter()
        with _scaled_first_accumulated(0.99):
            bad = run(ranks=[0, 0])
        parts["planted"], t = time.perf_counter() - t, time.perf_counter()
        comp = run(ranks=[0, 0], compress="bf16")
        parts["bf16"], t = time.perf_counter() - t, time.perf_counter()
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i in range(RT_ITERS):
        print(f"sections iteration {i}: device-carved "
              f"{[float(x) for x in ref[0][i]]}, section meshes "
              f"{[float(x) for x in got[0][i]]}, bf16 "
              f"{[float(x) for x in comp[0][i]]}")
    same_mets = all(torch.equal(a, b) for ra, rb in zip(got[0], ref[0])
                    for a, b in zip(ra, rb))
    diff = sum(not torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    print(f"sections: metrics bitwise equal {same_mets}; student leaves "
          f"differing {diff} of {len(ref[1])}; launches (flash, KL, SSD) "
          f"device-carved {ref[3]}, section meshes {got[3]}")
    check(same_mets and diff == 0, "the section-mesh DistillRuntime differs "
          "from the device-carved one")
    want = (RT_ITERS * L * 3, RT_ITERS, 0)
    check(got[3] == ref[3] == want, f"(flash, KL, SSD) launched {got[3]} on "
          f"meshes and {ref[3]} device-carved, expected {want}")
    (BWD_LAUNCHES["sections"], KL_BWD_LAUNCHES["sections"],
     SSD_BWD_LAUNCHES["sections"]) = got[7]
    check(got[7] == ref[7], f"(flash_bwd, distill_kl_bwd, ssd_bwd) launched "
          f"{got[7]} on meshes and {ref[7]} device-carved")
    check(got[5].get("all_gather", 0) > 0
          and got[5].get("reduce_scatter", 0) > 0
          and got[5].get("all_reduce", 0) > 0,
          f"the mesh path skipped its collectives: {got[5]}")
    pdiff = sum(not torch.equal(a, b) for a, b in zip(bad[1], ref[1]))
    print(f"sections: with the first gradient leaf x 0.99, {pdiff} student "
          f"leaves differ; losses {[float(m[0]) for m in bad[0]]}")
    check(pdiff > 0, "a gradient scaled by 0.99 passed the bitwise "
          "comparison")
    # one rank and one microbatch: the float32 accumulator holds the bf16
    # gradient exactly, so the bf16 round trip (and its residual) is exact
    # and the compressed run must equal the exact one bit for bit
    c_mets = all(torch.equal(a, b) for ra, rb in zip(comp[0], got[0])
                 for a, b in zip(ra, rb))
    c_diff = sum(not torch.equal(a, b) for a, b in zip(comp[1], got[1]))
    payload = sum(x.numel() for x in ref[1]) * 4
    print(f"sections: bf16 metrics bitwise equal to the exact run's "
          f"{c_mets}, student leaves differing {c_diff}; wire {comp[4]}; "
          f"float32 payload {payload} bytes an iteration")
    check(c_mets and c_diff == 0, "bf16 compression at one rank and one "
          "microbatch differs from the exact run")
    check(comp[4]["bf16.bfloat16"] * 2 == RT_ITERS * payload,
          f"bf16: {comp[4]['bf16.bfloat16']} bytes on the wire for "
          f"{RT_ITERS} x {payload} float32 bytes")
    t = time.perf_counter()
    held = _rebuilds_reserved()
    from repro_torch.core import runtime as rt_mod
    release, rt_mod.release_blas_workspaces = \
        rt_mod.release_blas_workspaces, lambda: None
    try:
        leaked = _rebuilds_reserved()
    finally:
        rt_mod.release_blas_workspaces = release
        release()           # what the planted fault left behind
    free()
    parts["rebuilds"] = time.perf_counter() - t
    mib = [f"{x / 2**20:.0f}" for x in held]
    print(f"sections: reserved MiB after each of {len(held)} runtime builds "
          f"{mib}; with the workspace release off "
          f"{[f'{x / 2**20:.0f}' for x in leaked]}")
    check(max(held) <= held[0], "reserved memory grows as runtimes are "
          f"built one after another: {mib} MiB")
    check(leaked[-1] > leaked[0], "the rebuild check cannot fail: without "
          "the workspace release reserved memory did not grow")
    rep = got[6]
    print(rep.render())
    main = [f for f in rep.findings if f.subject == "main"]
    on_section = [f for f in rep.findings
                  if f.check == "affinity.main-on-section-stream"]
    print(f"sections: C10 check over one traced mesh iteration: "
          f"{len(on_section)} findings of main-thread kernels on a section's "
          f"stream; {main[0].message if main else 'no main-thread summary'}")
    check(rep.ok, "affinity: kernels of the traced section-mesh iteration")
    card_ = card()
    print(f"sections {TRAIN_ARCH} on {card_}: warm iteration ms "
          f"device-carved {ref[2]:.1f}, section meshes {got[2]:.1f}, bf16 "
          f"{comp[2]:.1f}; collective calls an iteration {got[5]} (bf16 "
          f"{comp[5]}); peak device memory {peak:.2f} GiB")
    print("sections: wall s of each part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items())
        + f"; phase {time.perf_counter() - t_phase:.1f}")
    return got[3][0], got[3][1]


# --------------------------------------------------------------------------- #
# Context parallelism at world size 1
# --------------------------------------------------------------------------- #
CP_CHUNKS = 4
# the chunk shapes of cp 4 with 4 chunks: the ViT's 4096 keys and the
# training shape's 2048, a quarter of each after the all-to-all
CP_CHUNK_SHAPES = (((2, 4096, 1024, 16, 16, 64), False),
                   ((4, 2048, 512, 16, 16, 64), True))
CP_CHUNK_DEGREE = 4
# float32 gradients of 2 full-width layers, chunked and merged against one
# flash call: the two sum the same terms in other orders
CP_GRAD_TOL = 1e-4
# bf16 gradients of the first batch at full depth with and without the CP
# impl, the worst leaf's |g_cp - g| / |g| (Frobenius norms), NOISE_LEAVES
# left out: on an H100 80GB HBM3 at 700 W the first layer's wq at
# 2.117e-2 (the chunks' bf16 partials rounded through 24 layers), and
# 4.872e-1 with chunk 1's lse planted ln 2 high; the limit is 3x the first
CP_BF16_GRAD_TOL = 2.0 ** -4


def cp_positions(cp: int, shard: int, j: int, cl: int) -> torch.Tensor:
    """The key positions of chunk ``j`` after the all-to-all at degree
    ``cp`` (``dist.context``'s layout), as a contiguous int32 tensor."""
    pos = (np.arange(cp)[:, None] * shard + j * cl
           + np.arange(cl)[None, :]).reshape(-1)
    return torch.as_tensor(pos, dtype=torch.int32, device="cuda")


def _cp_case(rng, mesh, shape, causal, dtype, chunks) -> dict:
    """cp_attention (ulysses, ``chunks`` chunks) against
    ops.flash_attention on the same inputs: the forward and (dq, dk, dv)
    of sum(o * do) within GRAD_TOL of 1 + |ref|, o also within
    SHAPE_REL_TOL of max|o_ref| and, row by row, of each row's own scale
    (a planted o * 0.9, and o * 0.9 on the second half of the rows, must
    fail them), and the launches a call."""
    from repro_torch.dist import context as cpx
    from repro_torch.kernels import ops
    B, S, T, H, KV, D = shape
    leaves = [_randn(rng, s, dtype).requires_grad_()
              for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]
    do = _randn(rng, (B, S, H, D), torch.float32)

    def cp_call(*x):
        return cpx.cp_attention(*x, mesh, mode="ulysses", causal=causal,
                                overlap_chunks=chunks)

    reset_counts()
    o = cp_call(*leaves)
    torch.cuda.synchronize()
    launches = read_counts()[0]
    got = torch.autograd.grad((o.float() * do).sum(), leaves)
    o_ref = ops.flash_attention(*leaves, causal=causal)
    want = torch.autograd.grad((o_ref.float() * do).sum(), leaves)
    worst = 0.0
    for name, g, w in (("o", o, o_ref), *zip(("dq", "dk", "dv"), got, want)):
        err = ((g.float() - w.float()).abs()
               / (1 + w.float().abs())).max().item()
        worst = max(worst, err)
        check(err <= GRAD_TOL[dtype], f"cp_attention chunks={chunks} "
              f"{shape} {dtype} {name}: {err:.3e} > {GRAD_TOL[dtype]}")
    # o on its own scale: at the ViT's shape |o| is about 0.2 at most, so
    # GRAD_TOL's 1 + |ref| would pass a scaled epilogue (SHAPE_REL_TOL)
    top = o_ref.float().abs().max().item()
    tol = SHAPE_REL_TOL * top
    oerr = (o.float() - o_ref.float()).abs().max().item()
    planted = (0.9 * o.float() - o_ref.float()).abs().max().item()
    rerr = row_rel_err(o.detach(), o_ref.detach())
    bad = o.detach().clone()
    bad[:, shape[1] // 2:] *= 0.9
    rplanted = row_rel_err(bad, o_ref.detach())
    del bad
    for cond, what in (
            (oerr <= tol, f"max|o-ref| {oerr:.3e} > {tol:.3e}"),
            (planted > tol, f"the limit {tol:.3e} passes o*0.9 "
                            f"({planted:.3e})"),
            (rerr <= SHAPE_REL_TOL, f"a row's max|o-ref| is {rerr:.3e} of "
                                    f"its max|o_ref|"),
            (rplanted > SHAPE_REL_TOL, f"the row limit passes o*0.9 on the "
                                       f"second half ({rplanted:.3e})")):
        check(cond, f"cp_attention chunks={chunks} {shape} {dtype}: {what}")
    check(launches == chunks, f"cp_attention chunks={chunks} launched "
          f"flash {launches} times, expected {chunks}")
    with torch.no_grad():
        ms = time_ms(lambda: cp_call(*leaves), iters=5)
        plain_ms = time_ms(lambda: ops.flash_attention(*leaves,
                                                       causal=causal),
                           iters=5)
    return {"err": worst, "o_err": oerr, "o_tol": tol, "o_planted": planted,
            "row_err": rerr, "row_planted": rplanted, "launches": launches,
            "ms": ms, "plain_ms": plain_ms}


def phase_cp(rng) -> int:
    """Context parallelism on a one-rank NCCL group (see the module
    docstring, ``phase_cp``); returns the flash launches of the bf16 train
    step run under ``cp_attention_impl``."""
    import os
    import torch.distributed as dist
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.dist import context as cpx
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models import attention as att
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = shd.section_mesh([0], ParallelConfig())
        check(shd.mesh_shape(mesh)["seq"] == 1, "the mesh's seq axis")
        # (a) the CP attention modes against one flash call
        for shape, causal in ((MLLM_VIT_ATTN, False), (TRAIN_ATTN, True)):
            for dtype in (torch.float32, torch.bfloat16):
                for chunks in (1, CP_CHUNKS):
                    r = _cp_case(rng, mesh, shape, causal, dtype, chunks)
                    print(f"cp_attention {shape} {str(dtype)[6:]} "
                          f"{'causal' if causal else 'non-causal'} ulysses "
                          f"chunks={chunks}: worst |x - ref| / (1 + |ref|) "
                          f"over o, dq, dk, dv {r['err']:.3e} (tol "
                          f"{GRAD_TOL[dtype]:.0e}); max|o-ref| "
                          f"{r['o_err']:.3e} (limit {r['o_tol']:.3e}, "
                          f"planted o*0.9 {r['o_planted']:.3e}), row by row "
                          f"{r['row_err']:.3e} (limit {SHAPE_REL_TOL:.3e}, "
                          f"planted {r['row_planted']:.3e}); flash launches "
                          f"a call {r['launches']}; forward {r['ms']:.3f} ms"
                          f" against one flash call {r['plain_ms']:.3f} ms")
        free()
        # (b1) qwen1.5-0.5b at full width, 2 layers, float32: the loss and
        # every gradient leaf under the CP impl against without it
        impl = cpx.cp_attention_impl(mesh, mode="ulysses",
                                     overlap_chunks=CP_CHUNKS)
        cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
        params = tree_map(lambda p: p.detach().float(),
                          build_model(cfg, device="cuda", seed=0)
                          .param_tree())
        Bg, Sg = 2, TRAIN_S
        toks = rng.integers(0, cfg.vocab_size, (Bg, Sg + 1))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
                 "labels": torch.from_numpy(toks[:, 1:]).cuda(),
                 "loss_mask": torch.from_numpy((rng.random((Bg, Sg)) < 0.9)
                                               .astype(np.float32)).cuda()}
        model = build_model(cfg, params, device="cuda")

        def grads(with_impl: bool):
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            reset_counts()
            ctx = att.attention_impl(impl) if with_impl else \
                contextlib.nullcontext()
            with ctx:
                loss, _ = model.loss(batch, params=p)
            g = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
            return loss.detach(), g, read_counts()[0]

        loss_cp, g_cp, n_cp = grads(True)
        loss_pl, g_pl, n_pl = grads(False)
        rel = grad_rel_err(g_cp, [g.cpu() for g in g_pl])
        dl = abs(loss_cp.item() - loss_pl.item()) / abs(loss_pl.item())
        print(f"cp {cfg.name} 2 layers f32 B={Bg} S={Sg}: loss "
              f"{loss_cp.item():.7f} (cp impl, ulysses {CP_CHUNKS} chunks) "
              f"vs {loss_pl.item():.7f}, relative {dl:.3e}; max per-leaf "
              f"|dg| / max|g| {rel:.3e} (tol {CP_GRAD_TOL:.0e}) over "
              f"{len(g_pl)} leaves; flash launches {n_cp} vs {n_pl}")
        check(dl <= CP_GRAD_TOL and rel <= CP_GRAD_TOL,
              "the CP impl changes qwen's loss or gradients at cp 1")
        check(n_cp == cfg.num_layers * 2 * CP_CHUNKS
              and n_pl == cfg.num_layers * 2,
              f"flash launched {n_cp} (cp) and {n_pl} times, expected "
              f"layers x 2 x {CP_CHUNKS} and layers x 2")
        del model, params, g_cp, g_pl
        free()
        # (b2) qwen1.5-0.5b at full depth in bf16, 4 x 2048: the first
        # batch's gradients, leaf by leaf, with the impl against without
        # it; with the impl and a planted fault (chunk 1's lse shifted by
        # ln 2 in the merge, so that chunk weighs twice) they must fail
        cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
        gen_b = [{"tokens": torch.from_numpy(t[:, :-1]),
                  "labels": torch.from_numpy(t[:, 1:]),
                  "loss_mask": torch.ones(TRAIN_B, TRAIN_S)}
                 for t in (rng.integers(0, cfg.vocab_size,
                                        (TRAIN_B, TRAIN_S + 1))
                           for _ in range(2))]
        model = build_model(cfg, device="cuda", seed=0)
        p0 = model.param_tree()
        b0 = {k: v.cuda() for k, v in gen_b[0].items()}
        merge = cpx.merge_flash_partials

        def shifted(parts_o, parts_lse):
            parts_lse = list(parts_lse)
            parts_lse[1] = parts_lse[1] + math.log(2.0)
            return merge(parts_o, parts_lse)

        def bf16_grads(with_impl: bool, planted: bool = False):
            p = tree_map(lambda x: x.detach().requires_grad_(), p0)
            ctx = att.attention_impl(impl) if with_impl else \
                contextlib.nullcontext()
            cpx.merge_flash_partials = shifted if planted else merge
            try:
                with ctx:
                    loss, _ = model.loss(b0, params=p)
                    g = torch.autograd.grad(loss, tree_leaves(p))
            finally:
                cpx.merge_flash_partials = merge
            return g

        names = [path for path, _ in _named_leaves(p0)]

        def leaf_gap(ga, gb) -> tuple[float, str, float]:
            """The worst leaf's gap and name, and the NOISE_LEAVES' worst
            (a key bias's gradient is zero but for rounding: softmax
            ignores a shift shared by a row's keys)."""
            worst, name, noise = 0.0, "", 0.0
            for path, a, b in zip(names, ga, gb):
                gap = ((a.float() - b.float()).norm()
                       / b.float().norm().clamp_min(1e-30)).item()
                if path.rsplit("/", 1)[-1] in NOISE_LEAVES:
                    noise = max(noise, gap)
                elif gap > worst:
                    worst, name = gap, path
            return worst, name, noise

        g_pl = bf16_grads(False)
        gap, leaf, noise = leaf_gap(bf16_grads(True), g_pl)
        gap_bad, leaf_bad, _ = leaf_gap(bf16_grads(True, planted=True), g_pl)
        print(f"cp {TRAIN_ARCH} bf16 full depth {TRAIN_B} x {TRAIN_S}: "
              f"first-batch gradients, worst leaf |g_cp - g| / |g| {gap:.3e}"
              f" ({leaf}; limit {CP_BF16_GRAD_TOL:.3e}; {NOISE_LEAVES} "
              f"{noise:.3e}); planted (chunk 1's lse + ln 2) {gap_bad:.3e} "
              f"({leaf_bad})")
        check(gap <= CP_BF16_GRAD_TOL, f"the bf16 gradients under the CP "
              f"impl differ by {gap:.3e} at {leaf} > {CP_BF16_GRAD_TOL:.3e}")
        check(gap_bad > CP_BF16_GRAD_TOL, f"the bf16 gradient limit passes "
              f"a chunk weighted twice ({gap_bad:.3e})")
        del model, p0, b0, g_pl
        free()
        # then one bf16 train step with and without the impl, each from the
        # same initial state; the second step of each is the warm one
        out = {}
        for with_impl in (True, False):
            model = build_model(cfg, device="cuda", seed=0)
            step = tstep.build_train_step(
                model, ParallelConfig(mbs=TRAIN_B),
                ShapeConfig("t", "train", TRAIN_S, TRAIN_B))
            p = model.param_tree()
            opt = adamw.init(p)
            ctx = att.attention_impl(impl) if with_impl else \
                contextlib.nullcontext()
            losses, launches = [], 0
            with ctx:
                for i, b in enumerate(gen_b):
                    b = {k: v.cuda() for k, v in b.items()}
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    p, opt, met = step(p, opt, b, i)
                    losses.append(float(met["loss"]))
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    if i == 0:
                        launches = read_counts()[0]
                        if with_impl:
                            note_bwd("cp")
            out[with_impl] = (losses, ms, launches)
            del model, step, p, opt
            free()
        (l_cp, ms_cp, n_cp), (l_pl, ms_pl, n_pl) = out[True], out[False]
        close = all(_rt_close(a, b) for a, b in zip(l_cp, l_pl))
        print(f"cp {TRAIN_ARCH} bf16 full depth {TRAIN_B} x {TRAIN_S}: "
              f"losses {l_cp} (cp impl) vs {l_pl}; warm step ms {ms_cp:.1f}"
              f" vs {ms_pl:.1f} on {card()}; flash launches a step {n_cp} "
              f"vs {n_pl}")
        check(_finite(l_cp) and close, f"the bf16 step's losses under the "
              f"CP impl {l_cp} are not within {RT_TOL} of {l_pl}")
        check(n_cp == cfg.num_layers * 2 * CP_CHUNKS
              and n_pl == cfg.num_layers * 2,
              f"flash launched {n_cp} (cp) and {n_pl} times a step")
        # (c) the cp-aware exchange between sections at world size 1
        _cp_sections_bitwise()
    finally:
        dist.destroy_process_group()
    print(f"cp: phase {time.perf_counter() - t_phase:.1f} s")
    return n_cp


def _cp_sections_bitwise() -> None:
    """``MLLMRuntime(..., ranks=[0, 0])`` with the ViT at ``cp=1`` against
    ``MLLMRuntime(devices=[cuda:0] * 2)``, two iterations at a reduced
    size (pixtral-12b's reduced LM, a 2-layer ViT; float32) under
    deterministic algorithms: losses, grad norms and both sections'
    parameters equal bit for bit, and the ViT run on the same
    microbatches."""
    import os
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.types import ParallelConfig
    from repro_torch.data.synthetic import vlm_batches
    from repro_torch.mllm import workload as mw
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.vlm import vit_config
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    lm = get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=1024, vision_dim=64, max_image_tokens=8)
    vit = vit_config(num_layers=2, d_model=64, num_heads=4, d_ff=128,
                     patch_dim=16, downsample=4, out_dim=64,
                     name="vit-tiny").replace(dtype="float32")
    shape = dict(global_batch=16, seq_len=256, mbs=4)
    data = vlm_batches(batch=16, seq_len=256, vocab=1024, vision_ratio=0.5,
                       image_tokens=8, patch_dim=16, seed=0, device="cpu")
    batches = [next(data) for _ in range(2)]
    dev = torch.device("cuda", 0)
    runs = {}
    try:
        for name, where in (("device-carved", dict(devices=[dev, dev])),
                            ("section meshes", dict(ranks=[0, 0]))):
            with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(cp=1),
                                lm_parallel=ParallelConfig(), **shape,
                                **where) as rt:
                params, opts = rt.init(0)
                mets, vit_tasks = [], []
                reset_counts()
                for i, b in enumerate(batches):
                    params, opts, m = rt.train_iteration(params, opts, b, i)
                    mets.append((m["loss"], m["grad_norm"]))
                    vit_tasks.append(m["n_vit_tasks"])
                launches = read_counts()[0]
                state = rt.state()[0]
                runs[name] = (mets, [x.clone() for sec in ("vit", "lm")
                                     for x in tree_leaves(state[sec])],
                              vit_tasks, launches)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    a, b = runs["device-carved"], runs["section meshes"]
    same = all(torch.equal(x, y) for ma, mb in zip(a[0], b[0])
               for x, y in zip(ma, mb))
    diff = sum(not torch.equal(x, y) for x, y in zip(a[1], b[1]))
    print(f"cp sections: MLLMRuntime ranks=[0, 0] (ViT cp=1) against "
          f"device carving: losses and grad norms bitwise equal {same}, "
          f"leaves differing {diff} of {len(a[1])}, ViT tasks {b[2]} vs "
          f"{a[2]}, flash launches {b[3]} vs {a[3]}")
    check(same and diff == 0 and a[2] == b[2] and a[3] == b[3],
          "the section-mesh MLLMRuntime differs from the device-carved one")


def phase_multi_teacher() -> tuple[int, int]:
    """Routed multi-teacher distillation of qwen1.5-0.5b through
    ``CompoundRuntime(multi_teacher_spec)``, three sections sharing the
    card, wavefront order on, against the colocated oracle on the same
    microbatch composition.  Returns the (flash, KL) launches."""
    from repro_torch.core import cost_model as cmdl
    from repro_torch.core import workload as wl
    from repro_torch.core.types import H100, ParallelConfig
    from repro_torch.data.synthetic import routed_lm_batches
    from repro_torch.distill import multi_teacher as mt
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    L = cfg.num_layers
    seeds = {"teacher_a": 1, "teacher_b": 2, "student": 0}
    init = {n: tree_map(lambda p: p.detach(),
                        build_model(cfg, device=dev, seed=s).param_tree())
            for n, s in seeds.items()}
    lr = functools.partial(schedules.constant, peak_lr=1e-4)
    par = ParallelConfig()
    spec = mt.multi_teacher_spec(cfg, cfg, cfg, ta_parallel=par,
                                 tb_parallel=par, s_parallel=par,
                                 global_batch=MT_B, seq_len=TRAIN_S,
                                 mbs=MT_MBS, alpha=0.5, temperature=2.0)
    gen = routed_lm_batches(batch=MT_B, seq_len=TRAIN_S,
                            vocab=cfg.vocab_size,
                            specialist_ratio=MT_RATIO, seed=0, device="cpu")
    batches = [next(gen) for _ in range(MT_ITERS)]
    w_a = mt.teacher_unembed(init["teacher_a"], cfg, dev)
    w_b = mt.teacher_unembed(init["teacher_b"], cfg, dev)
    consts = {"student": {"w_a": w_a, "w_b": w_b}}
    n_mb = MT_B // MT_MBS
    # what the planner believes: the cost model's per-sample seconds
    for role, trainable in (("student", True), ("teacher", False)):
        c = cmdl.section_cost(cfg, par, TRAIN_S, trainable=trainable,
                              hw=H100)
        print(f"multi-teacher cost model ({role}, {H100.name}): forward "
              f"{c.t_fwd_sample * 1e3:.2f} ms, backward "
              f"{c.t_bwd_sample * 1e3:.2f} ms per sample")
    rows, plans = [], []
    with wl.CompoundRuntime(spec, devices=[dev] * 3, lr_schedule=lr) as crt:
        streams = _worker_streams(crt)
        check(len(set(streams.values())) == 3,
              f"three sections, three streams: {streams}")
        params = {n: (tree_map(torch.clone, p) if n == "student" else p)
                  for n, p in init.items()}
        opts = {"student": adamw.init(params["student"])}
        reset_counts()
        for i, b in enumerate(batches):
            plan = crt.plan_iteration(b)
            fifo = crt.plan_iteration(b, reorder=False)
            t0 = time.perf_counter()
            params, opts, m = crt.train_iteration(params, opts, b, i,
                                                  plan=plan, consts=consts)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            n_b = len(plan.activation["teacher_b"].active_mbs)
            n_fifo = len(fifo.activation["teacher_b"].active_mbs)
            check(m["n_tasks"].get("teacher_b", 0) == n_b,
                  f"teacher_b ran {m['n_tasks']} against the plan's {n_b}")
            print(f"multi-teacher iteration {i}: {int(b['domain'].sum())} of "
                  f"{MT_B} samples specialist; teacher_b on {n_b} of {n_mb} "
                  f"microbatches (wavefront order; FIFO order: {n_fifo}); "
                  f"loss {loss:.4f} kl_a {float(m['kl_a']):.5f} kl_b "
                  f"{float(m['kl_b']):.5f} {ms:.1f} ms")
            check(n_b <= n_fifo, "the wavefront order ran the specialist "
                  "on more microbatches than FIFO")
            print(f"  planned order {list(plan.order)}: modeled makespan "
                  f"{plan.schedule.makespan * 1e3:.1f} ms (FIFO "
                  f"{plan.schedule.fifo_makespan * 1e3:.1f} ms)")
            rows.append((loss, ms, n_b))
            plans.append(plan)
            _section_report(m["execution"], crt.rt.queue)
        flash, kl, ssd = read_counts()
        note_bwd("multi_teacher")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # per microbatch: teacher_a's forward (L), the student's forward and its
    # remat recompute (2L), and teacher_b's forward (L) on its active
    # microbatches only; two KLs (against each teacher) per microbatch
    want_flash = sum(L * (3 * n_mb + n_b) for _, _, n_b in rows)
    want_kl = 2 * n_mb * MT_ITERS
    check((flash, kl, ssd) == (want_flash, want_kl, 0),
          f"multi-teacher launched (flash, KL, SSD) = {(flash, kl, ssd)}, "
          f"expected ({want_flash}, {want_kl}, 0)")
    # the colocated oracle on the same microbatch composition
    step = mt.build_colocated_step(cfg, cfg, cfg, alpha=0.5, temperature=2.0,
                                   lr_schedule=lr)
    ps = tree_map(torch.clone, init["student"])
    opt = adamw.init(ps)
    for i, b in enumerate(batches):
        ps, opt, om = step(ps, opt, init["teacher_a"], init["teacher_b"],
                           w_a, w_b, mt.colocated_batch(b, plans[i], dev), i)
        got, want = rows[i][0], float(om["loss"])
        print(f"multi-teacher iteration {i}: runtime loss {got:.6f}, "
              f"colocated oracle {want:.6f} (tol {RT_TOL} relative)")
        check(np.isfinite(got) and _rt_close(got, want),
              "multi-teacher runtime disagrees with the colocated oracle")
    warm = float(np.mean([ms for _, ms, _ in rows[1:]]))
    print(f"multi-teacher {cfg.name} x3 sections, batch {MT_B} x seq "
          f"{TRAIN_S} (mbs {MT_MBS}) bf16 on {card()}: cold "
          f"{rows[0][1]:.1f} ms, warm {warm:.1f} ms/iteration "
          f"({MT_B * TRAIN_S / warm * 1e3:.0f} tok/s); peak device memory "
          f"{peak:.2f} GiB")
    return flash, kl


# --------------------------------------------------------------------------- #
# MLLM training: a ViT section feeding a pixtral-12b-width LM section
# --------------------------------------------------------------------------- #
# The two-stage section planner (paper §3.2) on the H100
# --------------------------------------------------------------------------- #
# the JAX package's planner tests' budgets (tests/test_planner.py)
PLAN_BUDGET = dict(critical_gpus=256, seq_len=4096, global_batch=256)
PLAN_GRAPHS = (("self_distill_compound", None), ("distill_compound", None),
               ("vlm_compound", {"vit": 0.3}))


def phase_plan(calib: dict) -> None:
    """``planner.plan(..., hw=H100)`` for the compound configurations at
    the JAX package's test budgets: each plan's summary, every section
    within the card's memory, and eq. 2 on every edge into the critical
    section (DP^producer x fanout = DP^consumer).  Then ``plan_critical``
    for qwen1.5-0.5b on one card at the distill-runtime phase's batch,
    printed beside that phase's measured student busy time and peak memory:
    a calibration record, not a gate (the cost model's constants are the
    TPU's; ROADMAP.md, A9)."""
    from repro_torch.configs import compound, get_config
    from repro_torch.core import cost_model as cmdl
    from repro_torch.core import planner
    from repro_torch.core.types import H100, ParallelConfig, SectionConfig
    for name, rates in PLAN_GRAPHS:
        g = compound.COMPOUND[name]()
        plan = planner.plan(g, **PLAN_BUDGET, activation_rates=rates,
                            hw=H100)
        print(f"plan {name} on {H100.name} ({PLAN_BUDGET}, activation "
              f"{rates}): {plan.total_gpus} GPUs, iteration "
              f"{plan.iter_time * 1e3:.1f} ms\n{plan.summary()}")
        for sec, sp in plan.sections.items():
            cfg = g.sections[sec]
            check(cmdl.fits(cfg.arch, sp.parallel,
                            int(PLAN_BUDGET["seq_len"] * cfg.seq_scale),
                            trainable=cfg.trainable, hw=H100),
                  f"plan {name}: section {sec} does not fit the card")
        for e in g.edges:
            src, dst = plan.sections[e.src], plan.sections[e.dst]
            check(src.parallel.dp * src.fanout == dst.parallel.dp,
                  f"plan {name}: edge {e.src}->{e.dst} breaks eq. 2: dp "
                  f"{src.parallel.dp} x fanout {src.fanout} != dp "
                  f"{dst.parallel.dp}")
    cfg = get_config(TRAIN_ARCH).replace(dtype="bfloat16")
    one = planner.plan_critical(
        SectionConfig("student", cfg, ParallelConfig(), critical=True), 1,
        TRAIN_S, TRAIN_B, hw=H100)
    print(f"plan_critical {TRAIN_ARCH} on one {H100.name}, batch {TRAIN_B} "
          f"x {TRAIN_S}: mbs {one.parallel.mbs}, planned t_iter "
          f"{one.t_iter * 1e3:.1f} ms, mem_per_gpu "
          f"{one.mem_per_gpu / 2**30:.2f} GiB; measured in distill-runtime "
          f"(b) on {card()}: student busy {calib['student_busy_ms']:.1f} ms "
          f"(teacher {calib['teacher_busy_ms']:.1f} ms) an iteration, peak "
          f"{calib['peak_gib']:.2f} GiB (both sections)")


# --------------------------------------------------------------------------- #
# pixtral-12b at its full width, its depth cut to 2 of 40 layers, and the
# ViT, vit_config() at its width with out_dim = the LM's vision_dim, cut
# to 12 of its 24: one training state (about 22 bytes a parameter) must
# fit the card, and the whole script a fixed time, of which this phase
# (where the plain-PyTorch flash backward over the ViT's 4096 patches
# dominates an iteration) took the most
MLLM_LM_LAYERS = 2
MLLM_VIT_LAYERS = 12
MLLM_B, MLLM_S, MLLM_MBS, MLLM_RATIO, MLLM_ITERS = 8, 2048, 2, 0.5, 3
MLLM_VIT_ATTN = (MLLM_MBS, 4096, 4096, 16, 16, 64)    # 1024 tokens x 4
MLLM_LM_ATTN = (MLLM_MBS, MLLM_S, MLLM_S, 32, 8, 128)


def free() -> None:
    """Return the card's memory between phases."""
    gc.collect()
    torch.cuda.empty_cache()


def _host(tree):
    """A copy of a tensor tree in host memory."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _peak() -> tuple[float, int]:
    """Peak allocated GiB since the last reset, and how often the caching
    allocator had to free its cache and retry a cudaMalloc (each retry
    synchronises the device) over the process so far."""
    return (torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.memory_stats().get("num_alloc_retries", 0))


def _masters(opts) -> dict:
    """The f32 master weights of both sections, on the host."""
    return {"vit": _host(opts["vit"].master), "lm": _host(opts["lm"].master)}


def mllm_setup(dev):
    """(vit_cfg, lm_cfg, kw) of the MLLM phases: the ViT's MLLM_VIT_LAYERS
    layers feeding pixtral-12b's width at MLLM_LM_LAYERS layers, and
    ``MLLMRuntime``'s keywords (both sections on ``dev``, batch MLLM_B x
    MLLM_S in microbatches of MLLM_MBS, lr 1e-4), which
    ``mllm.workload.build_colocated_step`` shares through ``lr_schedule``."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import ParallelConfig
    from repro_torch.models import vlm
    from repro_torch.optim import schedules
    lm_cfg = get_config("pixtral-12b").replace(num_layers=MLLM_LM_LAYERS)
    vit_cfg = vlm.vit_config(num_layers=MLLM_VIT_LAYERS,
                             out_dim=lm_cfg.vision_dim)
    kw = dict(vit_parallel=ParallelConfig(), lm_parallel=ParallelConfig(),
              global_batch=MLLM_B, seq_len=MLLM_S, mbs=MLLM_MBS,
              devices=[dev, dev],
              lr_schedule=functools.partial(schedules.constant,
                                            peak_lr=1e-4))
    return vit_cfg, lm_cfg, kw


def mllm_batches(vit_cfg, lm_cfg, ratio: float, seed: int, n: int) -> list:
    """The first ``n`` host batches of ``vlm_batches(seed=)`` at the MLLM
    phases' shape, ``ratio`` of the samples with an image."""
    from repro_torch.data.synthetic import vlm_batches
    from repro_torch.models import vlm
    gen = vlm_batches(batch=MLLM_B, seq_len=MLLM_S, vocab=lm_cfg.vocab_size,
                      vision_ratio=ratio,
                      image_tokens=lm_cfg.max_image_tokens,
                      patch_dim=vit_cfg.frontend_dim,
                      downsample=vlm.downsample_factor(vit_cfg),
                      seed=seed, device="cpu")
    return [next(gen) for _ in range(n)]


def phase_mllm() -> int:
    """MLLM training through ``MLLMRuntime``: the ViT section and the LM
    section (pixtral-12b width, 2 layers) each on its own worker thread
    and CUDA stream of the one card, from one host-side initial parameter
    set: (a) the colocated step, (b) the runtime serialized, (c) streamed
    with lookahead 1, run one after the other (two training states do not
    fit); then an all-text batch, wavefront against FIFO, and one traced
    iteration, whose kernels the affinity pass holds to their sections'
    streams; installing two sections' states that share a master tensor
    must be refused.  Returns the flash launches of (c)'s 3 iterations."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import affinity
    from repro_torch.analysis.donation import AliasedStateError
    from repro_torch.mllm import workload as mw
    from repro_torch.models import vlm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    dev = torch.device("cuda", 0)
    vit_cfg, lm_cfg, kw = mllm_setup(dev)
    lr = kw["lr_schedule"]
    Lv, Ll = vit_cfg.num_layers, lm_cfg.num_layers
    n_mb = MLLM_B // MLLM_MBS
    toks = MLLM_B * MLLM_S
    card_ = card()
    batches = mllm_batches(vit_cfg, lm_cfg, MLLM_RATIO, 0, MLLM_ITERS + 1)
    (text,) = mllm_batches(vit_cfg, lm_cfg, 0.0, 1, 1)
    init = _host(mw.init_compound_params(vit_cfg, lm_cfg, seed=0,
                                         device=dev))
    free()
    n_par = {k: sum(x.numel() for x in tree_leaves(init[k])) for k in init}
    print(f"mllm: vit {vit_cfg.num_layers} layers d_model {vit_cfg.d_model} "
          f"({n_par['vit'] / 1e6:.1f}M parameters) -> {lm_cfg.name} width, "
          f"{Ll} layers ({n_par['lm'] / 1e6:.1f}M); batch {MLLM_B} x "
          f"{MLLM_S} in microbatches of {MLLM_MBS}, vision ratio "
          f"{MLLM_RATIO}, {lm_cfg.max_image_tokens} image tokens of "
          f"{lm_cfg.max_image_tokens * vlm.downsample_factor(vit_cfg)} "
          "patches, bf16")
    with mw.MLLMRuntime(vit_cfg, lm_cfg, **kw) as planner:
        plans = [planner.plan_iteration(b["has_image"]) for b in batches]
        fifos = [planner.plan_iteration(b["has_image"], reorder=False)
                 for b in batches]
        text_plan = planner.plan_iteration(text["has_image"])
    # the batch on which the wavefront order saves the most ViT microbatches
    w = max(range(MLLM_ITERS), key=lambda i: len(fifos[i].image_mbs)
            - len(plans[i].image_mbs))
    keys = ("loss", "grad_norm")
    runs, peaks = {}, {}

    def record(mode, i, met, ms):
        runs.setdefault(mode, []).append((met, ms))
        print(f"mllm ({mode}) iteration {i}: {len(plans[i].image_mbs)} of "
              f"{n_mb} microbatches with images; loss {met['loss']:.4f} "
              f"gnorm {met['grad_norm']:.3f} {ms:.1f} ms")

    def launches_of(its, vit_per_mb):
        # the ViT's layers launch flash vit_per_mb times on a microbatch it
        # runs, the LM's 2 times (forward and its remat recompute) on every
        # microbatch
        return sum(Lv * vit_per_mb(plans[i]) + Ll * 2 * n_mb for i in its)

    # (a) the colocated step: the ViT on every microbatch, padded rows
    # masked to zero, as the reference's single jit runs it
    torch.cuda.reset_peak_memory_stats()
    step = mw.build_colocated_step(vit_cfg, lm_cfg, device=dev,
                                   lr_schedule=lr)
    params = tree_map(lambda x: x.to(dev), init)
    opt = adamw.init(params)
    reset_counts()
    for i in range(MLLM_ITERS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt,
                                mw.colocated_batch(batches[i], plans[i]), i)
        record("a colocated", i, {k: float(met[k]) for k in keys},
               (time.perf_counter() - t0) * 1e3)
    counts_a = read_counts()
    peaks["a"] = _peak()
    masters_a = _host(opt.master)
    del params, opt, step, met
    free()
    # forward and remat recompute of every layer of both sections
    want_a = launches_of(range(MLLM_ITERS), lambda p: 2 * n_mb)
    check(counts_a == (want_a, 0, 0), f"(a) launched (flash, KL, SSD) = "
          f"{counts_a}, expected ({want_a}, 0, 0)")

    # (b) MLLMRuntime, serialized
    torch.cuda.reset_peak_memory_stats()
    with mw.MLLMRuntime(vit_cfg, lm_cfg, **kw) as rt:
        streams = _worker_streams(rt)
        main = torch.cuda.current_stream(dev).cuda_stream
        check(len(set(streams.values())) == 2
              and main not in streams.values(),
              f"the two sections must each run on a stream of their own: "
              f"{streams}, main {main}")
        params, opts = rt.place(init)
        reset_counts()
        for i in range(MLLM_ITERS):
            t0 = time.perf_counter()
            params, opts, m = rt.train_iteration(params, opts, batches[i], i,
                                                 plan=plans[i])
            record("b serialized", i, {k: float(m[k]) for k in keys},
                   (time.perf_counter() - t0) * 1e3)
            n_img = len(plans[i].image_mbs)
            check(m["n_vit_tasks"] == 2 * n_img
                  and m["n_tasks"]["vit"] == 2 * n_img + 1,
                  f"vit tasks {m['n_tasks']} for {n_img} image microbatches")
        counts_b = read_counts()
        print("mllm (b) sections of the last iteration:")
        _section_report(m["execution"], rt.rt.queue)
        for sec in ("vit", "lm"):
            still = [p for (p, x), x0 in zip(_named_leaves(
                opts[sec].master), tree_leaves(init[sec]))
                if bool((x == x0.to(dev).float()).all())]
            check(not still, f"{sec} master weights that did not move: "
                  f"{still}")
        masters_b = _masters(opts)
        del params, opts, m
    peaks["b"] = _peak()
    del rt
    free()

    # (c) the same runtime streamed with lookahead 1; then an all-text
    # batch, wavefront against FIFO and one traced iteration
    torch.cuda.reset_peak_memory_stats()
    with mw.MLLMRuntime(vit_cfg, lm_cfg, lookahead=1, **kw) as rt:
        _affinity_ok(affinity.check_wiring(rt), "MLLM wiring")
        rt.install(*rt.place(init))
        reset_counts()
        t_start = time.perf_counter()
        for i in range(MLLM_ITERS):
            rt.submit_iteration(batches[i], i, plan=plans[i])
        ms = rt.drain()
        counts_c = read_counts()
        note_bwd("mllm")
        prev = t_start
        for i, m in enumerate(ms):
            end = m["execution"].t0 + max(e.end for e in
                                          m["execution"].timeline)
            record("c streamed", i, {k: float(m[k]) for k in keys},
                   (end - prev) * 1e3)
            prev = end
        masters_c = _masters(rt.state()[1])
        print("mllm (c) sections of the last iteration:")
        _section_report(ms[-1]["execution"], rt.rt.queue)
        step_i = MLLM_ITERS

        # all text: the vision section runs only its update, and the queue
        # carries only the 2-push joint grad-norm rendezvous
        pushes = rt.rt.queue.stats()["pushes"]
        check(text_plan.image_mbs == (), "the all-text plan wakes the ViT")
        rt.submit_iteration(text, step_i, plan=text_plan)
        (tm,) = rt.drain()
        step_i += 1
        vit_tags = [e.tag for e in tm["execution"].timeline
                    if e.section == "vit"]
        grew = rt.rt.queue.stats()["pushes"] - pushes
        print(f"mllm all-text batch: vit timeline {vit_tags}, queue pushes "
              f"+{grew}, loss {float(tm['loss']):.4f}, "
              f"{tm['execution'].makespan * 1e3:.1f} ms")
        check(vit_tags == ["upd"] and grew == 2 and tm["n_vit_tasks"] == 0
              and np.isfinite(float(tm["loss"])),
              "all-text batch: the vision section ran more than its update "
              "or the queue carried activations")

        # wavefront against FIFO on the same mixed batch
        made = {}
        for name, plan in (("wavefront", plans[w]), ("FIFO", fifos[w])):
            rt.submit_iteration(batches[w], step_i, plan=plan)
            (m,) = rt.drain()
            step_i += 1
            made[name] = m["execution"].makespan * 1e3
            print(f"mllm batch {w}, {name} order {list(plan.order)}: ViT on "
                  f"{len(plan.image_mbs)} of {n_mb} microbatches; realized "
                  f"makespan {made[name]:.1f} ms")
        print(f"mllm batch {w}: planned makespan wavefront "
              f"{plans[w].schedule.makespan * 1e3:.1f} ms, FIFO "
              f"{plans[w].schedule.fifo_makespan * 1e3:.1f} ms")
        for i in range(MLLM_ITERS):
            check(len(plans[i].image_mbs) <= len(fifos[i].image_mbs),
                  f"batch {i}: the wavefront order ran the ViT on more "
                  "microbatches than FIFO")

        # one warm streamed iteration, traced
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts,
                     experimental_config=affinity.profile_config()) as prof:
            t0 = time.perf_counter()
            rt.submit_iteration(batches[MLLM_ITERS], step_i,
                                plan=plans[MLLM_ITERS])
            (m,) = rt.drain()
            check(np.isfinite(float(m["loss"])), "non-finite traced loss")
            wall = (time.perf_counter() - t0) * 1e3
        _kernel_report(prof, wall, "warm streamed MLLM iteration")
        _stream_report(prof, wall, "MLLM iteration (streams)",
                       _flash_count_roles({
                           "vit": Lv * 3 * len(plans[MLLM_ITERS].image_mbs),
                           "llm": Ll * 2 * n_mb}))
        _section_report(m["execution"], rt.rt.queue)
        _affinity_ok(affinity.check_profile(prof, rt),
                     "kernels of the traced MLLM iteration")
        # planted: the LM's optimizer state holding one of the ViT's
        # master tensors must be refused at install
        p_now, o_now = rt.state()
        key = next(iter(o_now["lm"].master))
        bad = dict(o_now, lm=o_now["lm"]._replace(master={
            **o_now["lm"].master, key: o_now["vit"].master}))
        try:
            rt.install(p_now, bad)
            refused = None
        except AliasedStateError as e:
            refused = str(e)
        print("mllm: install of an LM state sharing the ViT's master: "
              + (refused or "accepted")[:400])
        check(refused is not None and "cross-section-alias" in refused,
              "install accepted two sections' states sharing one master")
    peaks["c"] = _peak()
    del rt
    free()

    # per ViT microbatch: the fwd task's forward, and the bwd task's
    # forward under autograd with its remat recompute (3 per layer)
    want = launches_of(range(MLLM_ITERS),
                       lambda p: 3 * len(p.image_mbs))
    for mode, counts in (("b", counts_b), ("c", counts_c)):
        check(counts == (want, 0, 0), f"({mode}) launched (flash, KL, SSD) "
              f"= {counts}, expected ({want}, 0, 0)")
    for i in range(MLLM_ITERS):
        (ma, _), (mb, _), (mc, _) = (runs[k][i] for k in sorted(runs))
        for k in keys:
            check(all(np.isfinite([ma[k], mb[k], mc[k]])),
                  f"non-finite {k} at iteration {i}")
            check(_rt_close(mb[k], ma[k]), f"(b) {k} {mb[k]} vs colocated "
                  f"{ma[k]} at iteration {i} (tol {RT_TOL} relative)")
            check(_rt_close(mc[k], mb[k]), f"(c) {k} {mc[k]} vs (b) {mb[k]} "
                  f"at iteration {i} (tol {RT_TOL} relative)")
    for what, new, ref in (("(b) vs (a)", masters_b, masters_a),
                           ("(c) vs (b)", masters_c, masters_b)):
        # every leaf is checked: neither section has an attention key bias
        # (NOISE_LEAVES), whose gradient is zero in exact arithmetic
        gap, leaf, most, noise = _update_gap(new, ref, init)
        print(f"mllm {what}: master weights of both sections after "
              f"{MLLM_ITERS} iterations, worst leaf {leaf} |new - ref| / "
              f"|ref - start| {gap:.3e} (tol {UPD_TOL}), max |new - ref| "
              f"{most:.3e}")
        check(noise == 0.0 and gap <= UPD_TOL,
              f"{what}: the updates differ at {leaf}: {gap:.3e} > {UPD_TOL}")
    # printed, not checked: bitwise equality needs every reduction to sum
    # in the same order on both runs, which CUDA does not promise for
    # kernels queued from other threads and streams (atomics in the
    # embedding backward); the checks above are the contract
    bitwise = all(torch.equal(a, c) for a, c in
                  zip(tree_leaves(masters_b), tree_leaves(masters_c)))
    same = all(runs["b serialized"][i][0] == runs["c streamed"][i][0]
               for i in range(MLLM_ITERS))
    print(f"mllm: (c) streamed vs (b) serialized bitwise equal: metrics "
          f"{same}, master weights {bitwise}")
    print(f"mllm realized makespan: wavefront {made['wavefront']:.1f} ms, "
          f"FIFO {made['FIFO']:.1f} ms")
    for mode, rows in sorted(runs.items()):
        times = [t for _, t in rows]
        warm = float(np.mean(times[1:]))
        print(f"mllm {lm_cfg.name}-width ({mode}), batch {MLLM_B} x seq "
              f"{MLLM_S} bf16 on {card_}: cold {times[0]:.1f} ms, warm "
              f"{warm:.1f} ms/iteration ({toks / warm * 1e3:.0f} tok/s); "
              f"peak device memory {peaks[mode[0]][0]:.2f} GiB, "
              f"{peaks[mode[0]][1]} allocator retries")
    return counts_c[0]


# --------------------------------------------------------------------------- #
# SSD scan kernel and mamba2-130m
# --------------------------------------------------------------------------- #
def _ssd_inputs(rng, b, s, h, p, n, dtype, packed=False, A=None):
    """Inputs of the SSD scan on the card: dt = softplus(N(0,1)), A =
    -exp(N(0,1)) (or the constant given), x, B, C, D ~ N(0,1).  With
    ``packed``, x, B and C are slices of one [b, s, h*p + 2n] tensor, as the
    model passes them."""
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32))
    A = (-torch.exp(_randn(rng, (h,), torch.float32)) if A is None
         else torch.full((h,), A, device="cuda"))
    D = _randn(rng, (h,), torch.float32)
    if packed:
        xbc = _randn(rng, (b, s, h * p + 2 * n), dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x = _randn(rng, (b, s, h, p), dtype)
        B, C = _randn(rng, (b, s, n), dtype), _randn(rng, (b, s, n), dtype)
    return x, dt, A, B, C, D


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs()
            / (1 + want.float().abs())).max().item()


def _worst_step(got, want) -> str:
    """The element where |y-ref| / (1 + |ref|) is largest: |ref| there,
    |y-ref| and that in bf16 steps at |ref| (2**(e-8) for |ref| in
    [2**(e-1), 2**e))."""
    d, r = (got.float() - want.float()).abs(), want.float().abs()
    i = (d / (1 + r)).argmax()
    ref, diff = r.flatten()[i], d.flatten()[i]
    step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return (f"worst element |ref| {ref.item():.4g}: |y-ref| {diff.item():.4g}"
            f" = {(diff / step).item():.3g} bf16 steps there")


def ssd_case(rng, shape, dtype, return_state, packed) -> float:
    """One sweep case of the SSD kernel against its plain version."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref
    x, dt, A, B, C, D = _ssd_inputs(rng, *shape, dtype, packed)
    route = ("cuda cores" if dtype == torch.float32 else "tensor cores, "
             + ("TMA" if ssd.tma_route(x, B, C) else "threads' loads"))
    out = ssd.ssd_fwd(x, dt, A, B, C, D, return_state=return_state)
    want = ssd_scan_ref(x, dt, A, B, C, D, return_state=return_state)
    torch.cuda.synchronize()
    y, y_ref = (out[0], want[0]) if return_state else (out, want)
    check(bool(torch.isfinite(y).all()), f"SSD kernel output not finite "
          f"at {shape}")
    err = _rel(y, y_ref)
    check(err <= SSD_TOL[dtype], f"SSD y at {shape} {dtype}: {err:.3e} > "
          f"{SSD_TOL[dtype]}")
    worst = _worst_step(y, y_ref) if dtype == torch.bfloat16 else ""
    serr = 0.0
    if return_state:
        serr = _rel(out[1], want[1])
        check(serr <= SSD_STATE_TOL, f"SSD final state at {shape} {dtype}: "
              f"{serr:.3e} > {SSD_STATE_TOL}")
    print(f"  ssd {shape} {str(dtype)[6:]} state={return_state} "
          f"packed={packed} ({route}): |y-ref|/(1+|ref|) {err:.3e}"
          + (f", state {serr:.3e}" if return_state else "")
          + (f"; {worst}" if worst else ""))
    return err


def phase_ssd_sweep(rng) -> None:
    print("SSD kernel vs plain version (relative to 1 + |ref|: f32 tol "
          f"{SSD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{SSD_TOL[torch.bfloat16]:.0e}, state tol {SSD_STATE_TOL:.0e})")
    for i, shape in enumerate(SSD_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            for return_state in (False, True):
                # every other shape with x, B, C sliced from one tensor
                ssd_case(rng, shape, dtype, return_state, packed=i % 2 == 1)
    ssd_case(rng, SSD_LONG, torch.bfloat16, True, packed=True)
    for shape in SSD_JAMBA_SHORT:
        ssd_case(rng, shape, torch.bfloat16, True, packed=True)


def _kernel_split(fn, iters: int, key: str = "ssd_", once=()) -> dict:
    """Device ms a call of ``fn`` by the name of each kernel it launches
    whose name holds ``key``, from ``torch.profiler`` over ``iters`` warm
    calls: a kernel's summed time over the calls.  A kernel whose name
    holds one of ``once`` launches once a call and reads its mean time a
    launch, and the trace is taken again, three times at most, while it
    lacks one of them: on the H100, CUPTI has dropped records in a process
    that traced many times (one trace summed the flash backward's three
    kernels to half the time CUDA events gave its calls, another held
    none of its kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen: dict = {}
        for evt in prof.events():
            if _kernel_event(evt) and key in evt.name:
                n, us = seen.get(evt.name, (0, 0.0))
                seen[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
        missing = [p for p in once if not any(p in name for name in seen)]
        if seen and not missing:
            break
    check(bool(seen) and not missing, f"the profiler saw no kernel named "
          f"*{key}*" + (f" with {missing} in its name" if missing else ""))
    return {name: us / 1e3 / (n if any(p in name for p in once) else iters)
            for name, (n, us) in seen.items()}


def phase_ssd_shape(rng, shape) -> dict:
    """The kernel at one main-path shape (bf16), with x, B and C sliced from
    one tensor as the model passes them: checked against its plain version,
    timed beside it, and its kernels' device times traced."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref
    b, s, h, p, n = shape
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s, h, p, n, torch.bfloat16,
                                    packed=True)
    check(ssd.tma_route(x, B, C), f"the main shape {shape} does not take "
          "TMA")
    y, state = ssd.ssd_fwd(x, dt, A, B, C, D, return_state=True)
    y_ref, state_ref = ssd_scan_ref(x, dt, A, B, C, D, return_state=True)
    err = (y.float() - y_ref.float()).abs().max().item()
    rel = _rel(y, y_ref)
    serr = _rel(state, state_ref)
    worst = _worst_step(y, y_ref)
    del y, state, y_ref, state_ref
    check(rel <= SSD_TOL[torch.bfloat16] and serr <= SSD_STATE_TOL,
          f"SSD at {shape}: y {rel:.3e}, state {serr:.3e}")
    ms = time_ms(lambda: ssd.ssd_fwd(x, dt, A, B, C, D), iters=20)
    split = _kernel_split(lambda: ssd.ssd_fwd(x, dt, A, B, C, D), iters=10)
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, D), iters=3,
                       warmup=1)
    Q, nc = ssd.CHUNK, -(-s // ssd.CHUNK)
    # C B^T once per (b, chunk), the intra-chunk product, the inter-chunk
    # product and the chunk states
    flops = (2 * b * nc * Q * Q * n + 2 * b * h * nc * Q * Q * p
             + 2 * 2 * b * h * s * p * n)
    nbytes = (2 * (2 * b * s * h * p) + 4 * b * s * h + 2 * (2 * b * s * n)
              + 2 * 4 * h)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    scratch = 4 * ssd.scratch(b, s, h, p, n, torch.bfloat16)[1]
    print(f"ssd main shape {shape} bf16: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); max|y-ref| "
          f"{err:.3e} (relative {rel:.3e}), state {serr:.3e}; state scratch "
          f"{scratch / 1e6:.1f} MB; no single PyTorch call computes the scan"
          f"; {worst}")
    for name, k_ms in split.items():
        print(f"  ssd split: {k_ms:.4f} ms ({100 * k_ms / ms:.1f}% of the "
              f"event-timed call)  {name[:90]}")
    print(f"  ssd split: {sum(split.values()):.4f} ms in {len(split)} "
          "kernels (torch.profiler, device time a call)")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def ssd_entry(at: dict) -> dict:
    """The SSD kernel's line: mamba2-130m's numbers at the top, each
    main-path shape's under ``at``, the worst error of all."""
    return {"name": "ssd_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_fwd.cu",
            "replaces": "src/repro/kernels/ssd_pallas.py:30",
            "launches": None,
            **{k: v for k, v in at["mamba"].items() if k != "shape"},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def _ssd_bwd_errs(got, want, dtype) -> dict:
    """Each leaf's error as the SSD backward is held: f32 outputs as max
    |g - ref| / max |ref| of the leaf, bf16 ones (dx, dB, dC) row by row
    (``row_rel_err``: dx's rows over p, dB's and dC's over n)."""
    errs = {}
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        if g.dtype == torch.bfloat16:
            errs[name] = row_rel_err(g, w)
        else:
            errs[name] = ((g.float() - w.float()).abs().max()
                          / w.float().abs().max().clamp_min(1e-30)).item()
    return errs


def _ssd_bwd_limit(name: str, dtype) -> float:
    return (SHAPE_REL_TOL if dtype == torch.bfloat16
            and name in ("dx", "dB", "dC") else SSD_BWD_TOL)


def _ssd_bwd_at(rng, shape, dtype, with_state, packed, A=None) -> float:
    """The SSD backward (``ssd_scan.ssd_bwd``) at one shape against
    ``ref.ssd_bwd_ref``: every output finite and within its limit, two
    calls equal bit for bit; planted faults, the final state's gradient
    dropped (the dH carried into the last chunk) and the last chunk's rows
    of dx, dB and dC zeroed, must miss the limits.  Returns the largest
    max |g - ref| over the outputs."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_bwd_ref
    b, s, h, p, n = shape
    x, dt, A_, B, C, D = _ssd_inputs(rng, *shape, dtype, packed, A=A)
    gy = _randn(rng, (b, s, h, p), dtype)
    gs = _randn(rng, (b, h, p, n), torch.float32) if with_state else None
    got = ssd.ssd_bwd(x, dt, A_, B, C, D, gy, gs)
    again = ssd.ssd_bwd(x, dt, A_, B, C, D, gy, gs)
    want = ssd_bwd_ref(x, dt, A_, B, C, D, gy, gs)
    torch.cuda.synchronize()
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    for name, g in zip(names, got):
        check(bool(torch.isfinite(g).all()), f"ssd_bwd {name} at {shape} "
              f"{dtype} not finite")
    errs = _ssd_bwd_errs(got, want, dtype)
    bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
    planted_errs = {}
    if with_state:
        no_state = ssd.ssd_bwd(x, dt, A_, B, C, D, gy, None)
        e = _ssd_bwd_errs(no_state, want, dtype)
        planted_errs["gstate dropped"] = max(
            e[k] / _ssd_bwd_limit(k, dtype) for k in names)
    t_last = (s - 1) // ssd.CHUNK * ssd.CHUNK
    bad = [g.clone() for g in got]
    for i in (0, 3, 4):                   # dx, dB, dC
        bad[i][:, t_last:] = 0
    e = _ssd_bwd_errs(bad, want, dtype)
    planted_errs["last chunk zeroed"] = max(
        e[k] / _ssd_bwd_limit(k, dtype) for k in names)
    max_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    route = ("" if dtype != torch.bfloat16 else " by TMA"
             if ssd.tma_route(x, B, C, gy) else " by threads")
    print(f"  ssd_bwd {shape} {str(dtype)[6:]}{route} gstate={with_state} "
          f"packed={packed} A={'exp' if A is None else A}: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" (max|g-ref| {max_abs:.3e}); bitwise {bitwise}"
          + "".join(f"; planted {k}: {v:.1f}x the limit"
                    for k, v in planted_errs.items()))
    for k, v in errs.items():
        lim = _ssd_bwd_limit(k, dtype)
        check(v <= lim, f"ssd_bwd {k} at {shape} {dtype}: {v:.3e} > {lim}")
    check(bitwise, f"ssd_bwd at {shape} {dtype}: two calls differ")
    for k, v in planted_errs.items():
        check(v > 1, f"ssd_bwd at {shape} {dtype}: the limits pass the "
              f"planted fault '{k}'")
    return max_abs


def phase_ssd_bwd_sweep(rng) -> None:
    print(f"SSD backward kernel vs ref.ssd_bwd_ref (f32 outputs within "
          f"{SSD_BWD_TOL:.0e} of the leaf's largest element, bf16 dx/dB/dC "
          f"rows within {SHAPE_REL_TOL:.3e} of their own scale)")
    for i, (shape, A) in enumerate(SSD_BWD_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            for with_state in (False, True):
                _ssd_bwd_at(rng, shape, dtype, with_state,
                            packed=i % 2 == 1, A=A)
    _ssd_bwd_routes(rng, *SSD_BWD_ROUTE)


def _ssd_bwd_routes(rng, shape, A) -> None:
    """The bf16 backward with x, B and C sliced from one tensor (by TMA),
    then with gy copied to a base 2 bytes past 16-byte alignment, which TMA
    refuses, so that every tile loads by threads: the same bits."""
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, n = shape
    x, dt, A_, B, C, D = _ssd_inputs(rng, *shape, torch.bfloat16, True, A=A)
    gy = _randn(rng, (b, s, h, p), torch.bfloat16)
    gs = _randn(rng, (b, h, p, n), torch.float32)
    off = torch.empty(gy.numel() + 1, dtype=gy.dtype, device=gy.device)
    gy_off = off[1:].view(gy.shape)
    gy_off.copy_(gy)
    check(ssd.tma_route(x, B, C, gy) and not ssd.tma_route(x, B, C, gy_off),
          "the route case does not split TMA from threads")
    by_tma = ssd.ssd_bwd(x, dt, A_, B, C, D, gy, gs)
    by_threads = ssd.ssd_bwd(x, dt, A_, B, C, D, gy_off, gs)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(by_tma, by_threads))
    print(f"  ssd_bwd {shape} bf16 by TMA against by threads: bitwise {same}")
    check(same, f"ssd_bwd at {shape}: the threads' route differs from TMA's")


def phase_ssd_bwd_main(rng, shape) -> dict:
    """The backward at mamba2-130m's training shape (bf16, x, B and C
    sliced from one tensor as the model passes them, no final state's
    gradient, as training runs it): checked as in the sweep, then timed
    beside its kernels (traced), the plain version, and autograd through
    ``ssd_chunked`` at chunk 128 recomputed from the inputs, which is what
    the backward ran before this kernel; no single PyTorch call computes
    this backward, so that takes ``library_ms``'s place.  The bound
    counts the op's flop formula at the bf16 peak against x, gy, dx, B,
    C, dB, dC, dt, ddt, A, D, dA and dD moved once."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_bwd_ref
    b, s, h, p, n = shape
    max_abs = _ssd_bwd_at(rng, shape, torch.bfloat16, False, packed=True)
    x, dt, A, B, C, D = _ssd_inputs(rng, *shape, torch.bfloat16, packed=True)
    gy = _randn(rng, (b, s, h, p), torch.bfloat16)
    args = (x, dt, A, B, C, D, gy)
    ms = time_ms(lambda: ssd.ssd_bwd(*args), iters=10)
    split = _kernel_split(lambda: ssd.ssd_bwd(*args), iters=5, key="ssd_bwd")
    plain_ms = time_ms(lambda: ssd_bwd_ref(*args), iters=2, warmup=1)
    leaves = [t.detach().requires_grad_() for t in args[:6]]

    def autograd_plain():
        y = ssd.ssd_chunked(*leaves, chunk=128)
        return torch.autograd.grad(y, leaves, gy)

    library_ms = time_ms(autograd_plain, iters=2, warmup=1)
    del leaves
    Q, nc = ssd.CHUNK, -(-s // ssd.CHUNK)
    flops = (10 * b * h * nc * Q * p * n + 2 * b * nc * Q * Q * n
             + 4 * b * h * nc * Q * Q * (p + n))
    nbytes = (3 * 2 * b * s * h * p + 4 * 2 * b * s * n + 2 * 4 * b * s * h
              + 4 * 4 * h)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    n_cum, n_work = ssd.bwd_scratch(b, s, h, p, n, torch.bfloat16)
    print(f"ssd_bwd main shape {shape} bf16: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s counted, {nbytes / ms / 1e6:.1f}"
          f" GB/s), plain {plain_ms:.3f} ms, autograd through ssd_chunked at "
          f"chunk 128 (recomputed) {library_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); scratch {8 * n_cum / 1e6:.1f} MB cum + "
          f"{4 * n_work / 1e6:.1f} MB states, dH and partials")
    for name, k_ms in split.items():
        print(f"  ssd_bwd split: {k_ms:.4f} ms ({100 * k_ms / ms:.1f}% of "
              f"the event-timed call)  {name[:90]}")
    print(f"  ssd_bwd split: {sum(split.values()):.4f} ms in {len(split)} "
          "kernels (torch.profiler, device time a call)")
    return {"shape": list(shape), "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "autograd through ssd_chunked at chunk 128",
            "split_ms": split}


def ssd_bwd_entry(at: dict) -> dict:
    """The SSD backward's line: mamba2-130m's training shape's numbers."""
    return {"name": "ssd_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
            "replaces": "src/repro/kernels/ssd_pallas.py:114",
            "launches": None,
            **{k: v for k, v in at["mamba_train"].items() if k != "shape"},
            "at": at}


def _ssd_grad_case(rng, shape, chunk, dtype, A=None) -> float:
    """Worst per-leaf gradient error of ops.ssd_scan on CUDA tensors
    against autograd through the sequential oracle; every gradient must
    be finite."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_reference
    leaves = [t.detach().requires_grad_()
              for t in _ssd_inputs(rng, *shape, dtype, A=A)]
    g = _randn(rng, shape[:4], torch.float32)
    y = ops.ssd_scan(*leaves, chunk=chunk)
    check("SSDScan" in type(y.grad_fn).__name__,
          f"CUDA SSD output has grad_fn {y.grad_fn}")
    got = torch.autograd.grad((y.float() * g).sum(), leaves)
    want = torch.autograd.grad((ssd_reference(*leaves).float() * g).sum(),
                               leaves)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        check(bool(torch.isfinite(a).all()), f"d{name} not finite at "
              f"{shape} chunk {chunk} {dtype}")
        err = ((a.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        check(err <= SSD_GRAD_TOL[dtype], f"d{name} {shape} chunk {chunk} "
              f"{dtype}: {err:.3e} > {SSD_GRAD_TOL[dtype]}")
    return worst


def phase_ssd_grads(rng) -> None:
    print("SSD gradients: ops.ssd_scan (the forward and backward "
          "kernels) vs autograd through ssd_reference (max |dg| / max|g| "
          f"per leaf, f32 tol {SSD_GRAD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{SSD_GRAD_TOL[torch.bfloat16]:.0e})")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape, chunk in SSD_GRAD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            worst[dtype] = max(worst[dtype],
                               _ssd_grad_case(rng, shape, chunk, dtype))
    print(f"  worst: f32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e} over {2 * len(SSD_GRAD_SWEEP)} cases")
    # ROADMAP C3: chunk 128 at the model's init (A_log = 0, so A = -1),
    # where the JAX package's chunked gradients are NaN
    err = _ssd_grad_case(rng, (1, 256, 2, 8, 16), 128, torch.float32, A=-1.0)
    print(f"  C3 case (1, 256, 2, 8, 16) chunk 128 A=-1 f32: all gradients "
          f"finite, worst {err:.3e}")
    # and at the kernels' own 64-token chunk: A = -4, so cum passes 88.7
    # inside one chunk and exp(cum_i - cum_j) above the diagonal would
    # overflow
    err = _ssd_grad_case(rng, (1, 200, 2, 8, 16), 64, torch.float32, A=-4.0)
    print(f"  C3 case (1, 200, 2, 8, 16) A=-4 f32: all gradients finite, "
          f"worst {err:.3e}")


def phase_mamba_train() -> int:
    """mamba2-130m's training entry point at full width; returns SSD
    launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_mod.run(MAMBA, steps=TRAIN_STEPS, batch=MAMBA_B,
                        seq=MAMBA_S, dtype="bfloat16", device="cuda", seed=0,
                        log_every=1)
    flash, kl, launches = read_counts()
    note_bwd("mamba_train")
    bwd_launches = read_ssd_bwd()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(run.summary())
    print(f"train {MAMBA} peak device memory {peak:.2f} GiB; loop "
          f"{run.seconds:.2f} s; {run.n_params / 1e6:.1f}M parameters")
    res, cfg = run.result, run.cfg
    check(_finite(res.losses) and _finite(res.grad_norms),
          f"non-finite loss or grad norm: {res.losses}, {res.grad_norms}")
    want = TRAIN_STEPS * cfg.num_layers * 2
    check(launches == run.ssd_launches == want,
          f"SSD launched {launches} times in training, expected steps x "
          f"layers x 2 = {want}")
    check(bwd_launches == TRAIN_STEPS * cfg.num_layers,
          f"the SSD backward launched {bwd_launches} times in training, "
          f"expected steps x layers = {TRAIN_STEPS * cfg.num_layers}")
    check(flash == kl == 0, "training mamba launched flash or distill_kl")
    changed = _changed_leaves(res.params,
                              build_model(cfg, device="cuda", seed=0)
                              .param_tree())
    print(f"train {MAMBA}: {sum(changed.values())} of {len(changed)} "
          f"parameter leaves changed")
    check(all(changed.values()), "parameters that did not change: "
          f"{[k for k, v in changed.items() if not v]}")
    return launches


def phase_mamba_serve(rng) -> int:
    """mamba2-130m's serving entry point at full width (counted), then the
    same batch warm; returns SSD launches."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve_mod.serve(MAMBA, batch=MAMBA_B, prompt_len=MAMBA_S, gen=32,
                          dtype="bfloat16", device="cuda", seed=0)
    flash, kl, launches = read_counts()
    note_bwd("mamba_serve")
    cfg = res.cfg
    print(res.summary())
    print(f"serve {MAMBA} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res.prefill_ssd_launches == launches == cfg.num_layers,
          f"prefill launched SSD {res.prefill_ssd_launches} times, "
          f"expected {cfg.num_layers}")
    check(res.decode_ssd_launches == 0 and flash == kl == 0,
          "decode launched the SSD kernel, or serving launched another")
    check(res.logits_finite, "non-finite logits")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "generated token outside the vocabulary")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAMBA_B, MAMBA_S))).cuda()
    serve_mod.generate(model, prompts, 2)                      # warm-up
    print("warm " + serve_mod.generate(model, prompts, 32).summary())
    return launches


def phase_mamba_consistency(rng) -> None:
    """Prefill of S-2 tokens (a ragged last chunk) and 2 decode steps
    against forward, at full width, 4 layers, float32."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(MAMBA).replace(num_layers=4, dtype="float32")
    model = build_model(cfg, device="cuda", seed=1)
    B, S = 2, MAMBA_S
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    full = model({"tokens": tokens})
    logits, cache = model.prefill({"tokens": tokens[:, :S - 2]},
                                  extra_cache=2)
    errs = [(logits - full[:, S - 3]).abs().max().item()]
    for pos in (S - 2, S - 1):
        logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
        errs.append((logits - full[:, pos]).abs().max().item())
    scale = full.abs().max().item()
    # float32 with TF32 off: the kernel's chunked sums and decode's
    # recurrence add the same terms in other orders; 1e-3 is far above
    # that and far below what a wrong state, decay or conv window moves
    tol = 1e-3
    print(f"consistency {cfg.name} d_model={cfg.d_model} layers=4 f32, "
          f"S={S}: prefill/decode vs forward max|diff| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; max "
          f"|logit| {scale:.2f})")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")


def phase_mamba_grad_consistency(rng) -> None:
    """One mamba2-130m train step's gradients at full width (2 layers,
    float32) on the kernel against the same step on CPU copies, at chunk
    128 from the model's init (A = -1): ROADMAP C3's case."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    cfg = get_config(MAMBA).replace(num_layers=2, dtype="float32")
    # every leaf in float32 (norm scales are bf16 by spec)
    init = tree_map(lambda p: p.detach().float(),
                    build_model(cfg, device="cuda", seed=0).param_tree())
    B, S = 2, 256
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(
                 (rng.random((B, S)) < 0.9).astype(np.float32))}

    def grads(device):
        ps = tree_map(lambda p: p.to(device).requires_grad_(), init)
        model = build_model(cfg, ps, device=device)
        loss, _ = model.loss({k: v.to(device) for k, v in batch.items()},
                             params=ps)
        return loss, torch.autograd.grad(loss, tree_leaves(ps))

    reset_counts()
    loss_g, g_gpu = grads("cuda")
    launches = read_counts()
    check(launches == (0, 0, cfg.num_layers * 2),
          f"the CUDA step launched (flash, KL, SSD) = {launches}")
    loss_c, g_cpu = grads("cpu")
    check(read_counts() == launches, "the CPU step launched a kernel")
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu),
          "non-finite gradient on the card")
    rel = grad_rel_err(g_gpu, g_cpu)
    # float32 with TF32 off on both; the card's forward is the kernel's
    # 64-token chunks, the CPU's ssd_chunked at 128: 1e-3 relative per
    # leaf is far above their rounding and far below a wrong term
    tol = 1e-3
    print(f"gradient consistency {cfg.name} 2 layers f32 B={B} S={S}: loss "
          f"{loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU); max "
          f"per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
          f"{len(g_cpu)} leaves, all finite")
    check(abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()),
          "mamba loss differs between the card and the CPU")
    check(rel <= tol, "mamba gradients differ between the card and the CPU")


# --------------------------------------------------------------------------- #
# The MoE family: mixtral-8x22b serving and moonshot-v1-16b-a3b training
# --------------------------------------------------------------------------- #
# mixtral-8x22b at its full width (d_model 6144, 48 heads, 8 KV heads of
# 128, 8 experts of d_ff 16384, top-2, window 4096, vocab 32768), its depth
# cut to 8 of 56 layers: 20.4 B parameters, 38.1 GiB in bf16
MIXTRAL = "mixtral-8x22b"
MIXTRAL_LAYERS = 8
MIXTRAL_B, MIXTRAL_S, MIXTRAL_GEN = 2, 8192, 32
MIXTRAL_WINDOW = 4096
MIXTRAL_ATTN = (MIXTRAL_B, MIXTRAL_S, MIXTRAL_S, 48, 8, 128)
# the plain flash version over 1024 query rows at a time at that shape:
# its [2, 48, 8192, 8192] float32 scores are 25.8 GB
PLAIN_ROWS = 1024
# prefill + decode against forward: a prompt past the window, so that the
# 4096-slot rolling cache wraps, and 4 decoded tokens
MIXTRAL_CONS_S, MIXTRAL_CONS_GEN = 4352, 4
# moonshot-v1-16b-a3b at its full width (d_model 2048, 16 heads of 128,
# 64 experts of d_ff 1408, top-6, vocab 163840), its depth cut to 4 of 48
# layers: 2.95 B parameters, about 16 bytes each of training state
MOONSHOT = "moonshot-v1-16b-a3b"
MOONSHOT_LAYERS = 4
MOONSHOT_B, MOONSHOT_S, MOONSHOT_MBS, MOONSHOT_STEPS = 4, 2048, 2, 3
MOONSHOT_ATTN = (MOONSHOT_B, MOONSHOT_S, MOONSHOT_S, 16, 16, 128)
MOONSHOT_MB_ATTN = (MOONSHOT_MBS, MOONSHOT_S, MOONSHOT_S, 16, 16, 128)
# the MoE layer's profiler ranges (models/moe.py) and the autograd nodes of
# its backward: the expert products' (bmm), the dispatch's (index_put) and
# the combine's (index_select)
MOE_RANGES = (("routing", "moe.route"), ("dispatch", "moe.dispatch"),
              ("expert products", "moe.experts"), ("combine", "moe.combine"),
              ("expert products' backward",
               "evaluate_function: BmmBackward0"),
              ("dispatch backward", "evaluate_function: IndexPutBackward0"),
              ("combine backward", "evaluate_function: IndexSelectBackward0"))


@contextlib.contextmanager
def recorded_routes():
    """The expert indices [B, S, K] of every ``moe.route`` call inside the
    block, in call order, on the host."""
    from repro_torch.models import moe as moem
    seen, route = [], moem.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[2].detach().cpu())
        return out

    moem.route = spy
    try:
        yield seen
    finally:
        moem.route = route


def serving_route_flips(fwd_routes, routes, prompt: int, positions):
    """(MoE layer, tokens) of each MoE call of a prefill over the first
    ``prompt`` tokens and of one decode step at each of ``positions``
    whose expert indices differ from the forward's at the same tokens (a
    tie flip); None when the number of calls differs."""
    n = len(fwd_routes)
    want = [r[:, :prompt] for r in fwd_routes] + [
        r[:, pos:pos + 1] for pos in positions for r in fwd_routes]
    if len(routes) != len(want):
        return None
    return [(i % n, int((a != b).any(-1).sum())) for i, (a, b) in
            enumerate(zip(routes, want)) if not torch.equal(a, b)]


@contextlib.contextmanager
def scaled_gates(router: torch.Tensor, factor: float):
    """A planted fault: inside the block the top-k gates of the one MoE
    layer whose router is ``router`` (the stacked tree's first layer: its
    per-layer view shares the data pointer) are scaled by ``factor``, a
    wrong combine scale in that layer."""
    from repro_torch.models import moe as moem
    route = moem.route

    def planted(p, x, cfg):
        logits, gates, idx = route(p, x, cfg)
        if p["router"].data_ptr() == router.data_ptr():
            gates = gates * factor
        return logits, gates, idx

    moem.route = planted
    try:
        yield
    finally:
        moem.route = route


def _moe_report(prof, what: str) -> None:
    """Device time under the MoE layer's ranges and its backward's nodes
    (ranges nest: under remat the forward's ranges also run inside the
    backward's nodes)."""
    per = _range_ms(prof, MOE_RANGES)
    check(per.get("expert products", 0.0) > 0,
          f"the profiler saw no device time under moe.experts in {what}")
    for label, ms in per.items():
        print(f"  {ms:8.2f} ms  MoE {label} (device time under its range)")


def phase_moe_serve(rng) -> int:
    """mixtral-8x22b serving through ``launch.serve.generate`` at full width
    (8 layers, bf16, batch 2 x prompt 8192 x 32 tokens; the counted run),
    then the same batch warm, then a warm prefill and 8 decode steps
    traced; returns flash launches of the counted run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    cfg = get_config(MIXTRAL).replace(num_layers=MIXTRAL_LAYERS,
                                      dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    leaves = tree_leaves(model.param_tree())
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"serve {cfg.name}: {cfg.num_layers} of 56 layers at full width, "
          f"{n_params / 1e9:.3f} B parameters ({n_bytes / 2**30:.2f} GiB), "
          f"built in {time.perf_counter() - t0:.1f} s")
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MIXTRAL_B, MIXTRAL_S))).cuda()
    reset_counts()
    res = serve_mod.generate(model, prompts, MIXTRAL_GEN)
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("moe_serve")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("cold " + res.summary())
    print(f"serve {cfg.name} peak device memory {peak:.2f} GiB")
    check(res.prefill_launches == launches == cfg.num_layers,
          f"prefill launched flash {res.prefill_launches} times, expected "
          f"{cfg.num_layers}")
    check(res.decode_launches == 0 and kl_launches == ssd_launches == 0,
          "decode launched flash, or serving launched another kernel")
    check(res.logits_finite, "non-finite logits")
    check(tuple(res.tokens.shape) == (MIXTRAL_B, MIXTRAL_GEN)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"generated tokens {res.tokens.shape} outside the vocabulary")
    print("warm " + serve_mod.generate(model, prompts, MIXTRAL_GEN).summary())
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts}, extra_cache=9)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm prefill ({cfg.name})")
    _moe_report(prof, "prefill")
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            logits, cache = model.decode(cache, tok, MIXTRAL_S + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"8 warm decode steps ({cfg.name})")
    _moe_report(prof, "decode")
    return launches


def phase_moe_consistency(rng) -> None:
    """mixtral-8x22b at full width (4 layers, float32, no-drop capacity
    E / K = 4): prefill of 4352 tokens and 4 decode steps, the rolling
    4096-slot cache wrapping, against ``forward``; every MoE call's routing
    first, then the logits."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config(MIXTRAL)
    cfg = base.replace(num_layers=4, dtype="float32",
                       capacity_factor=base.num_experts
                       / base.experts_per_token)
    model = build_model(cfg, device="cuda", seed=1)
    S, n = MIXTRAL_CONS_S, MIXTRAL_CONS_GEN
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, S + n))).cuda()
    with recorded_routes() as fwd_routes:
        full = model({"tokens": tokens})

    def errors():
        """max |logits - forward's| after the prefill and each decode."""
        logits, cache = model.prefill({"tokens": tokens[:, :S]},
                                      extra_cache=n)
        check(cache["sub0"]["k"].shape[2] == cfg.sliding_window,
              f"cache of {cache['sub0']['k'].shape[2]} slots")
        errs = [(logits - full[:, S - 1]).abs().max().item()]
        for pos in range(S, S + n):
            logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
            errs.append((logits - full[:, pos]).abs().max().item())
        return errs

    with recorded_routes() as routes:
        errs = errors()
    L = cfg.num_layers
    flips = serving_route_flips(fwd_routes, routes, S, range(S, S + n))
    check(flips == [], f"routing differs between forward and "
          f"prefill/decode (a tie flip): (layer, tokens) {flips}")
    scale = full.abs().max().item()
    # float32 with TF32 off: as phase_consistency, sums over d_model 6144
    # and d_ff 16384 in other orders; the planted fault below must fail it.
    # H100 80GB HBM3 at 700 W: 1.57e-5-2.23e-5, layer 0's gates * 0.99
    # 4.29e-2
    tol = 1e-3
    first = model.param_tree()["layers"]["sub0"]["moe"]["router"]
    with scaled_gates(first, 0.99):
        planted = max(errors())
    print(f"consistency {cfg.name} d_model={cfg.d_model} layers={L} f32, "
          f"capacity factor {cfg.capacity_factor}, S={S}+{n} (cache "
          f"{cfg.sliding_window} slots): routes equal in {len(routes)} MoE "
          f"calls; prefill/decode vs forward max|diff| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; max "
          f"|logit| {scale:.2f}); planted gates*0.99 in layer 0 "
          f"{planted:.2e}")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")
    check(planted > tol, f"the limit {tol:.0e} passes prefill + decode "
          f"with layer 0's gates scaled by 0.99 ({planted:.2e})")


def phase_moe_train() -> int:
    """moonshot-v1-16b-a3b training through ``train.step.build_train_step``
    at full width (4 layers, bf16, batch 4 x 2048 in microbatches of 2, lr
    1e-4, 3 steps on ``lm_batches`` seed 0), then one warm step traced;
    returns flash launches of the 3 steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.train import step as step_mod
    cfg = get_config(MOONSHOT).replace(num_layers=MOONSHOT_LAYERS,
                                       dtype="bfloat16")
    B, S = MOONSHOT_B, MOONSHOT_S
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, device="cuda", seed=0).param_tree()
    # the step differentiates the tree it is given and returns a new one; a
    # model holding the first weights would keep 5.9 GB of them alive
    # through training, so the model the step calls holds meta tensors of
    # their shapes
    model = build_model(cfg, tree_map(
        lambda x: torch.empty_like(x, device="meta"), params))
    init = _host(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    step = step_mod.build_train_step(
        model, ParallelConfig(mbs=MOONSHOT_MBS),
        ShapeConfig("train", "train", S, B),
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    opt = adamw.init(params)
    batches = lm_batches(batch=B, seq_len=S, vocab=cfg.vocab_size, seed=0,
                         device="cuda")
    times, mets = [], []
    reset_counts()
    for i in range(MOONSHOT_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch, i)
        met = {k: float(v) for k, v in met.items()}
        times.append(time.perf_counter() - t0)
        mets.append(met)
        print(f"train {cfg.name} step {i}: loss {met['loss']:.4f} ce "
              f"{met['ce']:.4f} aux {met['aux']:.4f} gnorm "
              f"{met['grad_norm']:.3f} {times[-1] * 1e3:.1f} ms")
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("moe_train")
    peak, retries = _peak()
    warm = float(np.mean(times[1:]))
    print(f"train {cfg.name}: {cfg.num_layers} of 48 layers at full width, "
          f"{n_params / 1e9:.3f} B parameters, batch {B} x {S} in "
          f"microbatches of {MOONSHOT_MBS}, bf16: cold {times[0] * 1e3:.1f} "
          f"ms, warm {warm * 1e3:.1f} ms/step ({B * S / warm:.0f} tok/s); "
          f"peak device memory {peak:.2f} GiB, {retries} allocator retries")
    for met in mets:
        check(_finite([met["loss"], met["grad_norm"], met["aux"]]),
              f"non-finite metrics {met}")
        check(met["aux"] > 0, f"MoE aux loss {met['aux']} not positive")
    # remat: each layer's forward once and again in the backward, per
    # microbatch
    want = MOONSHOT_STEPS * cfg.num_layers * 2 * (B // MOONSHOT_MBS)
    check(launches == want, f"flash launched {launches} times, expected "
          f"steps x layers x 2 x microbatches = {want}")
    check(kl_launches == ssd_launches == 0,
          "training moonshot launched the distill_kl or the SSD kernel")
    changed = {path: bool((x.detach().cpu() != x0).any()) for (path, x), x0
               in zip(_named_leaves(params), tree_leaves(init))}
    print(f"train {cfg.name}: {sum(changed.values())} of {len(changed)} "
          f"parameter leaves changed")
    names = ("embed", "unembed", "wq", "wk", "wv", "wo", "router", "w_gate",
             "w_up", "w_down")
    for path, moved in changed.items():
        if path.rsplit("/", 1)[-1] in names:
            check(moved, f"parameter {path} did not change in training")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(batches), MOONSHOT_STEPS)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm train step ({cfg.name})")
    _moe_report(prof, "a train step")
    return launches


def phase_moe_grad_consistency(rng) -> None:
    """One moonshot-v1-16b-a3b loss's gradients (float32, TF32 off) on the
    card against the same on CPU copies, at the reduced config and at full
    width with 2 layers: every MoE call's routing first (a difference there
    is a tie flip, reported as one), then the loss and each leaf's
    gradient."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    for cfg in (get_reduced(MOONSHOT).replace(dtype="float32"),
                get_config(MOONSHOT).replace(num_layers=2, dtype="float32")):
        # every leaf in float32 (norm scales are bf16 by spec)
        init = tree_map(lambda p: p.detach().float(),
                        build_model(cfg, device="cuda", seed=0).param_tree())
        B, S = 2, 64
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:]),
                 "loss_mask": torch.from_numpy(
                     (rng.random((B, S)) < 0.9).astype(np.float32))}

        def grads(device, plant=False):
            ps = tree_map(lambda p: p.to(device).requires_grad_(), init)
            model = build_model(cfg, ps, device=device)
            first = ps["layers"]["sub0"]["moe"]["router"]
            with (scaled_gates(first, 0.99) if plant
                  else contextlib.nullcontext()), \
                    recorded_routes() as routes:
                loss, met = model.loss(
                    {k: v.to(device) for k, v in batch.items()}, params=ps)
                g = torch.autograd.grad(loss, tree_leaves(ps))
            return loss, met, g, routes

        reset_counts()
        loss_g, met_g, g_gpu, r_gpu = grads("cuda")
        launches = read_counts()
        check(launches == (cfg.num_layers * 2, 0, 0),
              f"the CUDA step launched (flash, KL, SSD) = {launches}")
        loss_c, met_c, g_cpu, r_cpu = grads("cpu")
        check(read_counts() == launches, "the CPU step launched a kernel")
        flips = [(i, int((a != b).any(-1).sum()))
                 for i, (a, b) in enumerate(zip(r_gpu, r_cpu))
                 if not torch.equal(a, b)]
        check(len(r_gpu) == len(r_cpu) == 2 * cfg.num_layers and not flips,
              f"{cfg.name} d_model {cfg.d_model}: routing differs between "
              f"the card and the CPU (a tie flip): (call, tokens) {flips}")
        check(all(bool(torch.isfinite(g).all()) for g in g_gpu),
              "non-finite gradient on the card")
        rel = grad_rel_err(g_gpu, g_cpu)
        planted = grad_rel_err(grads("cuda", plant=True)[2], g_cpu)
        # float32 with TF32 off on both, the same routes: sums in other
        # orders over d_model and the vocabulary, about 100 times below
        # this; the planted fault, layer 0's gates scaled by 0.99, must
        # fail it.  H100 80GB HBM3 at 700 W, reduced and full width:
        # 1.289e-6 and 3.125e-6, planted 2.019e-1 and 1.158e-2
        tol = 3e-4
        print(f"gradient consistency {cfg.name} d_model={cfg.d_model} "
              f"{cfg.num_experts} experts top-{cfg.experts_per_token} "
              f"{cfg.num_layers} layers f32 B={B} S={S}: routes equal in "
              f"{len(r_gpu)} MoE calls; loss {loss_g.item():.6f} (CUDA) vs "
              f"{loss_c.item():.6f} (CPU), aux {met_g['aux'].item():.6f} vs "
              f"{met_c['aux'].item():.6f}; max per-leaf |dg| / max|g| "
              f"{rel:.3e} (tol {tol:.0e}) over {len(g_cpu)} leaves; "
              f"planted gates*0.99 in layer 0 {planted:.3e}")
        check(abs(loss_g.item() - loss_c.item())
              <= 1e-4 * abs(loss_c.item()),
              "moonshot loss differs between the card and the CPU")
        check(rel <= tol, "moonshot gradients differ between the card and "
              "the CPU")
        check(planted > tol, f"the gradient limit {tol:.0e} passes layer "
              f"0's gates scaled by 0.99 ({planted:.3e})")
        del init, g_gpu, g_cpu
        free()


# --------------------------------------------------------------------------- #
# The last two families: whisper-small (audio) and jamba-v0.1-52b (hybrid)
# --------------------------------------------------------------------------- #
# whisper-small at full width and depth (12 encoder and 12 decoder layers,
# d_model 768, 12 heads of 64, d_ff 3072 GELU, LayerNorm, vocab 51865,
# untied): 1500 frame embeddings of 768 (the stubbed frontend's), 448 text
# tokens (Whisper's text context), batch 32 in microbatches of 16
WHISPER = "whisper-small"
WHISPER_B, WHISPER_S, WHISPER_MBS, WHISPER_STEPS = 32, 448, 16, 4
WHISPER_F = 1500
WHISPER_ENC_ATTN = (WHISPER_MBS, WHISPER_F, WHISPER_F, 12, 12, 64)
WHISPER_SELF_ATTN = (WHISPER_MBS, WHISPER_S, WHISPER_S, 12, 12, 64)
WHISPER_CROSS_ATTN = (WHISPER_MBS, WHISPER_S, WHISPER_F, 12, 12, 64)
WHISPER_SERVE_B, WHISPER_PROMPT, WHISPER_GEN = 16, 64, 64
WHISPER_PREFILL_CROSS = (WHISPER_SERVE_B, WHISPER_PROMPT, WHISPER_F, 12, 12,
                         64)
# jamba-v0.1-52b at its full width (d_model 4096, 32 heads, 8 KV heads of
# 128, d_ff 14336, 16 experts top-2 on every second layer, attention at
# offset 4 of each period of 8, Mamba-2 with d_state 16, heads of 64,
# expand 2; vocab 65536), its depth cut to one period, 8 of 32 layers: 1
# attention, 7 Mamba-2 and 4 MoE layers, 13.27 B parameters
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
JAMBA_B, JAMBA_S, JAMBA_GEN = 2, 16384, 32
JAMBA_ATTN = (JAMBA_B, JAMBA_S, JAMBA_S, 32, 8, 128)
# prefill + decode against forward at full width: B = 1, S = 512, 8 layers
# in float32 (53 GB of weights)
JAMBA_CONS_B, JAMBA_CONS_S = 1, 512


def whisper_flash(cfg) -> int:
    """Flash launches of one whisper forward: the encoder's self-attention,
    the decoder's self- and cross-attention, one a layer each."""
    return cfg.encoder_layers + 2 * cfg.num_layers


@contextlib.contextmanager
def scaled_first_layer(w: torch.Tensor, factor: float):
    """A planted fault: inside the block layer 0's slice of the stacked
    leaf ``w`` is scaled by ``factor`` in place."""
    keep = w[0].detach().clone()
    with torch.no_grad():
        w[0].mul_(factor)
    try:
        yield
    finally:
        with torch.no_grad():
            w[0].copy_(keep)


def _audio_batch(rng, cfg, B, S, device="cuda"):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
            "labels": torch.from_numpy(toks[:, 1:]).to(device),
            "loss_mask": torch.from_numpy(
                (rng.random((B, S)) < 0.9).astype(np.float32)).to(device),
            "frames": _randn(rng, (B, cfg.frontend_frames, cfg.frontend_dim),
                             torch.float32, device)}


def whisper_train_setup():
    """(cfg, model, step, batches): whisper-small's training at batch
    WHISPER_B x WHISPER_S tokens over its frames, microbatches of
    WHISPER_MBS, bf16, lr 1e-4, through ``train.step.build_train_step`` fed
    by ``audio_batches(seed=0)`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import audio_batches
    from repro_torch.models.model import build_model
    from repro_torch.optim import schedules
    from repro_torch.train import step as step_mod
    cfg = get_config(WHISPER).replace(dtype="bfloat16")
    B, S = WHISPER_B, WHISPER_S
    model = build_model(cfg, device="cuda", seed=0)
    step = step_mod.build_train_step(
        model, ParallelConfig(mbs=WHISPER_MBS),
        ShapeConfig("train", "train", S, B),
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    batches = audio_batches(batch=B, seq_len=S, vocab=cfg.vocab_size,
                            frames=cfg.frontend_frames,
                            frame_dim=cfg.frontend_dim, seed=0,
                            device="cuda")
    return cfg, model, step, batches


def phase_whisper_train() -> int:
    """whisper-small training through ``train.step.build_train_step`` and
    ``train.loop.train`` fed by ``audio_batches`` (bf16, batch 32 x 448
    tokens and 1500 frames, microbatches of 16, lr 1e-4, 4 steps), then one
    warm step traced; returns flash launches of the 4 steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    B, S = WHISPER_B, WHISPER_S
    torch.cuda.reset_peak_memory_stats()
    cfg, model, step, batches = whisper_train_setup()
    params = model.param_tree()
    init = _host(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    reset_counts()
    res = loop.train(step, params=params, opt_state=adamw.init(params),
                     batches=batches, num_steps=WHISPER_STEPS, log_every=1,
                     log_fn=lambda m: print(f"train {cfg.name} {m}"))
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("whisper_train")
    peak, retries = _peak()
    times = res.step_times
    warm = float(np.mean(times[1:]))
    print(f"train {cfg.name}: {cfg.encoder_layers} + {cfg.num_layers} "
          f"layers at full width, {n_params / 1e6:.1f} M parameters, batch "
          f"{B} x {S} tokens and {cfg.frontend_frames} frames in "
          f"microbatches of {WHISPER_MBS}, bf16: cold {times[0] * 1e3:.1f} "
          f"ms, warm {warm * 1e3:.1f} ms/step ({B * S / warm:.0f} tok/s, "
          f"{B * cfg.frontend_frames / warm:.0f} frames/s); peak device "
          f"memory {peak:.2f} GiB, {retries} allocator retries")
    check(_finite(res.losses) and _finite(res.grad_norms),
          f"non-finite loss or grad norm: {res.losses}, {res.grad_norms}")
    # remat: each layer's forward once and again in the backward, per
    # microbatch; the encoder's attention, the decoder's self- and
    # cross-attention
    want = WHISPER_STEPS * (B // WHISPER_MBS) * 2 * whisper_flash(cfg)
    check(launches == want, f"flash launched {launches} times, expected "
          f"steps x microbatches x 2 x (enc + 2 dec) = {want}")
    check(kl_launches == ssd_launches == 0,
          "training whisper launched the distill_kl or the SSD kernel")
    changed = {path: bool((x.detach().cpu() != x0).any()) for (path, x), x0
               in zip(_named_leaves(res.params), tree_leaves(init))}
    print(f"train {cfg.name}: {sum(changed.values())} of {len(changed)} "
          f"parameter leaves changed")
    names = ("frontend_proj", "embed", "unembed", "wq", "wk", "wv", "wo",
             "w_in", "w_out")
    for path, moved in changed.items():
        if path.rsplit("/", 1)[-1] in names:
            check(moved, f"parameter {path} did not change in training")
    params, opt = res.params, res.opt_state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(batches), WHISPER_STEPS)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm train step ({cfg.name})")
    return launches


def phase_whisper_serve(rng) -> int:
    """whisper-small serving through ``launch.serve.generate`` with frames
    (bf16, batch 16, 1500 frames, prompt 64, 64 tokens; the counted run),
    then the same batch warm; returns flash launches of the counted run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    cfg = get_config(WHISPER).replace(dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    B = WHISPER_SERVE_B
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, WHISPER_PROMPT))).cuda()
    frames = _randn(rng, (B, cfg.frontend_frames, cfg.frontend_dim),
                    torch.bfloat16)
    reset_counts()
    res = serve_mod.generate(model, prompts, WHISPER_GEN, frames=frames)
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("whisper_serve")
    print("cold " + res.summary())
    print(f"serve {cfg.name} ({cfg.frontend_frames} frames) peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = whisper_flash(cfg)
    check(res.prefill_launches == launches == want,
          f"prefill launched flash {res.prefill_launches} times, expected "
          f"enc + 2 dec = {want}")
    check(res.decode_launches == 0 and kl_launches == ssd_launches == 0,
          "decode launched flash, or serving launched another kernel")
    check(res.logits_finite, "non-finite logits")
    check(tuple(res.tokens.shape) == (B, WHISPER_GEN)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"generated tokens {res.tokens.shape} outside the vocabulary")
    print("warm " + serve_mod.generate(model, prompts, WHISPER_GEN,
                                       frames=frames).summary())
    return launches


def phase_whisper_consistency(rng) -> None:
    """whisper-small at full width and depth in float32: prefill of S-2
    tokens (1500 frames) and 2 decode steps, the cross-attention decode
    over the cached encoder keys, against ``forward``; the same with layer
    0's cross-attention ``wk`` scaled by 0.99 during prefill and decode
    must fail."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(WHISPER).replace(dtype="float32")
    model = build_model(cfg, device="cuda", seed=1)
    B, S = 2, 130
    batch = _audio_batch(rng, cfg, B, S)
    tokens, frames = batch["tokens"], batch["frames"]
    full = model({"tokens": tokens, "frames": frames})

    def errors():
        logits, cache = model.prefill({"tokens": tokens[:, :S - 2],
                                       "frames": frames}, extra_cache=2)
        check(cache["cross"]["k"].shape[2] == cfg.frontend_frames
              and cache["self"]["k"].shape[2] == S,
              f"cache {cache['self']['k'].shape}, "
              f"{cache['cross']['k'].shape}")
        errs = [(logits - full[:, S - 3]).abs().max().item()]
        for pos in (S - 2, S - 1):
            logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
            errs.append((logits - full[:, pos]).abs().max().item())
        return errs

    reset_counts()
    errs = errors()
    check(read_counts() == (whisper_flash(cfg), 0, 0),
          f"prefill + 2 decode steps launched {read_counts()}")
    wk = model.param_tree()["dec_layers"]["cross_attn"]["wk"]
    with scaled_first_layer(wk, 0.99):
        planted = max(errors())
    scale = full.abs().max().item()
    # float32 with TF32 off: sums over d_model 768 and 1500 frames in other
    # orders, through 24 layers.  H100 80GB HBM3 at 700 W: 4.05e-6-5.96e-6,
    # and layer 0's cross-attention wk * 0.99 moves the logits 7.13e-4, which
    # the 1e-3 of the other consistency checks would pass
    tol = 1e-4
    print(f"consistency {cfg.name} {cfg.encoder_layers} + {cfg.num_layers} "
          f"layers f32, {cfg.frontend_frames} frames, S={S}: prefill/decode "
          f"vs forward max|diff| {', '.join(f'{e:.2e}' for e in errs)} (tol "
          f"{tol:.0e}; max |logit| {scale:.2f}); planted cross wk*0.99 in "
          f"layer 0 {planted:.2e}")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")
    check(planted > tol, f"the limit {tol:.0e} passes prefill + decode "
          f"with layer 0's cross-attention wk scaled by 0.99 ({planted:.2e})")


def phase_whisper_grad_consistency(rng) -> None:
    """One whisper-small loss's gradients (float32, TF32 off) on the card
    against the same on CPU copies, at the reduced config and at full width
    with 2 encoder and 2 decoder layers over 1500 frames; the card's with
    layer 0's cross-attention ``wk`` scaled by 0.99 must fail."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    for cfg in (get_reduced(WHISPER).replace(dtype="float32"),
                get_config(WHISPER).replace(num_layers=2, encoder_layers=2,
                                            dtype="float32")):
        # every leaf in float32 (norm scales are bf16 by spec)
        init = tree_map(lambda p: p.detach().float(),
                        build_model(cfg, device="cuda", seed=0).param_tree())
        B, S = 2, 64
        batch = _audio_batch(rng, cfg, B, S, device="cpu")

        def grads(device, plant=False):
            ps = tree_map(lambda p: p.to(device).requires_grad_(), init)
            model = build_model(cfg, ps, device=device)
            wk = ps["dec_layers"]["cross_attn"]["wk"]
            with (scaled_first_layer(wk, 0.99) if plant
                  else contextlib.nullcontext()):
                loss, _ = model.loss(
                    {k: v.to(device) for k, v in batch.items()}, params=ps)
                g = torch.autograd.grad(loss, tree_leaves(ps))
            return loss, g

        reset_counts()
        loss_g, g_gpu = grads("cuda")
        launches = read_counts()
        check(launches == (2 * whisper_flash(cfg), 0, 0),
              f"the CUDA step launched (flash, KL, SSD) = {launches}")
        loss_c, g_cpu = grads("cpu")
        check(read_counts() == launches, "the CPU step launched a kernel")
        check(all(bool(torch.isfinite(g).all()) for g in g_gpu),
              "non-finite gradient on the card")

        rel = grad_rel_err(g_gpu, g_cpu)
        planted = grad_rel_err(grads("cuda", plant=True)[1], g_cpu)
        # float32 with TF32 off on both: the kernel's blocks and the CPU's
        # plain attention sum in other orders over 1500 keys; 1e-3 relative
        # per leaf is far above that and far below a wrong term
        tol = 1e-3
        print(f"gradient consistency {cfg.name} d_model={cfg.d_model} "
              f"{cfg.encoder_layers} + {cfg.num_layers} layers f32 B={B} "
              f"S={S} frames={cfg.frontend_frames}: loss "
              f"{loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU); max "
              f"per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
              f"{len(g_cpu)} leaves; planted cross wk*0.99 in layer 0 "
              f"{planted:.3e}")
        check(abs(loss_g.item() - loss_c.item())
              <= 1e-4 * abs(loss_c.item()),
              "whisper loss differs between the card and the CPU")
        check(rel <= tol, "whisper gradients differ between the card and "
              "the CPU")
        check(planted > tol, f"the gradient limit {tol:.0e} passes layer "
              f"0's cross-attention wk scaled by 0.99 ({planted:.3e})")
        del init, g_gpu, g_cpu
        free()


def phase_jamba_serve(rng) -> tuple[int, int]:
    """jamba-v0.1-52b serving through ``launch.serve.generate`` at full width
    (8 layers, bf16, batch 2 x prompt 16384 x 32 tokens; the counted run),
    then the same batch warm, then a warm prefill and 8 decode steps traced;
    returns (flash, SSD) launches of the counted run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_kinds
    cfg = get_config(JAMBA).replace(num_layers=JAMBA_LAYERS,
                                    dtype="bfloat16")
    kinds = layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_mamba = len(kinds) - n_attn
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    leaves = tree_leaves(model.param_tree())
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"serve {cfg.name}: {cfg.num_layers} of 32 layers at full width "
          f"({n_attn} attention, {n_mamba} Mamba-2, "
          f"{sum(f == 'moe' for _, f in kinds)} MoE), "
          f"{n_params / 1e9:.3f} B parameters ({n_bytes / 2**30:.2f} GiB), "
          f"built in {time.perf_counter() - t0:.1f} s")
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (JAMBA_B, JAMBA_S))).cuda()
    reset_counts()
    res = serve_mod.generate(model, prompts, JAMBA_GEN)
    launches, kl_launches, ssd_launches = read_counts()
    note_bwd("jamba_serve")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("cold " + res.summary())
    print(f"serve {cfg.name} peak device memory {peak:.2f} GiB")
    check(res.prefill_launches == launches == n_attn
          and res.prefill_ssd_launches == ssd_launches == n_mamba,
          f"prefill launched flash {res.prefill_launches} and SSD "
          f"{res.prefill_ssd_launches} times, expected {n_attn} and "
          f"{n_mamba}")
    check(res.decode_launches == res.decode_ssd_launches == kl_launches == 0,
          "decode launched flash or SSD, or serving launched distill_kl")
    check(res.logits_finite, "non-finite logits")
    check(tuple(res.tokens.shape) == (JAMBA_B, JAMBA_GEN)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"generated tokens {res.tokens.shape} outside the vocabulary")
    print("warm " + serve_mod.generate(model, prompts, JAMBA_GEN).summary())
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts}, extra_cache=9)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm prefill ({cfg.name})")
    _moe_report(prof, "prefill")
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            logits, cache = model.decode(cache, tok, JAMBA_S + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"8 warm decode steps ({cfg.name})")
    _moe_report(prof, "decode")
    return launches, ssd_launches


def phase_jamba_consistency(rng) -> None:
    """jamba-v0.1-52b in float32 at no-drop capacity (E / K): prefill of
    S-2 tokens and 2 decode steps against ``forward``, every MoE call's
    routing first, then the logits; at the reduced config (B 2, S 130) and
    at full width with 8 layers (B 1, S 512); layer 0's gates scaled by
    0.99 during prefill and decode must fail it."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_kinds
    for base, B, S in ((get_reduced(JAMBA), 2, 130),
                       (get_config(JAMBA).replace(num_layers=JAMBA_LAYERS),
                        JAMBA_CONS_B, JAMBA_CONS_S)):
        cfg = base.replace(dtype="float32", capacity_factor=base.num_experts
                           / base.experts_per_token)
        model = build_model(cfg, device="cuda", seed=1)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S))).cuda()
        with recorded_routes() as fwd_routes:
            full = model({"tokens": tokens})

        def errors():
            logits, cache = model.prefill({"tokens": tokens[:, :S - 2]},
                                          extra_cache=2)
            errs = [(logits - full[:, S - 3]).abs().max().item()]
            for pos in (S - 2, S - 1):
                logits, cache = model.decode(cache, tokens[:, pos:pos + 1],
                                             pos)
                errs.append((logits - full[:, pos]).abs().max().item())
            return errs

        with recorded_routes() as routes:
            errs = errors()
        flips = serving_route_flips(fwd_routes, routes, S - 2,
                                    (S - 2, S - 1))
        check(len(fwd_routes) == sum(f == "moe" for _, f in layer_kinds(cfg))
              and flips == [], f"routing differs between forward and "
              f"prefill/decode (a tie flip): (MoE layer, tokens) {flips}")
        first = model.param_tree()["layers"]["sub1"]["moe"]["router"]
        with scaled_gates(first, 0.99):
            planted = max(errors())
        scale = full.abs().max().item()
        # float32 with TF32 off: the SSD kernel's chunks against the
        # decode recurrence, sums over d_model and d_ff in other orders
        tol = 1e-3
        print(f"consistency {cfg.name} d_model={cfg.d_model} "
              f"layers={cfg.num_layers} f32, capacity factor "
              f"{cfg.capacity_factor}, B={B} S={S}: routes equal in "
              f"{len(routes)} MoE calls; prefill/decode vs forward max|diff| "
              f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; max "
              f"|logit| {scale:.2f}); planted gates*0.99 in the first MoE "
              f"layer {planted:.2e}")
        check(max(errs) <= tol, "prefill + decode disagrees with forward")
        check(planted > tol, f"the limit {tol:.0e} passes prefill + decode "
              f"with the first MoE layer's gates scaled by 0.99 "
              f"({planted:.2e})")
        del model, full
        free()


def phase_jamba_grad_consistency(rng) -> None:
    """One reduced jamba loss's gradients (float32, TF32 off) on the card
    against the same on CPU copies: every MoE call's routing first, then
    the loss and each leaf's gradient; the card's with the first MoE
    layer's gates scaled by 0.99 must fail."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_kinds
    cfg = get_reduced(JAMBA).replace(dtype="float32")
    init = tree_map(lambda p: p.detach().float(),
                    build_model(cfg, device="cuda", seed=0).param_tree())
    B, S = 2, 130
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(
                 (rng.random((B, S)) < 0.9).astype(np.float32))}

    def grads(device, plant=False):
        ps = tree_map(lambda p: p.to(device).requires_grad_(), init)
        model = build_model(cfg, ps, device=device)
        first = ps["layers"]["sub1"]["moe"]["router"]
        with (scaled_gates(first, 0.99) if plant
              else contextlib.nullcontext()), recorded_routes() as routes:
            loss, met = model.loss(
                {k: v.to(device) for k, v in batch.items()}, params=ps)
            g = torch.autograd.grad(loss, tree_leaves(ps))
        return loss, met, g, routes

    reset_counts()
    loss_g, met_g, g_gpu, r_gpu = grads("cuda")
    launches = read_counts()
    kinds = layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    # remat: each sub-layer's forward and its recompute
    check(launches == (2 * n_attn, 0, 2 * (len(kinds) - n_attn)),
          f"the CUDA step launched (flash, KL, SSD) = {launches}")
    loss_c, met_c, g_cpu, r_cpu = grads("cpu")
    check(read_counts() == launches, "the CPU step launched a kernel")
    flips = [(i, int((a != b).any(-1).sum()))
             for i, (a, b) in enumerate(zip(r_gpu, r_cpu))
             if not torch.equal(a, b)]
    check(len(r_gpu) == len(r_cpu) == 2 * n_moe and not flips,
          f"routing differs between the card and the CPU (a tie flip): "
          f"(call, tokens) {flips}")
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu),
          "non-finite gradient on the card")

    rel = grad_rel_err(g_gpu, g_cpu)
    planted = grad_rel_err(grads("cuda", plant=True)[2], g_cpu)
    # float32 with TF32 off, the same routes: the card's SSD forward is the
    # kernel's 64-token chunks, the CPU's ssd_chunked at 128; 1e-3 relative
    # per leaf, as the mamba2-130m check
    tol = 1e-3
    print(f"gradient consistency {cfg.name} reduced (d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, {cfg.num_layers} layers) f32 B={B} "
          f"S={S}: routes equal in {len(r_gpu)} MoE calls; loss "
          f"{loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU), aux "
          f"{met_g['aux'].item():.6f} vs {met_c['aux'].item():.6f}; max "
          f"per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
          f"{len(g_cpu)} leaves; planted gates*0.99 {planted:.3e}")
    check(abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()),
          "jamba loss differs between the card and the CPU")
    check(rel <= tol, "jamba gradients differ between the card and the CPU")
    check(planted > tol, f"the gradient limit {tol:.0e} passes the first MoE "
          f"layer's gates scaled by 0.99 ({planted:.3e})")


# pipeline and tensor parallelism at world size 1 (phase_pp): the staged
# loss's micro-batches, its bf16 gradients accumulated in float32 against
# the whole batch's bf16 gradient, per leaf |g_pp - g| / max |g|;
# tests/drivers/driver_train_step_dist.py's float32 bounds (loss 1e-5,
# gradients 5e-4 absolute) on the float32 leaves of a float32 model (its
# norm scales are bf16 parameters, held to the bf16 rule); the staged loss
# against model.loss in bf16 within 1e-3 relative; the aux rebuilt from
# the router statistics within 1e-6 relative of moe's own
PP_BF16_GRAD_TOL = 2.0 ** -4
PP_F32_LOSS_TOL, PP_F32_GRAD_TOL = 1e-5, 5e-4
PP_BF16_LOSS_TOL = 1e-3
PP_AUX_TOL = 1e-6
PP_MICRO = 2
PP_F32_LAYERS = 4
PP_MOONSHOT_LAYERS = 2


def phase_pp(rng) -> int:
    """Pipeline and tensor parallelism on a one-rank NCCL group (see the
    module docstring, ``phase_pp``); returns the flash launches of the
    staged bf16 value-and-gradient at full depth."""
    import torch.distributed as dist
    from repro_torch.core.types import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models import moe as moem
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = shd.section_mesh([0], ParallelConfig())
        check(all(n == 1 for n in shd.mesh_shape(mesh).values()),
              "the mesh's axes")

        def lm_batch(cfg, B, S):
            t = rng.integers(0, cfg.vocab_size, (B, S + 1))
            return {"tokens": torch.from_numpy(t[:, :-1]).cuda(),
                    "labels": torch.from_numpy(t[:, 1:]).cuda(),
                    "loss_mask": torch.from_numpy(
                        (rng.random((B, S)) < 0.9).astype(np.float32)
                    ).cuda()}

        def plain(model, params, batch):
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            loss, _ = model.loss(batch, params=p)
            g = torch.autograd.grad(loss, tree_leaves(p))
            return loss.detach(), g

        def staged(loss_fn, params, batch):
            loss, g = loss_fn.value_and_grad(loss_fn.local(params), batch)
            return loss, tree_leaves(g)

        def leaf_gaps(ga, gb, names):
            """Per leaf max |a - b| / max |b|: the worst leaf's gap and
            name, and the NOISE_LEAVES' worst."""
            worst, name, noise = 0.0, "", 0.0
            for path, a, b in zip(names, ga, gb):
                gap = ((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30)).item()
                if path.rsplit("/", 1)[-1] in NOISE_LEAVES:
                    noise = max(noise, gap)
                elif gap > worst:
                    worst, name = gap, path
            return worst, name, noise

        # (1) qwen1.5-0.5b at full width and depth, bf16, 4 x 2048
        cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
        model = build_model(cfg, device="cuda", seed=0)
        params = model.param_tree()
        names = [p for p, _ in _named_leaves(params)]
        batch = lm_batch(cfg, TRAIN_B, TRAIN_S)
        loss_fn, info = pl.build_pp_loss(cfg, mesh, PP_MICRO,
                                         vocab_parallel=True)
        check(info["vocab_parallel"] and info["stages"] == 1,
              f"build_pp_loss info {info}")
        torch.cuda.synchronize()
        reset_counts()
        l_pp, g_pp = staged(loss_fn, params, batch)
        torch.cuda.synchronize()
        n_pp = read_counts()[0]
        note_bwd("pp")
        l_pl, g_pl = plain(model, params, batch)
        rel = abs(l_pp.item() - l_pl.item()) / abs(l_pl.item())
        gap, leaf, noise = leaf_gaps(g_pp, g_pl, names)
        want = PP_MICRO * cfg.num_layers * 2
        print(f"pp {TRAIN_ARCH} bf16 full depth {TRAIN_B} x {TRAIN_S}, "
              f"{PP_MICRO} micro-batches, vocab-parallel CE: loss "
              f"{l_pp.item():.6f} vs model.loss {l_pl.item():.6f} "
              f"(relative {rel:.3e}, tol {PP_BF16_LOSS_TOL:.0e}); worst leaf"
              f" max|g_pp - g| / max|g| {gap:.3e} ({leaf}; tol "
              f"{PP_BF16_GRAD_TOL:.3e}; {NOISE_LEAVES} {noise:.3e}); flash "
              f"launches {n_pp} (micro-batches x layers x 2 = {want})")
        check(rel <= PP_BF16_LOSS_TOL, f"the staged loss is {rel:.3e} off")
        check(gap <= PP_BF16_GRAD_TOL, f"the staged gradients differ by "
              f"{gap:.3e} at {leaf}")
        check(n_pp == want, f"flash launched {n_pp} times, expected {want}")
        del g_pp, g_pl
        # times: the staged value-and-gradient against the plain one, the
        # second call of each
        times = {}
        for which in ("staged", "plain", "staged", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (staged(loss_fn, params, batch) if which == "staged"
                   else plain(model, params, batch))
            torch.cuda.synchronize()
            times[which] = (time.perf_counter() - t0) * 1e3
            del out
        print(f"pp {TRAIN_ARCH} bf16 {TRAIN_B} x {TRAIN_S}: warm "
              f"value-and-gradient {times['staged']:.1f} ms staged "
              f"({PP_MICRO} micro-batches) vs {times['plain']:.1f} ms plain "
              f"on {card()}")
        # (3) the Megatron sub-layer with a one-rank model group, bit for
        # bit against the plain sub-layer, forward and backward
        tp = pl.TensorParallel(mesh.get_group(shd.AXIS_MODEL), 1, True, True)
        lp = tree_map(lambda x: x[0], params["layers"]["sub0"])
        x = torch.randn((2, 512, cfg.d_model), device="cuda",
                        dtype=torch.bfloat16)

        def sublayer(with_tp):
            p = tree_map(lambda t: t.detach().requires_grad_(), lp)
            xi = x.clone().requires_grad_()
            y, _ = tf._sublayer_fwd(p, xi, cfg, "attn", "mlp", None, True,
                                    False, tp if with_tp else None)
            g = torch.autograd.grad((y.float() ** 2).sum(),
                                    [xi] + tree_leaves(p))
            return [y] + list(g)
        same = all(torch.equal(a, b) for a, b in zip(sublayer(True),
                                                     sublayer(False)))
        print(f"pp: Megatron sub-layer ({TRAIN_ARCH} width, bf16) with a "
              f"one-rank model group equals the plain one bit for bit, "
              f"forward and backward: {same}")
        check(same, "the Megatron sub-layer at tp 1 differs from the plain")
        del model, params, loss_fn
        free()
        # (2) 4 layers in float32 against model.loss; a planted fault (every
        # micro-batch takes the first's rows) must fail
        cfg = get_config(TRAIN_ARCH).replace(num_layers=PP_F32_LAYERS,
                                             dtype="float32")
        model = build_model(cfg, device="cuda", seed=0)
        params = model.param_tree()
        names32 = [p for p, _ in _named_leaves(params)]
        batch = lm_batch(cfg, TRAIN_B, TRAIN_S)
        l_pl, g_pl = plain(model, params, batch)
        f32 = {}
        for planted in (False, True):
            layout = ((lambda b, t, m: pl.contiguous_microbatch(b, 0, m))
                      if planted else pl.contiguous_microbatch)
            fn, _ = pl.build_pp_loss(cfg, mesh, PP_MICRO,
                                     vocab_parallel=True, mb_layout=layout)
            l_pp, g_pp = staged(fn, params, batch)
            is32 = [b.dtype == torch.float32 for b in g_pl]
            f32[planted] = (
                abs(l_pp.item() - l_pl.item()),
                max((a - b).abs().max().item()
                    for a, b, w in zip(g_pp, g_pl, is32) if w),
                leaf_gaps([a for a, w in zip(g_pp, is32) if not w],
                          [b for b, w in zip(g_pl, is32) if not w],
                          [n for n, w in zip(names32, is32) if not w])[0])
        (dl, dg, dg16), (dl_bad, dg_bad, _) = f32[False], f32[True]
        print(f"pp {TRAIN_ARCH} {PP_F32_LAYERS} layers f32 {TRAIN_B} x "
              f"{TRAIN_S}: |dloss| {dl:.3e} (tol {PP_F32_LOSS_TOL:.0e}), "
              f"max |dg| over the float32 leaves {dg:.3e} (tol "
              f"{PP_F32_GRAD_TOL:.0e}), the bf16 norm scales' worst max|dg|"
              f" / max|g| {dg16:.3e} (tol {PP_BF16_GRAD_TOL:.3e}); planted "
              f"(every micro-batch the first's rows) {dl_bad:.3e} / "
              f"{dg_bad:.3e}")
        check(dl <= PP_F32_LOSS_TOL and dg <= PP_F32_GRAD_TOL
              and dg16 <= PP_BF16_GRAD_TOL,
              "the float32 staged loss or gradients are off")
        check(dl_bad > PP_F32_LOSS_TOL and dg_bad > PP_F32_GRAD_TOL,
              "the float32 bounds pass a planted micro-batch layout")
        del model, params, g_pl, g_pp
        free()
        # (4) moonshot-v1-16b-a3b at full width, 2 of its 48 layers, bf16
        cfg = resolve_config(MOONSHOT, dtype="bfloat16").replace(
            num_layers=PP_MOONSHOT_LAYERS)
        model = build_model(cfg, device="cuda", seed=0)
        params = model.param_tree()
        lp = tree_map(lambda x: x[0], params["layers"]["sub0"])
        h = torch.randn((MOONSHOT_MBS, MOONSHOT_S, cfg.d_model),
                        device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            _, aux, stats = moem.moe(lp["moe"], h, cfg, return_stats=True)
            rebuilt = tf.aux_from_stats(stats, cfg)
        aux_rel = abs(rebuilt.item() - aux.item()) / abs(aux.item())
        batch = lm_batch(cfg, MOONSHOT_B, MOONSHOT_S)
        fn, info = pl.build_pp_loss(cfg, mesh, PP_MICRO)
        with torch.no_grad():
            l_pp = fn(fn.local(params), batch)
            l_pl, met = model.loss(batch, params=params)
        rel = abs(l_pp.item() - l_pl.item()) / abs(l_pl.item())
        print(f"pp {MOONSHOT} {PP_MOONSHOT_LAYERS} layers bf16: aux from "
              f"router statistics {rebuilt.item():.7f} vs moe's "
              f"{aux.item():.7f} (relative {aux_rel:.3e}, tol "
              f"{PP_AUX_TOL:.0e}); staged loss ({PP_MICRO} micro-batches, "
              f"{info['moe_layers_per_stage']} MoE layers) "
              f"{l_pp.item():.6f} vs model.loss {l_pl.item():.6f} "
              f"(relative {rel:.3e}, tol {PP_BF16_LOSS_TOL:.0e}; aux "
              f"{float(met['aux']):.5f})")
        check(aux_rel <= PP_AUX_TOL, "the rebuilt aux differs")
        check(rel <= PP_BF16_LOSS_TOL, "the staged MoE loss differs")
        del model, params
    finally:
        dist.destroy_process_group()
    print(f"pp: phase {time.perf_counter() - t_phase:.1f} s")
    return n_pp


#: granite-3-8b's attention sub-layer at tp 16 (8 KV heads): each model
#: rank's share, 2 query heads on the one KV head of their group
TP_REPEAT = 16
TP_REPEAT_ATTN = (4, 2048, 2048, 2, 1, 128)
#: the 16 shares' summed output against the whole sub-layer's, and the
#: folded wk/wv gradients against autograd of it, each of the whole's
#: largest magnitude (bf16: 2^-5 is SHAPE_REL_TOL, 2e-2 GRAD_TOL's)
TP_REPEAT_TOL = SHAPE_REL_TOL
TP_REPEAT_GRAD_TOL = 2e-2


def phase_tp_repeat(rng) -> int:
    """Tensor parallelism past the KV heads at world size 1 (see the module
    docstring, item 15) -> flash launches of the 16 shares."""
    from repro_torch.configs import get_config
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention as att
    from repro_torch.models import common as cm
    cfg = get_config(ARCH)
    B, S, _, h, kv, hd = TP_REPEAT_ATTN
    tp, rep = TP_REPEAT, pl.kv_repeat(cfg, TP_REPEAT)
    check((cfg.num_heads // tp, rep, cfg.hd) == (h, tp // cfg.num_kv_heads,
                                                 hd) and kv == 1,
          f"{ARCH} at tp {tp}: {cfg.num_heads} heads, {cfg.num_kv_heads} KV "
          f"heads, repeat {rep}")
    specs = att.attn_specs(cfg)
    p = cm.init_params(specs, torch.Generator(device="cuda").manual_seed(7),
                       "cuda")
    x = _randn(rng, (B, S, cfg.d_model), torch.bfloat16)
    go = _randn(rng, (B, S, cfg.d_model), torch.bfloat16)

    def share(blocks):
        """A sub-layer's output and its wk/wv gradients under ``go``."""
        b = {k: v.detach().requires_grad_() for k, v in blocks.items()}
        o = att.attention(b, x, cfg)
        gk, gv = torch.autograd.grad(o, [b["wk"], b["wv"]], go)
        return o.detach(), gk, gv

    o_w, gk_w, gv_w = share(p)
    torch.cuda.synchronize()
    reset_counts()
    o_sum = torch.zeros(o_w.shape, dtype=torch.float32, device="cuda")
    gks, gvs = [], []
    for r in range(tp):
        blocks = pl.tp_rank_blocks(cfg, p, specs, tp, r)
        check(tuple(blocks["wq"].shape) == (cfg.d_model, h, hd)
              and tuple(blocks["wk"].shape) == (cfg.d_model, kv, hd),
              f"rank {r}'s blocks {[tuple(v.shape) for v in blocks.values()]}")
        o_r, gk, gv = share(blocks)
        o_sum += o_r.float()                  # the row-parallel all-reduce
        gks.append(gk.float())
        gvs.append(gv.float())
    torch.cuda.synchronize()
    launches = read_counts()[0]
    note_bwd("tp_repeat")
    print(f"tp-repeat: {ARCH} attention sub-layer, bf16, {B} x {S}, tp {tp}: "
          f"{tp} shares of {h} query heads on {kv} KV head (repeat {rep}), "
          f"flash launched {launches} times")
    check(launches >= tp, f"flash launched {launches} times for {tp} shares")
    top = o_w.float().abs().max().item()
    err = (o_sum - o_w.float()).abs().max().item() / top
    planted = (o_sum - o_r.float() - o_w.float()).abs().max().item() / top
    print(f"  summed output against the whole sub-layer: max|diff| / "
          f"max|o| {err:.3e} (limit {TP_REPEAT_TOL:.3e}); planted, one "
          f"share left out: {planted:.3e}")
    check(err <= TP_REPEAT_TOL, f"the {tp} shares' sum is off by {err:.3e}")
    check(planted > TP_REPEAT_TOL, "the limit passes a missing share")
    for name, parts, want in (("wk", gks, gk_w), ("wv", gvs, gv_w)):
        every = torch.cat(parts, dim=1)       # [d, tp, hd]: one KV head a rank
        folded = shd.fold_repeats(every, 1, rep)
        one = every.unflatten(1, (-1, rep)).select(2, 0)
        scale = want.float().abs().max().item()
        g_err = (folded - want.float()).abs().max().item() / scale
        g_planted = (one - want.float()).abs().max().item() / scale
        print(f"  {name} gradient summed over each KV head's {rep} ranks "
              f"against autograd of the whole: {g_err:.3e} of its largest "
              f"(limit {TP_REPEAT_GRAD_TOL:.1e}); planted, one copy: "
              f"{g_planted:.3e}")
        check(g_err <= TP_REPEAT_GRAD_TOL,
              f"the folded {name} gradient is off by {g_err:.3e}")
        check(g_planted > TP_REPEAT_GRAD_TOL,
              f"the {name} limit passes one copy's gradient")
    with torch.no_grad():
        whole_ms = time_ms(lambda: att.attention(p, x, cfg), iters=5)
        shares = [pl.tp_rank_blocks(cfg, p, specs, tp, r) for r in range(tp)]
        shares_ms = time_ms(lambda: [att.attention(b, x, cfg)
                                     for b in shares], iters=3, warmup=1)
    print(f"  forward: the whole sub-layer {whole_ms:.3f} ms, the {tp} "
          f"shares in turn {shares_ms:.3f} ms ({shares_ms / tp:.3f} ms a "
          f"rank) on {card()}")
    return launches


#: qwen1.5-0.5b's cross-entropy as the 8 model ranks of tp 8 compute it:
#: 151936 / 8 = 18992 vocabulary rows a rank
VP_TP = 8
#: bf16 limits: the loss relative to the whole cross-entropy's (each logit
#: is one bf16 matmul output on either side; a slice left out of the
#: log-sum-exp moves the loss by about log(8/7) / log(151936) = 1.1e-2),
#: and h's and each embed slice's gradient, of the whole's largest
#: magnitude (TP_REPEAT_GRAD_TOL's: the 8 parts of h's gradient are each
#: rounded to bf16 before the sum)
VP_LOSS_TOL = 1e-3
VP_GRAD_TOL = 2e-2


def phase_vocab_parallel(rng) -> int:
    """Vocab-parallel cross-entropy at world size 1 (see the module
    docstring, item 16) -> flash launches of the forward."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import pipeline as pl
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model
    cfg = get_config(TRAIN_ARCH)
    V, vs = cfg.padded_vocab, cfg.padded_vocab // VP_TP
    check(cfg.tie_embeddings and V % VP_TP == 0,
          f"{TRAIN_ARCH}: tied {cfg.tie_embeddings}, vocabulary {V}")
    model = build_model(cfg, device="cuda", seed=0)
    p = model.param_tree()
    t = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(t[:, :-1]).cuda(),
             "labels": torch.from_numpy(t[:, 1:]).cuda()}
    mask = torch.from_numpy((rng.random((TRAIN_B, TRAIN_S)) < 0.9)
                            .astype(np.float32)).cuda()
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        h, _ = tf.lm_forward(p, cfg, batch, remat=False, logits_out=False)
    torch.cuda.synchronize()
    launches = read_counts()[0]
    check(launches == cfg.num_layers,
          f"flash launched {launches} times in a {cfg.num_layers}-layer "
          "forward")
    note_bwd("vocab_parallel")
    labels = batch["labels"]
    embed = p["embed"].detach()

    def whole():
        """The whole-vocabulary CE and its h and embed gradients."""
        hh = h.detach().requires_grad_()
        w = embed.clone().requires_grad_()
        loss = cm.cross_entropy(tf.unembed({"embed": w}, cfg, hh), labels,
                                mask)
        gh, gw = torch.autograd.grad(loss, [hh, w])
        return loss.detach(), gh, gw

    def shares(planted: bool = False):
        """The CE as the VP_TP ranks compute it, their all-reduces done as
        sums and maxima over the slices here; ``planted``: slice 0 left
        out of the exponential sums."""
        def logits(r):
            hh = h.detach().requires_grad_()
            w = embed[r * vs:(r + 1) * vs].clone().requires_grad_()
            return hh, w, tf.unembed({"embed": w}, cfg, hh,
                                     offset=r * vs).float()
        with torch.no_grad():
            mx = torch.stack([pl.vocab_max(logits(r)[2])
                              for r in range(VP_TP)]).amax(0)
            se = gold = 0
            for r in range(VP_TP):
                _, sr, gr, _, _ = pl.vocab_partials(logits(r)[2], labels,
                                                    r * vs, mx)
                se = se + (0 if planted and r == 0 else sr)
                gold = gold + gr
            nll = pl.vocab_nll(mx, se, gold)
            loss = cm.masked_mean(nll, mask)
            g_nll = mask / mask.sum()
        gh, gws = 0, []
        for r in range(VP_TP):
            hh, w, lg = logits(r)
            ex, _, _, col, mine = pl.vocab_partials(lg, labels, r * vs, mx)
            g = pl.vocab_grad(ex, se, col, mine, g_nll)
            ghr, gw = torch.autograd.grad(lg, [hh, w], g)
            gh = gh + ghr.float()
            gws.append(gw)
            del ex, g, lg
        return loss, gh, gws

    loss_w, gh_w, gw_w = whole()
    res = {}
    for name, planted in (("shares", False), ("planted", True)):
        loss, gh, gws = shares(planted)
        d_loss = abs(loss.item() - loss_w.item()) / abs(loss_w.item())
        d_h = ((gh - gh_w.float()).abs().max()
               / gh_w.float().abs().max()).item()
        scale = gw_w.float().abs().max()
        d_w = max(((gw.float() - gw_w[r * vs:(r + 1) * vs].float()).abs()
                   .max() / scale).item() for r, gw in enumerate(gws))
        res[name] = (d_loss, d_h, d_w)
        print(f"vocab-parallel: {TRAIN_ARCH} bf16 {TRAIN_B} x {TRAIN_S}, "
              f"tp {VP_TP} slices of {vs} rows ({name}): loss "
              f"{loss.item():.6f} against the whole {loss_w.item():.6f} "
              f"(relative {d_loss:.3e}, limit {VP_LOSS_TOL:.0e}); h's "
              f"gradient {d_h:.3e} and the worst embed slice's {d_w:.3e} "
              f"of the whole's largest (limit {VP_GRAD_TOL:.0e})")
        del gh, gws
    d_loss, d_h, d_w = res["shares"]
    check(d_loss <= VP_LOSS_TOL and d_h <= VP_GRAD_TOL
          and d_w <= VP_GRAD_TOL, f"the {VP_TP} shares' CE is off by "
          f"{res['shares']}")
    check(not (res["planted"][0] <= VP_LOSS_TOL
               and res["planted"][1] <= VP_GRAD_TOL
               and res["planted"][2] <= VP_GRAD_TOL),
          "the limits pass a slice left out of the log-sum-exp")
    del gh_w, gw_w
    free()

    # one rank's share through vocab_parallel_nll on a one-rank group
    # against the whole cross-entropy: peak bytes above the inputs, ms
    def whole_ce():
        hh = h.detach().requires_grad_()
        w = embed.requires_grad_()
        loss = cm.cross_entropy(tf.unembed({"embed": w}, cfg, hh), labels,
                                mask)
        torch.autograd.grad(loss, [hh, w])

    def share_ce():
        hh = h.detach().requires_grad_()
        w = embed[:vs].detach().requires_grad_()
        lg = tf.unembed({"embed": w}, cfg, hh).float()
        loss = cm.masked_mean(pl.vocab_parallel_nll(lg, labels, 0, group),
                              mask)
        torch.autograd.grad(loss, [hh, w])

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        peaks, ms = {}, {}
        for name, fn in (("whole", whole_ce), ("share", share_ce)):
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
            ms[name] = time_ms(fn, iters=5)
    finally:
        dist.destroy_process_group()
    embed.requires_grad_(False)
    print(f"vocab-parallel: one rank's share of the CE (forward and "
          f"backward, {vs} of {V} rows) peaks {peaks['share'] / 1e9:.3f} GB "
          f"above its inputs and takes {ms['share']:.3f} ms; the whole "
          f"CE {peaks['whole'] / 1e9:.3f} GB and {ms['whole']:.3f} ms "
          f"({peaks['whole'] / peaks['share']:.2f}x the bytes) on {card()}")
    check(peaks["share"] < peaks["whole"] / 2,
          f"one share's CE peaks at {peaks['share']} bytes against the "
          f"whole's {peaks['whole']}")
    return launches


#: the production cells' records with each KV head repeated over its
#: query-head group, before the block-fed steps and the vocab-parallel
#: CE: (GB a rank, useful FLOPs share); PERF.md §6
PRODUCTION_BEFORE = {"production": (90.97, 0.569), "distill": (94.45, 0.617)}
DRYRUN_MEM_TOL = 0.15           # predicted peak bytes against the card's
DRYRUN_PROD_MBS = 16            # rows a micro-batch in the production cell
SERVE_GEN = 32
#: the dry-run cells phase_dryrun holds to the card or prints: (name,
#: REPRO_DRYRUN_MESH, arguments of launch.dryrun)
DRYRUN_CELLS = [
    ("train", "1,1,1,1", ["--arch", TRAIN_ARCH, "--shape", "train_4k",
                          "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                          "--mbs", "2"]),
    ("prefill", "1,1,1,1", ["--arch", ARCH, "--shape", "prefill_32k",
                            "--batch", str(PREFILL[0]),
                            "--seq", str(PREFILL[1]),
                            "--extra-cache", str(SERVE_GEN)]),
    ("production", None, ["--arch", ARCH, "--shape", "train_4k",
                          "--mbs", str(DRYRUN_PROD_MBS)])]


#: the compound dry-run cell phase_dryrun_compound holds to the card: the
#: distillation step of phase_distill on a one-rank mesh
DRYRUN_COMPOUND_CELL = ("distill_mesh", "1,1,1,1", [
    "--workload", "distill", "--teacher", TRAIN_ARCH, "--student",
    TRAIN_ARCH, "--seq", str(TRAIN_S), "--batch", str(TRAIN_B), "--mbs",
    str(TRAIN_B)])
#: the production compound cells on the 16 x 16 mesh (256 fake ranks),
#: recorded one after another in one background subprocess: (name, depth,
#: arguments of launch.dryrun_compound).  One micro-batch each (a 256-rank
#: cell replays every micro-batch's operations on the host); distillation
#: at full depth, MLLM and multi-teacher at phase_mllm's and
#: phase_multi_teacher's configurations
DRYRUN_COMPOUND_PRODUCTION = [
    ("distill", "granite-3-8b 40 + 40 layers (full depth)",
     ["--workload", "distill", "--mbs", "16"]),
    ("mllm", f"ViT {MLLM_VIT_LAYERS} of 24 layers, pixtral-12b "
     f"{MLLM_LM_LAYERS} of 40",
     ["--workload", "mllm", "--layers", str(MLLM_LM_LAYERS),
      "--vit-layers", str(MLLM_VIT_LAYERS), "--mbs", "256"]),
    ("multi_teacher", f"{TRAIN_ARCH} x 3, 24 layers each (full depth)",
     ["--workload", "multi_teacher", "--teacher", TRAIN_ARCH, "--teacher2",
      TRAIN_ARCH, "--student", TRAIN_ARCH, "--mbs", "256"])]
_COMPOUND_PRODUCTION_CODE = """
import json, sys, time
from repro_torch.launch import dryrun_compound as dc
for name, argv in json.loads(sys.argv[1]):
    t = time.perf_counter()
    dc.main(argv)
    print(f"compound cell {name} took {time.perf_counter() - t:.1f} s",
          flush=True)
"""


def start_dryruns() -> dict:
    """Start the dry-run cells of :data:`DRYRUN_CELLS` and
    :data:`DRYRUN_COMPOUND_CELL`, one subprocess each (a fake process group
    must be its process's default group), and the cells of
    :data:`DRYRUN_COMPOUND_PRODUCTION` in one more, so that they run on the
    host while the card runs the other phases."""
    import atexit
    import os
    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    procs = {}
    cmds = [(name, mesh, ["-m", "repro_torch.launch.dryrun", *args,
                          "--mesh", "single", "--out", str(out / name)])
            for name, mesh, args in DRYRUN_CELLS]
    name, mesh, args = DRYRUN_COMPOUND_CELL
    cmds.append((name, mesh, ["-m", "repro_torch.launch.dryrun_compound",
                              *args, "--out", str(out / name)]))
    cmds.append(("compound_production", None, [
        "-c", _COMPOUND_PRODUCTION_CODE, json.dumps([
            (n, [*a, "--out", str(out / "compound_production")])
            for n, _, a in DRYRUN_COMPOUND_PRODUCTION])]))
    for name, mesh, argv in cmds:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("REPRO_DRYRUN_TINY", None)
        if mesh:
            env["REPRO_DRYRUN_MESH"] = mesh
        else:
            env.pop("REPRO_DRYRUN_MESH", None)
        with open(out / f"{name}.log", "w") as log:
            procs[name] = (subprocess.Popen(
                [sys.executable, *argv], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=ROOT), time.perf_counter())

    def stop():                 # a failed check must not leave them running
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return procs


def _dryrun_records(procs: dict, name: str) -> list:
    """The records the dry-run subprocess ``name`` wrote, each with the
    subprocess's wall seconds."""
    proc, t0 = procs[name]
    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    log = ROOT / "build" / "dryrun_smoke" / f"{name}.log"
    check(rc == 0, f"dry-run cell {name} exited {rc}: "
          f"{log.read_text()[-3000:]}")
    paths = sorted((ROOT / "build" / "dryrun_smoke" / name).glob("*.json"))
    recs = [json.loads(p.read_text()) for p in paths]
    for rec in recs:
        rec["wall_s"] = wall
    return recs


def _dryrun_record(procs: dict, name: str) -> dict:
    [rec] = _dryrun_records(procs, name)
    return rec


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _step_bytes(fn, args) -> tuple:
    """(result, the step's argument bytes plus the most the card held
    above what was allocated just before the call, seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - before + _tree_bytes(args)
    return out, peak, wall


def phase_serve_mesh() -> tuple[int, int]:
    """granite-3-8b through the sharded serving steps on a one-rank NCCL
    mesh against ``Model.prefill``/``decode`` (see the module docstring,
    item 13) -> (the mesh prefill's flash launches, its measured peak
    bytes)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.train import step as step_mod
    B, S = PREFILL[0], PREFILL[1]
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=g)
    dec = torch.randint(0, cfg.vocab_size, (SERVE_GEN, B, 1), device="cuda",
                        generator=g)
    params = model.param_tree()     # at world size 1 a block is the leaf
    batch = {"tokens": tokens}
    (logits0, cache0), plain_peak, plain_s = _step_bytes(
        lambda p, b: model.prefill(b, extra_cache=SERVE_GEN),
        (params, batch))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = shd.section_mesh([0], ParallelConfig())
        pstep, specs = step_mod.build_prefill_step(
            model, mesh, ShapeConfig("serve", "prefill", S, B),
            extra_cache=SERVE_GEN)
        dstep, _ = step_mod.build_decode_step(
            model, mesh, ShapeConfig("serve", "decode", S + SERVE_GEN, B))
        reset_counts()
        (logits, cache), mesh_peak, mesh_s = _step_bytes(pstep,
                                                         (params, batch))
        launches = read_counts()
        note_bwd("serve_mesh")
        check(launches == (cfg.num_layers, 0, 0),
              f"the mesh prefill launched (flash, KL, SSD) {launches}, "
              f"expected ({cfg.num_layers}, 0, 0)")
        check(torch.equal(logits, logits0),
              "the mesh prefill's logits differ from Model.prefill's")
        diff = [i for i, (a, b) in enumerate(zip(tree_leaves(cache),
                                                 tree_leaves(cache0)))
                if not torch.equal(a, b)]
        check(not diff, f"the mesh prefill's cache differs in leaves {diff}")
        warm = {}
        for name, fn in (("plain", lambda: model.prefill(
                batch, extra_cache=SERVE_GEN)),
                ("mesh", lambda: pstep(params, batch))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            warm[name] = (time.perf_counter() - t) * 1e3
        reset_counts()
        dec_ms, plain_dec_ms = [], []
        for i in range(SERVE_GEN):
            tok = dec[i]
            t = time.perf_counter()
            l0, _ = model.decode(cache0, tok, S + i)
            torch.cuda.synchronize()
            plain_dec_ms.append((time.perf_counter() - t) * 1e3)
            (l1, _), dec_peak, dt = _step_bytes(dstep, (params, cache, tok,
                                                        S + i))
            dec_ms.append(dt * 1e3)
            check(torch.equal(l1, l0), f"decode step {i}: the mesh step's "
                  "logits differ from Model.decode's")
        check(read_counts() == (0, 0, 0), "decode launched a kernel")
        diff = [i for i, (a, b) in enumerate(zip(tree_leaves(cache),
                                                 tree_leaves(cache0)))
                if not torch.equal(a, b)]
        check(not diff, f"after decode the caches differ in leaves {diff}")
        print(f"serve-mesh: {ARCH} {cfg.num_layers} layers bf16, batch {B} "
              f"x prompt {S} + {SERVE_GEN} tokens, mesh "
              f"{shd.mesh_shape(mesh)}: prefill logits, cache and "
              f"{SERVE_GEN} decode steps equal Model.prefill/decode bit "
              f"for bit; flash {launches[0]} a prefill, 0 in decode")
        print(f"serve-mesh: prefill {mesh_s * 1e3:.1f} ms (Model.prefill "
              f"{plain_s * 1e3:.1f} ms, first calls), warm {warm['mesh']:.1f}"
              f" ms (Model.prefill {warm['plain']:.1f} ms); decode "
              f"{statistics.median(dec_ms[1:]):.2f} ms/token (Model.decode "
              f"{statistics.median(plain_dec_ms[1:]):.2f}; medians of "
              f"{SERVE_GEN - 1} warm steps)")
        print(f"serve-mesh: step peaks (argument bytes + peak above the "
              f"call): prefill {mesh_peak / 2**30:.3f} GiB (Model.prefill "
              f"{plain_peak / 2**30:.3f}), decode {dec_peak / 2**30:.3f} "
              f"GiB")
    finally:
        dist.destroy_process_group()
    return launches[0], mesh_peak


def _fake_matches_launch() -> None:
    """Each kernel op's shape function against a real launch at one
    shape: output shapes, dtypes and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    q = _randn(rng, (2, 256, 8, 64), bf)
    k = _randn(rng, (2, 256, 4, 64), bf)
    h = _randn(rng, (512, 256), bf)
    w = _randn(rng, (256, 1024), bf)
    x = _randn(rng, (2, 128, 4, 64), bf)
    dt = _randn(rng, (2, 128, 4), torch.float32).abs()
    A = -_randn(rng, (4,), torch.float32).abs()
    Bm = _randn(rng, (2, 128, 16), bf)
    cases = {
        "flash_fwd": (torch.ops.repro_torch.flash_fwd,
                      (q, k, k, None, True, 0, 0.125, 0)),
        "distill_kl_fwd": (torch.ops.repro_torch.distill_kl_fwd,
                           (h, w, h, w, 1.0)),
        "ssd_fwd": (torch.ops.repro_torch.ssd_fwd,
                    (x, dt, A, Bm, Bm, A, True))}
    n_cum, n_work = ssd.bwd_scratch(2, 128, 4, 64, 16, bf)
    cases["ssd_bwd"] = (torch.ops.repro_torch.ssd_bwd,
                        (x, dt, A, Bm, Bm, A, _randn(rng, x.shape, bf),
                         _randn(rng, (2, 4, 64, 16), torch.float32),
                         torch.empty(n_cum, dtype=torch.float64,
                                     device="cuda"),
                         torch.empty(n_work, device="cuda")))
    o, lse = torch.ops.repro_torch.flash_fwd(q, k, k, None, True, 0, 0.125, 0)
    cases["flash_bwd"] = (torch.ops.repro_torch.flash_bwd,
                          (q, k, k, o, lse, o, lse, None, True, 0, 0.125, 0))
    stats = torch.ops.repro_torch.distill_kl_fwd(h, w, h, w, 1.0)
    tok_w = torch.full((512,), 1.0 / 512, device="cuda")
    dz = torch.empty((1, 512, 1024), dtype=bf, device="cuda")
    cases["distill_kl_bwd"] = (torch.ops.repro_torch.distill_kl_bwd,
                               (h, w, h, w, *stats, tok_w, dz, 1.0, True,
                                True, False, False))
    for name, (op, args) in cases.items():
        real = op(*args)
        with FakeTensorMode() as mode:
            fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
            fake = op(*fargs)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        got = [(tuple(t.shape), t.dtype, t.stride()) for t in fake]
        want = [(tuple(t.shape), t.dtype, t.stride()) for t in real]
        check(got == want, f"{name}: fake outputs {got}, a launch's {want}")
        print(f"dryrun: {name}'s shape function gives a launch's outputs "
              f"{want}")


def phase_dryrun(procs: dict, prefill_peak: int) -> None:
    """The dry-run against the card (see the module docstring, item 13)."""
    import torch.distributed as dist
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    _fake_matches_launch()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(5)
    t = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(t[:, :-1]).cuda(),
             "labels": torch.from_numpy(t[:, 1:]).cuda(),
             "loss_mask": torch.ones((TRAIN_B, TRAIN_S), device="cuda")}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        par = ParallelConfig(dp=1, mbs=DP_MBS, zero_opt=True)
        mesh = shd.section_mesh([0], par)
        step = step_mod.build_train_step(
            model, par, ShapeConfig("t", "train", TRAIN_S, TRAIN_B),
            mesh=mesh)
        params = shd.shard_tree(model.param_tree(),
                                step.shardings["params"], mesh)
        opt = adamw.init(params)
        reset_counts()
        (_, _, met), train_peak, train_s = _step_bytes(
            step, (params, opt, step.block(batch), 0))
        check(math.isfinite(float(met["loss"])), "non-finite loss")
        print(f"dryrun: the measured train step (loss "
              f"{float(met['loss']):.4f}, {train_s:.2f} s, first call) held "
              f"{train_peak / 2**30:.3f} GiB")
    finally:
        dist.destroy_process_group()
    del model, params, opt, batch
    free()
    pred = {n: _dryrun_record(procs, n) for n in ("train", "prefill")}
    for name, measured in (("train", train_peak), ("prefill", prefill_peak)):
        rec = pred[name]
        p = rec["memory"]["peak_bytes"]
        ratio = p / measured
        print(f"dryrun: {name} {rec['arch']} {rec['global_batch']} x "
              f"{rec['seq_len']}: predicted {p / 2**30:.3f} GiB "
              f"(arguments {rec['memory']['argument_parts']}), measured "
              f"{measured / 2**30:.3f} GiB, ratio {ratio:.4f} (recorded in "
              f"{rec['record_s']:.1f} s)")
        check(abs(ratio - 1) <= DRYRUN_MEM_TOL,
              f"the {name} prediction is off by {ratio - 1:+.1%}")
    rec = pred["train"]
    planted = rec["memory"]["peak_bytes"] - \
        rec["memory"]["argument_parts"]["opt"]
    print(f"dryrun: the train record without its optimizer state predicts "
          f"{planted / 2**30:.3f} GiB, ratio {planted / train_peak:.4f}")
    check(abs(planted / train_peak - 1) > DRYRUN_MEM_TOL,
          "a record without its optimizer state passed the memory bound")
    prod = _dryrun_record(procs, "production")
    print(f"dryrun: production cell {prod['arch']} {prod['shape']} on "
          f"{prod['devices']} fake ranks (mbs {prod['mbs']}), recorded in "
          f"{prod['record_s']:.1f} s ({prod['wall_s']:.1f} s with start-up):"
          f" memory {prod['memory']}, FLOPs per device "
          f"{prod['hlo']['flops_per_device']:.4g}, wire bytes by family "
          f"{prod['hlo']['collective_bytes_per_device']}, roofline on H100 "
          f"{prod['roofline']}, useful {prod['useful_flops_ratio']:.3f}")
    check(prod["roofline"]["compute_s"] > 0
          and prod["hlo"]["collective_bytes_per_device"],
          "the production cell recorded no work or no collectives")
    _beside_before("production", prod)


def _beside_before(name: str, rec: dict) -> None:
    """A production record's bytes a rank and useful share beside its
    record before the block-fed steps and the vocab-parallel CE
    (:data:`PRODUCTION_BEFORE`)."""
    gb, useful = PRODUCTION_BEFORE[name]
    print(f"dryrun: {name} cell with block-fed steps and the "
          f"vocab-parallel CE: {rec['memory']['peak_bytes'] / 1e9:.2f} GB a "
          f"rank (before: {gb:.2f}), FLOPs per device "
          f"{rec['hlo']['flops_per_device']:.4g}, useful "
          f"{100 * rec['useful_flops_ratio']:.1f} % (before: "
          f"{100 * useful:.1f} %)")


MESH_MLLM_ITERS = 2


def _bitwise(a, b) -> list:
    """The paths of the leaves of two trees (or the keys of two metric
    dicts) that differ."""
    la, lb = dict(_named_leaves(a)), dict(_named_leaves(b))
    check(la.keys() == lb.keys(),
          f"trees differ in keys: {la.keys() ^ lb.keys()}")
    return [k for k in la if not torch.equal(la[k], lb[k])]


def _mesh_distill() -> tuple:
    """phase_distill's self-distillation through the distill step on a
    one-rank mesh against the meshless step (see phase_dryrun_compound)
    -> (flash, KL) launches of the mesh run, its first step's measured
    bytes."""
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist import sharding as shd
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    teacher = _host(build_model(cfg, device="cuda", seed=1).param_tree())
    student = _host(build_model(cfg, device="cuda", seed=0).param_tree())
    free()
    par = ParallelConfig(mbs=TRAIN_B)
    shape = ShapeConfig("distill", "train", TRAIN_S, TRAIN_B)
    kw = dict(alpha=0.5, temperature=2.0, lr_schedule=functools.partial(
        schedules.constant, peak_lr=1e-4))
    batches = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S,
                         vocab=cfg.vocab_size, seed=0, device="cuda")
    batches = [next(batches) for _ in range(DISTILL_STEPS)]
    runs = {}
    for name in ("plain", "mesh"):
        mesh = shd.section_mesh([0], par) if name == "mesh" else None
        step = dw.build_colocated_step(cfg, cfg, shape, par, mesh=mesh, **kw)
        pt = tree_map(lambda x: x.cuda(), teacher)
        ps = tree_map(lambda x: x.cuda(), student)
        if mesh is None:
            ps = tree_map(lambda x: x.requires_grad_(), ps)
        else:
            pt = shd.shard_tree(pt, step.shardings["teacher"], mesh)
            ps = shd.shard_tree(ps, step.shardings["student"], mesh)
        opt = adamw.init(ps)
        mets, times = [], []
        reset_counts()
        for i, batch in enumerate(batches):
            t = time.perf_counter()
            if mesh is not None:
                batch = step.block(batch)
            if mesh is not None and i == 0:
                (ps, opt, met), peak, _ = _step_bytes(
                    step, (ps, opt, pt, batch, i))
            else:
                ps, opt, met = step(ps, opt, pt, batch, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            mets.append(_host(met))
        launches = read_counts()
        note_bwd(f"distill_{name}")
        runs[name] = (mets, _host(ps), launches, times)
        del step, pt, ps, opt, met
        free()
    (m0, p0, l0, t0), (m1, p1, l1, t1) = runs["plain"], runs["mesh"]
    for i in range(DISTILL_STEPS):
        diff = _bitwise(m0[i], m1[i])
        check(not diff, f"distill step {i}: the mesh step's metrics {diff} "
              "differ from the meshless step's")
    diff = _bitwise(p0, p1)
    check(not diff, f"after {DISTILL_STEPS} distill steps the mesh step's "
          f"student differs in {diff[:4]}")
    want = (DISTILL_STEPS * cfg.num_layers * 3, DISTILL_STEPS, 0)
    check(l1 == l0 == want, f"distill launches (flash, KL, SSD): mesh {l1}, "
          f"meshless {l0}, expected {want}")
    print(f"dryrun-compound: distill {TRAIN_ARCH} (teacher seed 1, student "
          f"seed 0) batch {TRAIN_B} x {TRAIN_S} bf16 on a one-rank mesh: "
          f"{DISTILL_STEPS} steps equal the meshless step bit for bit "
          f"(losses {[round(float(m['loss']), 4) for m in m1]}); flash "
          f"{l1[0]}, KL {l1[1]}; ms a step mesh "
          f"{[round(x, 1) for x in t1]}, meshless "
          f"{[round(x, 1) for x in t0]}")
    return l1[:2], peak


def _mesh_mllm() -> int:
    """phase_mllm's colocated step on a one-rank mesh against the meshless
    step, MESH_MLLM_ITERS iterations, bit for bit -> the mesh run's flash
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import ParallelConfig
    from repro_torch.data.synthetic import vlm_batches
    from repro_torch.dist import sharding as shd
    from repro_torch.mllm import workload as mw
    from repro_torch.models import vlm
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw, schedules
    dev = torch.device("cuda", 0)
    lm_cfg = get_config("pixtral-12b").replace(num_layers=MLLM_LM_LAYERS)
    vit_cfg = vlm.vit_config(num_layers=MLLM_VIT_LAYERS,
                             out_dim=lm_cfg.vision_dim)
    gen = vlm_batches(batch=MLLM_B, seq_len=MLLM_S, vocab=lm_cfg.vocab_size,
                      vision_ratio=MLLM_RATIO,
                      image_tokens=lm_cfg.max_image_tokens,
                      patch_dim=vit_cfg.frontend_dim,
                      downsample=vlm.downsample_factor(vit_cfg), seed=0,
                      device="cpu")
    order = tuple(range(MLLM_B))
    batches = []
    for _ in range(MESH_MLLM_ITERS):
        b = next(gen)
        plan = mw.build_plan(order, b["has_image"].numpy(), MLLM_MBS)
        batches.append(mw.colocated_batch(b, plan))
    init = _host(mw.init_compound_params(vit_cfg, lm_cfg, seed=0,
                                         device=dev))
    free()
    lr = functools.partial(schedules.constant, peak_lr=1e-4)
    runs = {}
    for name in ("plain", "mesh"):
        mesh = (shd.section_mesh([0], ParallelConfig()) if name == "mesh"
                else None)
        step = mw.build_colocated_step(vit_cfg, lm_cfg, device=dev,
                                       lr_schedule=lr, mesh=mesh)
        params = tree_map(lambda x: x.to(dev), init)
        if mesh is not None:
            params = shd.shard_tree(params, step.shardings["params"], mesh)
        opt = adamw.init(params)
        mets, times = [], []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for i, batch in enumerate(batches):
            t = time.perf_counter()
            if mesh is not None:
                batch = step.block(batch)
            params, opt, met = step(params, opt, batch, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            mets.append(_host(met))
        launches = read_counts()
        note_bwd(f"mllm_{name}")
        runs[name] = (mets, _host(params), launches, times, _peak()[0])
        del step, params, opt, met
        free()
    (m0, p0, l0, t0, pk0), (m1, p1, l1, t1, pk1) = (runs["plain"],
                                                    runs["mesh"])
    for i in range(MESH_MLLM_ITERS):
        diff = _bitwise(m0[i], m1[i])
        check(not diff, f"mllm iteration {i}: the mesh step's metrics {diff}"
              " differ from the meshless step's")
    diff = _bitwise(p0, p1)
    check(not diff, f"the mesh MLLM step's parameters differ in {diff[:4]}")
    n_mb = MLLM_B // MLLM_MBS
    want = MESH_MLLM_ITERS * 2 * n_mb * (vit_cfg.num_layers
                                         + lm_cfg.num_layers)
    check(l1 == l0 == (want, 0, 0), f"mllm launches (flash, KL, SSD): mesh "
          f"{l1}, meshless {l0}, expected ({want}, 0, 0)")
    print(f"dryrun-compound: mllm (ViT {vit_cfg.num_layers} layers -> "
          f"pixtral-12b width, {lm_cfg.num_layers} layers) batch {MLLM_B} x "
          f"{MLLM_S}, mbs {MLLM_MBS}, on a one-rank mesh: "
          f"{MESH_MLLM_ITERS} iterations equal the meshless step bit for bit"
          f" (losses {[round(float(m['loss']), 4) for m in m1]}); flash "
          f"{l1[0]}; ms an iteration mesh {[round(x, 1) for x in t1]}, "
          f"meshless {[round(x, 1) for x in t0]}; peak {pk1:.2f} GiB mesh, "
          f"{pk0:.2f} meshless")
    return l1[0]


def phase_dryrun_compound(procs: dict) -> tuple:
    """The colocated compound steps on a one-rank NCCL mesh and the
    compound dry-run against the card (see the module docstring, item 14)
    -> ((flash, KL) of the distill mesh run, flash of the MLLM mesh
    run)."""
    import os
    import torch.distributed as dist
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        distill, measured = _mesh_distill()
        mllm = _mesh_mllm()
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    rec = _dryrun_record(procs, DRYRUN_COMPOUND_CELL[0])
    pred = rec["memory"]["peak_bytes"]
    ratio = pred / measured
    print(f"dryrun-compound: distill {TRAIN_ARCH} {TRAIN_B} x {TRAIN_S} on a "
          f"one-rank mesh: predicted {pred / 2**30:.3f} GiB (arguments "
          f"{rec['memory']['argument_parts']}), measured "
          f"{measured / 2**30:.3f} GiB, ratio {ratio:.4f} (recorded in "
          f"{rec['record_s']:.1f} s; kernel ops {rec['hlo']['kernel_ops']})")
    check(abs(ratio - 1) <= DRYRUN_MEM_TOL,
          f"the compound prediction is off by {ratio - 1:+.1%}")
    ops = rec["hlo"]["kernel_ops"]
    check(ops.get("repro_torch.distill_kl_fwd") == 1
          and ops.get("repro_torch.distill_kl_bwd") == 1,
          f"the recorded distill step's kernel ops {ops} do not hold one KL "
          "launch and one KL backward")
    _report_compound_production(procs)
    return distill, mllm


def _report_compound_production(procs: dict) -> None:
    """Print and check the production compound cells' records."""
    prod = {r["workload"].split(":")[0]: r
            for r in _dryrun_records(procs, "compound_production")}
    for name, depth, _ in DRYRUN_COMPOUND_PRODUCTION:
        r = prod[name]
        print(f"dryrun-compound: production {r['workload']} ({depth}; "
              f"{r['devices']} fake ranks), recorded in "
              f"{r['record_s']:.1f} s (collected {r['wall_s']:.1f} s after "
              f"the three started): memory {r['memory']}, "
              f"FLOPs per device {r['hlo']['flops_per_device']:.4g}, wire "
              f"bytes by family {r['hlo']['collective_bytes_per_device']}, "
              f"kernel ops {r['hlo']['kernel_ops']}, roofline on H100 "
              f"{r['roofline']}, useful {r['useful_flops_ratio']:.3f}")
        check(r["roofline"]["compute_s"] > 0
              and r["hlo"]["collective_bytes_per_device"],
              f"the production {name} cell recorded no work or no "
              "collectives")
        kops = r["hlo"]["kernel_ops"]
        n_kl = kops.get("repro_torch.distill_kl_fwd", 0)
        check((n_kl > 0) == (name != "mllm")
              and kops.get("repro_torch.distill_kl_bwd", 0) == n_kl,
              f"the production {name} cell's kernel ops "
              f"{r['hlo']['kernel_ops']}")
        if name in PRODUCTION_BEFORE:
            _beside_before(name, r)


def timed(phase, *args, **kw):
    """Run one phase and print its wall time."""
    t = time.perf_counter()
    out = phase(*args, **kw)
    print(f"phase {phase.__name__} took {time.perf_counter() - t:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    timed(phase_build)
    dryruns = start_dryruns()
    timed(phase_sweep, rng)
    flash_shapes = {
        "serve": (PREFILL, dict(bwd=False)),
        "train_distill": (TRAIN_ATTN, {}),
        "multi_teacher": (MT_ATTN, {}),
        "mllm_vit": (MLLM_VIT_ATTN, dict(causal=False)),
        "mllm_llm": (MLLM_LM_ATTN, {}),
        "moe_serve": (MIXTRAL_ATTN, dict(bwd=False, window=MIXTRAL_WINDOW,
                                         rows=PLAIN_ROWS)),
        "moe_train": (MOONSHOT_ATTN, {}),
        "moe_train_mb": (MOONSHOT_MB_ATTN, {}),
        "whisper_enc": (WHISPER_ENC_ATTN, dict(causal=False)),
        "whisper_self": (WHISPER_SELF_ATTN, {}),
        "whisper_cross": (WHISPER_CROSS_ATTN, dict(causal=False)),
        "whisper_prefill_cross": (WHISPER_PREFILL_CROSS,
                                  dict(causal=False, bwd=False)),
        "jamba_serve": (JAMBA_ATTN, dict(bwd=False, rows=PLAIN_ROWS)),
        "tp_repeat_rank": (TP_REPEAT_ATTN, {})}
    flash_at = {name: timed(phase_flash_shape, rng, shape, **kw)
                for name, (shape, kw) in flash_shapes.items()}
    timed(phase_flash_grads, rng)
    timed(phase_kl_sweep, rng)
    kl_at = {
        "train_distill": timed(phase_kl_main, rng, TRAIN_B * TRAIN_S),
        "multi_teacher": timed(phase_kl_main, rng, MT_MBS * TRAIN_S)}
    kl, kl_bwd = kl_entry(kl_at), kl_bwd_entry(kl_at)
    timed(phase_ssd_sweep, rng)
    ssd = ssd_entry({"mamba": timed(phase_ssd_shape, rng, SSD_MAIN),
                     "jamba_serve": timed(phase_ssd_shape, rng, SSD_JAMBA)})
    timed(phase_ssd_bwd_sweep, rng)
    ssd_bwd = ssd_bwd_entry({"mamba_train": timed(phase_ssd_bwd_main, rng,
                                                  SSD_MAIN)})
    timed(phase_ssd_grads, rng)
    free()
    serve_launches = timed(phase_serve)
    free()
    timed(phase_profile, rng)
    free()
    timed(phase_consistency, rng)
    free()
    train_launches = timed(phase_train)
    free()
    timed(phase_train_trace)
    free()
    resume_launches = timed(phase_checkpoint)
    free()
    dp_launches = timed(phase_dp)
    free()
    distill_launches, kl_launches = timed(phase_distill)
    free()
    timed(phase_grad_consistency, rng)
    free()
    mamba_train_launches = timed(phase_mamba_train)
    free()
    timed(phase_train_trace, MAMBA, MAMBA_B, MAMBA_S)
    free()
    mamba_serve_launches = timed(phase_mamba_serve, rng)
    free()
    timed(phase_mamba_consistency, rng)
    free()
    timed(phase_mamba_grad_consistency, rng)
    free()
    rt_launches, rt_kl_launches, calib = timed(phase_distill_runtime)
    free()
    sec_launches, sec_kl_launches = timed(phase_sections)
    free()
    cp_launches = timed(phase_cp, rng)
    free()
    pp_launches = timed(phase_pp, rng)
    free()
    tp_repeat_launches = timed(phase_tp_repeat, rng)
    free()
    vp_launches = timed(phase_vocab_parallel, rng)
    free()
    serve_mesh_launches, prefill_peak = timed(phase_serve_mesh)
    free()
    timed(phase_dryrun, dryruns, prefill_peak)
    free()
    (mesh_distill_launches, mesh_kl_launches), mesh_mllm_launches = timed(
        phase_dryrun_compound, dryruns)
    free()
    for name, (shape, causal) in zip(("cp_vit_chunk", "cp_train_chunk"),
                                     CP_CHUNK_SHAPES):
        S, T = shape[1:3]
        pos = cp_positions(CP_CHUNK_DEGREE, S // CP_CHUNK_DEGREE, 1,
                           T // CP_CHUNK_DEGREE)
        flash_at[name] = {**timed(phase_flash_shape, rng, shape, causal,
                                  bwd=False, positions=pos),
                          "kv_positions": f"cp {CP_CHUNK_DEGREE} chunk 1"}
    free()
    timed(phase_plan, calib)
    mt_launches, mt_kl_launches = timed(phase_multi_teacher)
    free()
    mllm_launches = timed(phase_mllm)
    free()
    moe_serve_launches = timed(phase_moe_serve, rng)
    free()
    timed(phase_moe_consistency, rng)
    free()
    moe_train_launches = timed(phase_moe_train)
    free()
    timed(phase_moe_grad_consistency, rng)
    free()
    whisper_train_launches = timed(phase_whisper_train)
    free()
    whisper_serve_launches = timed(phase_whisper_serve, rng)
    free()
    timed(phase_whisper_consistency, rng)
    free()
    timed(phase_whisper_grad_consistency, rng)
    free()
    jamba_launches, jamba_ssd_launches = timed(phase_jamba_serve, rng)
    free()
    timed(phase_jamba_consistency, rng)
    free()
    timed(phase_jamba_grad_consistency, rng)
    # the main paths of the kernels line, keyed as ``note_bwd`` records
    # them: (label, whether it trains through attention and so must launch
    # the flash backward; every other path must launch it no time)
    paths = {
        "serve": (f"serve {ARCH}", False),
        "train": (f"train {TRAIN_ARCH}", True),
        "resume": (f"resume {TRAIN_ARCH}", True),
        "dp": (f"dp {TRAIN_ARCH} world 1", True),
        "distill": (f"distill {TRAIN_ARCH}", True),
        "mamba_train": (f"train {MAMBA}", False),
        "mamba_serve": (f"serve {MAMBA}", False),
        "distill_runtime": (f"distill-runtime {TRAIN_ARCH}", True),
        "sections": (f"distill-sections {TRAIN_ARCH} world 1", True),
        "cp": (f"cp {TRAIN_ARCH} world 1", True),
        "pp": (f"pp {TRAIN_ARCH} world 1", True),
        "tp_repeat": (f"tp-repeat {ARCH} attention, tp {TP_REPEAT} shares",
                      True),
        "vocab_parallel": (f"vocab-parallel {TRAIN_ARCH} forward, tp {VP_TP} "
                           "CE shares", False),
        "serve_mesh": (f"serve-mesh {ARCH} world 1", False),
        "distill_mesh": (f"distill-mesh {TRAIN_ARCH} world 1", True),
        "mllm_mesh": ("mllm-mesh pixtral-12b-width world 1", True),
        "multi_teacher": (f"multi-teacher {TRAIN_ARCH}", True),
        "mllm": ("mllm pixtral-12b-width", True),
        "moe_serve": (f"serve {MIXTRAL} {MIXTRAL_LAYERS}L", False),
        "moe_train": (f"train {MOONSHOT} {MOONSHOT_LAYERS}L", True),
        "whisper_train": (f"train {WHISPER}", True),
        "whisper_serve": (f"serve {WHISPER}", False),
        "jamba_serve": (f"serve {JAMBA} {JAMBA_LAYERS}L", False)}
    per_path = {
        "flash": (serve_launches, train_launches, resume_launches,
                  dp_launches, distill_launches, 0, 0, rt_launches,
                  sec_launches, cp_launches, pp_launches,
                  tp_repeat_launches, vp_launches, serve_mesh_launches,
                  mesh_distill_launches,
                  mesh_mllm_launches, mt_launches,
                  mllm_launches, moe_serve_launches, moe_train_launches,
                  whisper_train_launches, whisper_serve_launches,
                  jamba_launches),
        "kl": (0, 0, 0, 0, kl_launches, 0, 0, rt_kl_launches,
               sec_kl_launches, 0, 0, 0, 0, 0, mesh_kl_launches, 0,
               mt_kl_launches, 0, 0, 0, 0, 0, 0),
        "ssd": (0, 0, 0, 0, 0, mamba_train_launches, mamba_serve_launches,
                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                jamba_ssd_launches),
        "flash_bwd": tuple(BWD_LAUNCHES[key] for key in paths),
        "kl_bwd": tuple(KL_BWD_LAUNCHES[key] for key in paths),
        "ssd_bwd": tuple(SSD_BWD_LAUNCHES[key] for key in paths)}
    for key, (label, trains) in paths.items():
        n = BWD_LAUNCHES[key]
        check(n > 0 if trains else n == 0,
              f"{label}: flash_bwd launched {n} times")
    # every KL forward of a path is differentiated: its backward's launches
    # equal its forward's, so some on each distillation path and none
    # elsewhere
    for label, fwd, bwd in zip((label for label, _ in paths.values()),
                               per_path["kl"], per_path["kl_bwd"]):
        check(bwd == fwd, f"{label}: distill_kl_bwd launched {bwd} times "
              f"for {fwd} forward launches")
    check(all(n > 0 for key, n in zip(paths, per_path["kl_bwd"])
              if key in ("distill", "distill_runtime", "sections",
                         "distill_mesh", "multi_teacher")),
          f"a distillation path launched no KL backward: {KL_BWD_LAUNCHES}")
    # the SSD backward: once a layer and step training mamba2-130m, no
    # time on any other path (serving mamba and jamba included)
    from repro_torch.configs import get_config
    mamba_layers = get_config(MAMBA).num_layers
    for key, (label, _) in paths.items():
        n = SSD_BWD_LAUNCHES[key]
        want = TRAIN_STEPS * mamba_layers if key == "mamba_train" else 0
        check(n == want, f"{label}: ssd_bwd launched {n} times, expected "
              f"{want}")
    labels = [label for label, _ in paths.values()]
    flash = flash_entry(flash_at)
    flash_bwd = flash_bwd_entry(flash_at)
    for name, entry in (("flash", flash), ("kl", kl), ("ssd", ssd),
                        ("flash_bwd", flash_bwd), ("kl_bwd", kl_bwd),
                        ("ssd_bwd", ssd_bwd)):
        check(len(per_path[name]) == len(labels),
              f"{name}: {len(per_path[name])} counts for {len(labels)} paths")
        entry["launches"] = sum(per_path[name])
        entry["launches_per_path"] = dict(zip(labels, per_path[name]))
    print(f"chip_smoke total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [flash, kl, ssd, flash_bwd, kl_bwd,
                                  ssd_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
