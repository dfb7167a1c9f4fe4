#!/usr/bin/env python3
"""Drive the PyTorch port (controlnet_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py                  # the whole check, one card
    python3 chip_smoke.py --verbose-build  # also print ptxas's register report
    python3 chip_smoke.py --phases 38      # phase 1 and the selected phases alone
    python3 chip_smoke.py --phases 1-5,38  # (each group of phases holding one runs whole)
    python3 chip_smoke.py --distill-only   # the same as --phases 17-20
    python3 chip_smoke.py --latent-train-only  # --phases 21-26
    python3 chip_smoke.py --cifar-only     # --phases 27-31
    python3 chip_smoke.py --cond-only      # --phases 32-35
    python3 chip_smoke.py --compare-only   # --phases 36-37
    python3 chip_smoke.py --tl-only        # --phases 42
    python3 chip_smoke.py --phases 43      # the background checkpoint save

The groups of phases are 1-4, 5-9, 10-14, 15-16, 17-20, 21-26, 27-31, 32-35,
36-37, 38, 39, 40, 41, 42 and 43; phase 1 (the card, the build) always runs.  A selection prints
the JSON summaries of the groups it ran and, when they passed, the final
``ok`` line, but no ``kernels`` line: that needs every phase.

Phases (each one that fails makes the script exit non-zero):

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from the sources in this checkout (``build/kernels/``); count the
   tensor-core instructions of each kernel in ``cuobjdump -sass`` of the
   library: every bfloat16 instantiation of kernels a, b, c and d must have
   warpgroup MMAs (HGMMA) and TMA loads (UTMALDG), and c's and d's no
   mma.sync (HMMA), but for c's mma.sync kernel of images 64 wide and wider,
   which must have HMMA; no float32 one any (float32 means float32, no
   TF32).
2. Full-width MNIST ControlNet forward at batch 64 with weights from a
   seeded reference-format ``.pth``: through the kernel against the same
   model with the attention's plain version, f32 and bf16.  The kernel's
   launch counter must rise by exactly 26 per forward; the attention shapes
   of that forward are recorded for phase 3.
3. The attention kernel against its plain version at every main-path shape
   (B*H = 256), one cross-attention shape and ``EDGE_SHAPES``, f32 and bf16,
   with the stated tolerances, every bf16 loading route (TMA, cp.async,
   staged) the shapes call for taken; device times (``time_calls``) of the kernel, the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` (a
   yardstick the port never calls; the backend that ran is printed), beside
   the least time the card could take.
4. The main path: the sampling tool's ``sample`` over the ancestral loop at
   batch 64, f32 and bf16 compute, cut to a 50-step schedule (its ms/step
   is what is read; the 1000 steps of PRs 1-6 and the 250 of PR 7 cost the
   time phases 17-26 need).  Launch counters are
   set to 0 just before and read just after each run.  A 10-step sample is
   also checked against the same sample with the plain attention.
5. One full-width training step at batch 64 (the ControlNet trainer tool's
   step, trunks from a seeded base UNet, hints from the port's canny on the
   card on seeded digit-like images): 26 forward and 18 backward kernel
   launches; the backward shapes are recorded for phase 6.
6. The backward kernel against its plain version at every training shape,
   the cross shape and ``EDGE_SHAPES`` (odd and even L off the multiples of
   8, Lk 77, head dims 4 and 128, a split query axis), f32 and bf16, its row
   term D against rowsum(dP o P) from float32 P within ``D_TOL`` (beside
   rowsum(dO o O) over the rounded output, an older form), and
   the forward kernel's saved log-sum-exp against ``torch.logsumexp``;
   device times of the kernel, the plain version and the backward of
   ``scaled_dot_product_attention`` (a yardstick the port never calls; the
   backend that ran is printed), beside the least time the card could
   take.
7. Three training steps through the kernels against the same steps with
   the plain attention forward and backward, from one generator, f32 and
   bf16: losses, first-step gradients and the weights after.
8. The training main path: 5 timed steps of the trainer's step at batch
   64, f32 and bf16 compute, counters set to 0 just before and read just
   after (exactly 26 forward and 18 backward launches a step), trainable
   weights moved and frozen ones bit-identical; ms/step on the host clock
   and a short torch.profiler window for device time.
9. The trainer tools: ``train_ddpm`` and ``train_ddpm_controlnet`` for one
   epoch over 256 seeded images, each resumed to a second epoch, then the
   sampling tool loads the written ControlNet ``.pth`` for a 10-step sample.
10. The 3x3 transposed-layout conv kernel against its plain version at the
   seven shapes of the CelebA-HQ hint encode (1024^2 hints, batch 16) and
   one ragged shape (24 -> 40 channels at 30 x 30), f32 and bf16; device
   times of the kernel (its own share beside the wrapper's casts), the plain
   version and ``F.conv2d`` (a yardstick the port never calls for these
   convs), beside the least time the card could take.
11. The full-width hint encode at batch 16: exactly 7 conv-kernel launches
   per chunk, the kernel route against the NCHW route through ``F.conv2d``,
   and chunked (4 hints at a time) against unchunked.
12. The full-width latent ControlNet forward (``config/celebhq.yaml``, batch
   16) through the attention kernel against the plain attention, 22 launches
   per forward; then the attention kernel against its plain version at
   those shapes (B*H = 256; L 1024..16, head dims 8..48), timed as in
   phase 3.
13. The latent main path through the sample tool (seeded ``.pth`` weights,
   ``.npy`` hints, batch 16): a 5-step sample with guidance through the kernels
   against the plain versions; then the ancestral loop (cut to a 50-step
   schedule, which leaves time for the later phases: its ms/step is what is
   read), DPM-Solver++ 20 steps with ``cfg_scale`` 2.0 and DDIM 50 steps on
   the 1000-step schedule, f32 and bf16, each ending
   in VAE-decoded (16, 3, 128, 128) images; counters set to 0 just before
   and read just after each run.
14. The fused projection + attention layer (kernel d) switched on: the
   full-width MNIST forward at batch 64 launches it 24 times and the
   attention kernel twice (head dim 4), the full-width latent forward at
   batch 16 launches it 22 times; each against the same forward with the
   switch off and with the plain versions, f32 and bf16.
15. Kernel d against its plain version at the six MNIST shapes (batch 16,
   the server's largest bucket) and the seven latent shapes
   (batch 16), on the channel-major activations the model passes, f32 and
   bf16; device times of the kernel, the plain version, the split path the
   port runs with the switch off (projection, attention kernel, projection)
   and ``F.multi_head_attention_forward`` (a yardstick the port never
   calls), beside the least time the card could take; two kernel calls
   bit-equal; the launch plan (rows or packing, cluster, shared memory,
   clusters the card holds at once) and the kernel's clock cycles a block by
   phase.
16. The serving main path: the serve tool's ``make_server`` on a free port,
   ``dpm_controlnet`` from the seeded ``.pth``, buckets up to 16, up to 20
   steps, switch on.  ``/healthz``; ``/generate_batch`` of 16 rows at 4, 10
   and 20 steps with the counters set to 0 just before and read just after;
   ``/generate`` when PIL imports; a pinned-x_T batch through
   ``build_generator``, kernels against plain versions; 32 concurrent
   one-row clients (in a process of their own) with and without dynamic
   batching; the two 400s; the same 16-row request, in turns, to servers with
   the switch off and with ``ddim_controlnet``; a profiler window over one
   generation; shutdown.
17. The distillation students (``config/mnist.yaml`` width, batch 64, seeded
   weights): the consistency and DMD students through kernel a against the
   plain attention on float32 and bf16 inputs, 16 launches per forward, and
   each output's type (the consistency student runs in float32 whatever its
   input, as in the JAX package).
18. Three steps of each consistency mode (ddpm_distillation,
   consistency_only, manual) and of DMD through kernels a and b against the
   same steps with the plain attention, f32 and bf16, from one generator:
   losses, first-step gradients, the weights and the EMA after; launches per
   step held to 42/16 (32/16 in consistency_only); a DMD step on a NaN batch
   leaves parameters, moments and count bit-identical and reports skipped 1.
19. The distillation main path: 5 timed steps each of ddpm_distillation and
   DMD at batch 64, f32 and bf16 (in a process of its own), counters set to 0
   just before and read just after, ms/step and a profiler window; both
   distillation trainer tools for 1 epoch, resumed to 2 (DMD with a seeded
   test split, its best checkpoint and sidecar); each sample tool on the
   written .pth, 1-step at batch 64 timed (samples/s), 4-step for
   consistency.
20. The serve tool's ``consistency`` and ``dmd`` models on those .pth files,
   buckets up to 16: ``/generate_batch`` of 16 rows at 1 step (and 4 for
   consistency) with 16 kernel-a launches per model call, a pinned-x_T batch
   kernels against plain, 32 concurrent one-row clients; the 16-row 1-step
   latency beside phase 16's 4-step teacher.
21. CelebA-HQ latent training at the full width of ``config/celebhq.yaml``
   (random weights from SEED): one step of the LDM trainer and one of the
   LDM ControlNet trainer at batch 16, launches a / b / c exactly 14 / 14 / 0
   and 22 / 14 / 7, the backward attention shapes recorded (the same 14 in
   both) for phase 22.
22. Kernel b against its plain version at those latent shapes (L 1024..16,
   head dims 24..48, batch 16), f32 and bf16, timed as in phase 6 (in a
   process of its own), beside the SDPA backward and the bound.
23. Kernel c under autograd: a batch-16 hint encode at 1024^2, forward and
   backward, through the kernel (7 launches) against the plain conv route,
   f32 and bf16 hints: the features and every hint-encoder weight gradient.
24. Three steps of each latent trainer (VAE-GAN straddling disc_start,
   LDM, LDM ControlNet with a condition-drop mask) through the kernels
   against the plain attention and conv routes, with the same injected
   draws, f32 and bf16: losses, first-step gradients, weights after, and
   the launches of every step.
25. The latent-training main path (in a process of its own): 5 timed
   steps of each trainer, f32 and bf16 (VAE-GAN batch 4 at 128^2, LDM batch
   16 on 32x32x4 latents, LDM ControlNet batch 16 with 1024^2 hints),
   counters set to 0 just before and read just after, ms/step, peak memory
   and a profiler window.
26. The latent tools on a tiny celeb config: train_vae (1 epoch, resumed to
   2), infer_vae, train_ldm_vae, sample_ldm_vae, train_ldm_controlnet, and
   the existing sample_ldm_controlnet on the written .pth files.
27. CIFAR-10 at the full width of ``config/cifar.yaml`` (batch 64, random
   weights from SEED, 32x32x3; attention at head dims 4-128, L 1024/256/64):
   the ControlNet forward through kernel a against the plain attention, f32
   and bf16, 26 launches; the same forward with the fused layer on (24 kernel
   d launches at head dims 16-128, 2 of a at head dim 4) against the switch
   off and the plain versions; kernel d against its plain version at head
   dims 72-128 off the model paths (``PROJ_WIDE_SHAPES``), and in bf16 at
   ``PROJ_EDGE_SHAPES`` (packed L 16 / 49 / 33 at batches that are not a
   multiple of the packing, ragged L 100 / 300, head dims 8-120) on three
   layouts of x, each call twice and bit-equal; then, in a process
   of its own, kernel a against its plain version at the forward's shapes,
   timed as in phase 3, and kernel d at its six CIFAR shapes, timed as in
   phase 15.
28. One CIFAR training step (26 forward and 18 backward launches, the
   backward shapes recorded), then kernel b against its plain version at
   those shapes, timed as in phase 6 (in a process of its own).
29. Three CIFAR training steps through the kernels against the plain
   attention, f32 and bf16, under cuDNN's deterministic algorithms, at phase
   7's limits with phase 24's weight limit (2e-2 lr).
30. The CIFAR main path: 10 timed training steps at batch 64, f32 and bf16
   (counters set to 0 just before and read just after: 26 / 18 a step; peak
   memory; a profiler window), then the ControlNet sample tool's ancestral
   loop at batch 64 cut to a 50-step schedule (26 launches a step),
   samples/s; and a 10-step f32 sample with ``--attn_fused_proj`` (24 d + 2 a
   launches a step) against the same sample with it off.
31. The tools on file trees written by the port's ``data/synthetic.py``: a
   CIFAR-10 style class tree (128 train, 32 test RGB PNGs) at full width,
   ``--config`` alone: train_ddpm -> sample_ddpm, train_ddpm_controlnet with
   ``--hint_backend tpu`` (and cv2 where it imports) -> sample_ddpm_controlnet
   with test-split hints; a CelebA-HQ style flat directory at a tiny config:
   train_vae -> infer_vae (basename keys) -> train_ldm_vae in latent mode.
32. The conditional LDM: ``config/celebhq.yaml``'s ``ldm_params`` with
   text (512-wide embeddings of 77 tokens, CLIP's) and image (18 CelebAMask-HQ
   mask classes at 512^2 through a 1x1 conv to 3 channels) conditioning, the
   reference's ``celebhq_text_image_cond.yaml``, random weights from SEED,
   batch 16, 32x32x4 latents, seeded embeddings and one-hot masks.  Its
   forward through kernel a against the plain attention, f32 and bf16: 28
   launches a forward (14 self, 14 cross-attention to the 77 text tokens),
   the cross shapes recorded; then kernel a against its plain version at
   those cross shapes, timed as in phase 3 (in a process of its own).
33. One DDPM-loss gradient through the conditional LDM (autograd over the
   model), under cuDNN's deterministic algorithms, through kernels a and b
   against the plain attention, f32 and bf16: the loss and the gradients of
   the context projections, the cross-attention weights and cond_conv_in
   within phase 24's limits; 28 kernel-b launches; then kernel b against its
   plain version at the cross shapes, timed as in phase 6 (in a process of
   its own).
34. Conditional LDM sampling (in a process of its own): DPM-Solver++ with
   guidance (scale 7.5; the null is a seeded empty-prompt embedding and the
   zero mask; both branches in one 32-row model call) and the VAE decode of
   ``config/celebhq.yaml``'s autoencoder, batch 16: a 5-step sample through
   the kernels against the plain attention from one x_T, then 20 steps f32
   and bf16, counters set to 0 just before and read just after (28 a
   launches a step): samples/s, ms/step, peak memory, and a profiler window
   over guided model calls (device ms a call, busy share).
35. The class-conditioned MNIST UNet (``config/mnist.yaml``'s width,
   ``num_classes`` 10, batch 64): the ancestral loop cut to a 50-step schedule
   with guidance (the zero one-hot is the null; one 128-row model call a
   step, 16 kernel-a launches), a 10-step run through the kernels against the
   plain attention on pinned x_T and noise, then the 50 steps f32 and bf16,
   samples/s.
36. The comparison tools at ``config/mnist.yaml``'s full width: seeded
   reference-format .pth files of the ControlNet and both students, a digit
   tree written by the port's ``data/synthetic.py`` as the test split;
   ``compare_controlnet_models`` and ``compare_all_controlnet_models`` through
   their ``main`` with ``--num_samples 5 --ddpm_steps 50 --hint_backend tpu``
   (and cv2 where it imports; the JAX tools' default is 1000 steps), counters
   set to 0 just before and read just after each: kernel a exactly 26 x 50 x 2
   per DDPM run (warm-up and timed) and 16 x 2 per student; the grids, the
   metrics file and ``timing_data.npy``; s/sample and speed-ups; then on the
   tools' path a 10-step DDPM sample from pinned x_T and step noise and each
   student's 1 step from a pinned x_T, through the kernel against the plain
   attention.
37. ``eval_metrics`` through its ``main`` on the card between two seeded
   28x28 grayscale PNG trees of 512 images (full-rank covariances), against
   the same function on the CPU, and a tree against itself (FFD ~ 0); then
   both TF32 switches set on, ``sample_ddpm_controlnet``'s ``main`` and
   ``serve.make_server`` on the card, and both switches read off after each.
38. Data parallelism (``controlnet_tpu_torch.parallel``), each rank a process
   of its own.  NCCL refuses two ranks on one device ("Duplicate GPU
   detected"), so on one card the semantics are held with two ranks on
   cuda:0 over gloo (which reduces CUDA tensors through the host), and the
   NCCL path, the tools' default on a card, at world size 1: (1) an NCCL group
   of one takes three ControlNet steps through the data-parallel path
   (all-reduces, sliced draws) bit-equal (max |diff| 0) to the same steps with
   no mesh, under deterministic cuDNN; (2) two ranks of 32 rows against one
   process of 64 at ``config/mnist.yaml``'s full width: three ControlNet
   steps through kernels a and b, f32 and bf16, at phase 7's limits, the
   launches of a and b per rank (26 and 18 a step), both ranks' weights
   bit-equal; (3) ``train_ddpm_controlnet``'s ``main`` for one epoch of 128
   seeded images (rank 0 alone writes; the .pth against the one-process
   run's) and ``sample_ddpm_controlnet``'s ``main`` (DDIM 10 steps, 5
   samples, padded to 6) against one process; (4) one consistency
   (ddpm_distillation) and one DMD step, with the feature extractor's
   global-batch BatchNorm; (5) two LDM ControlNet steps at
   ``config/celebhq.yaml``'s full width, 8 rows a rank (7 kernel-c launches a
   step a rank).  The wall ms/step of the two ranks beside one process are
   two ranks time-sliced on one card through the host: not a scaling figure.
39. The four latent tools' data-parallel paths at ``config/celebhq.yaml``'s
   widths, through their ``main``, two gloo ranks on cuda:0 against one
   process: ``train_vae`` (1 epoch of 8 seeded 128^2 images, batch 4, its
   calls accumulated into one update), ``train_ldm_vae`` (1 epoch, one
   batch of the 8, encoded by the seeded VAE), ``sample_ldm_vae`` and ``sample_ldm_controlnet``
   (DPM 4 steps and the decode, 3 samples padded to 4, 1024^2 hints through
   kernel c): one checkpoint each, .pth weights within LATENT_WEIGHT_TOL lr
   above the noise floor, samples within MODEL_TOL, launches of a / b / c
   per rank equal to one process's.
40. The serve tool's replicas: two replicas of its model on cuda:0
   (``make_server(..., devices=)``) against one, ``dpm_controlnet`` and the
   consistency student at 4 steps: a 16-row request split 8 + 8 and a 1-row
   request on the first replica, the samples within MODEL_TOL.
41. Megatron tensor parallelism (``parallel/tp.py``) over a 2-D (data,
   model) mesh: (i) an NCCL group of one with a model axis of 1, through
   ``tp_shard_params``, bit-equal to no mesh; (ii) the MNIST ControlNet on a
   (2, 2) mesh of four gloo ranks (2 of 4 heads a rank), three steps f32 and
   bf16 against one process at phase 7's limits, launches of a and b per
   rank; (iii) the CelebA-HQ LDM ControlNet on a (1, 2) mesh (8 of 16 heads a
   rank) at batch 16, two steps against one process, each rank's parameter
   bytes on the card against ``tp_memory_report``; (iv) kernels a and b at
   the per-rank TP shapes, and c on the gathered remainder weights, against
   their plain versions; (v) ``dryrun_multichip(4)``'s loss falling.  Times
   are of ranks time-sliced on one card: not a scaling figure.
42. The transposed-layout and dual-trunk forwards: (ii-iii) at the MNIST
   width (batch 64, the seeded .pth) and the CelebA-HQ one (batch 16, 1024^2
   hints, phase 10's seeded files), ``forward_tl``, ``forward_paired`` and
   ``forward_fused`` (and MNIST's ``UNet.forward_tl``, and a paired call with
   the fused layer on) against the default forward and against their plain
   versions, f32 and bf16, within MODEL_TOL, launches of c / a / d per call
   (MNIST 63 c + 26 a TL, 16 a paired and fused, 38 c + 16 a UNet TL, 12 a + 4
   d paired with the switch; latent 51 c + 22 a TL, 14 a paired and fused),
   and each TL forward once more with every kernel-c call held against the
   plain version on the same inputs within CONV_TOL (every shape of both
   widths); in a process of its own, first, (i) kernel c against its plain
   version and ``F.conv2d`` at every conv shape of the MNIST ControlNet's
   ``forward_tl`` (16 distinct, 1 -> 32 and 16 -> 1 channels included), batch
   64, f32 and bf16, timed as in phase 10, summed per ControlNet (63 calls)
   and UNet (38) TL forward, and the same at the latent ControlNet's
   ``forward_tl`` (51 calls, 16 shapes, batch 16), and (v) the wall ms per
   call of ``forward``, ``forward_tl`` and ``forward_paired`` in turns on the
   host clock, with each one's device ms (the union of its records'
   intervals) and busy share from a profiler window, at both widths.
43. Background checkpoint saves: the f32 train state that
   ``train_ldm_controlnet`` saves (config/celebhq.yaml's LDM ControlNet at
   full width, Adam's two moments, the frozen split) after one seeded step;
   the training thread's ms inside ``save_checkpoint`` and inside
   ``save_checkpoint_background`` and the seconds until the worker's write
   commits; one in-place Adam update right after the background call, and the
   file against a host copy taken before it, tensor by tensor (equal); the
   files are deleted.  Phases 9 and 19 resume ``train_ddpm`` and both
   distillation trainers, which save in the background.
44. A ``{"phase_seconds": {...}}`` line (wall seconds by group of phases),
   a ``{"distill": {...}}``, a ``{"latent_train": {...}}``, a
   ``{"cifar": {...}}``, a ``{"cond": {...}}``, a ``{"compare": {...}}``, a
   ``{"parallel": {...}}``, a ``{"latent_dp": {...}}``, a
   ``{"serve_replicas": {...}}``, a ``{"tensor_parallel": {...}}``, a
   ``{"tl": {...}}`` and a ``{"background_save": {...}}`` JSON line, a
   ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Kernel, plain-version and library times are device time: the profiler's sum
of the GPU work a call launches (``time_calls``), the wrappers' own casts
included, taken by the timing phases (3, 6, 10, 12, 15, 22, 27, 28, 32, 33, 42; and 19's,
25's and 34's timed runs) in fresh processes (``in_fresh_processes``): one per group
of phases, and 3 with 6, 15 with 10 and 12, 19 with 22 and 25 where both groups
run; each forked
from a server that imported torch once (``start_fork_server``), as are the
ranks of phases 38-41.  The
device time of a profiled step or call (phases 8, 16, 19, 25, 34, 42) is the
union of its records' intervals (``device_span_ms``), so a busy share never
passes 1.  (PRs
1-5 timed with CUDA events, PRs 6-7 printed those beside; PR 8 dropped them
to keep the run inside its time limit.)  TF32 is off for
matmuls and convolutions throughout, so float32 means float32: the script
sets it off, and every entry point of the port pins it off
(``device.resolve_device``), which phase 37 checks.  Exits
non-zero, printing no result, without a CUDA device or without the package
beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
import itertools
import json
import math
import multiprocessing
import multiprocessing.forkserver
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BATCH = 64
SEED = 0
# Published peaks of one H100 SXM (dense): the float32 rate outside the
# tensor cores, the bf16 tensor-core rate, and the HBM rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Whole-model tolerance, relative to the largest |output|: a wrong attention
# kernel moves the output by O(1); float32 reassociation by ~1e-6.
MODEL_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
CROSS_SHAPE = (49, 7, 16)  # (Lq, Lk, head_dim): not on the main path
# Off the main path, kernels a and b at their edges (phases 3 and 6): odd Ls
# (49, 77: element loads and the staged route), even Ls that are not
# multiples of 8 (196: 8-byte cp.async, 998: 4-byte), head dims 4 and 128,
# and (with a fourth entry, B*H 16) few enough slices that b splits the query
# axis; (Lq, Lk, dh[, B*H])
EDGE_SHAPES = ((196, 77, 4), (49, 196, 128), (998, 77, 24), (1024, 77, 128, 16))
# Off CIFAR's main path: split rows (head dims past 64) with a ragged query
# tail (49 rows against 16-row blocks), in cross-attention at dh 128 and in
# self-attention at dh 80 and 100 (padded to 96 and 128 in bf16, to 128 in
# float32)
CIFAR_OFF_PATH_SHAPES = ((49, 7, 128), (49, 49, 80), (49, 49, 100))
# Kernel b against its plain version, relative to max|grad|: float32 sums in
# another order (measured ~2e-6); in bf16 both compute in float32 from the
# same bf16 operands (P and dS enter their products as hi + lo, ~2^-17), so a
# gradient differs where a float32 sum lands on the other side of a bf16
# rounding boundary: one bf16 ulp, at most 2^-7 = 7.8e-3 of max|grad|.  The
# lse that kernel a saves, absolute, natural log (float32 math in both types).
BWD_KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4
# Kernel b's row term D against rowsum(dP o P) over float32 P, relative to
# max|D|: D = rowsum(dO o O) over kernel a's float32 output carries P's hi + lo
# rounding (~2^-17 a term, of either sign) and float32 sums.
D_TOL = 1e-5
# Kernel c against its plain version, relative to max|out|: the plain version
# is a float32 cuDNN convolution, which may sum in Winograd form (float32
# errors up to ~1e-4 of the output's scale); in bf16 both round the same
# float32 sums once (half an ulp, 2e-3 of the value).
CONV_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# Kernel d against its plain version, relative to max|out|: float32 sums in
# another order (three chained products); in bf16 a sum that lands near a
# rounding boundary rounds the other way in q, k, v, the head outputs or y
# (one bf16 ulp is 0.8% of a value).
PROJ_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The fused layer against the split path inside a whole forward: in bf16 both
# round q|k|v, the head outputs and y, but from float32 sums taken in another
# order, so a sum near a rounding boundary rounds the other way and the
# forward's later layers carry it on.
FUSED_VS_SPLIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
SERVE_BATCH = 16    # the serve tool's default largest bucket
SERVE_STEPS = (4, 10, 20)
SERVE_CLIENTS = 32
# (L, C, heads, calls per forward) of the self-attention layers kernel d takes
MNIST_PROJ_SHAPES = [(784, 64, 4, 4), (196, 128, 4, 4), (196, 32, 4, 2), (49, 256, 4, 8),
                     (49, 128, 4, 4), (49, 64, 4, 2)]
LDM_PROJ_SHAPES = [(1024, 384, 16, 4), (1024, 128, 16, 2), (256, 512, 16, 4),
                   (256, 256, 16, 2), (64, 768, 16, 4), (64, 384, 16, 2), (16, 512, 16, 4)]
# config/cifar.yaml's: head dims 32-128 (its two (1024, 16, 4) layers, head
# dim 4, keep the split path)
CIFAR_PROJ_SHAPES = [(1024, 128, 4, 4), (256, 256, 4, 4), (64, 512, 4, 8), (64, 256, 4, 4),
                     (64, 128, 4, 2), (256, 64, 4, 2)]
# Off the model paths, head dims past 64 with ragged tiles: 72 and 96 run as
# 96, 120 and 128 as 128, in 16- and 32-row tiles; (300, 256, 2) takes 64-row
# tiles, a bf16 plan only
PROJ_WIDE_SHAPES = [(49, 288, 4, 1), (33, 192, 2, 1), (100, 192, 2, 1), (100, 120, 1, 1),
                    (20, 256, 2, 1), (300, 256, 2, 1)]
# Kernel d in bf16 off the model paths, (L, C, heads, batch): L 16 and 49
# packed across batch elements (4 and 5 a cluster) at batches that are not a
# multiple of the packing, L 33 packed (7 in 4 tiles), L 100 and 300 in ragged
# tiles; head dims 8, 24, 72, 120, 32
PROJ_EDGE_SHAPES = ((16, 64, 8, 3), (16, 192, 8, 5), (49, 576, 8, 3), (49, 240, 2, 5),
                    (49, 128, 4, 7), (33, 96, 4, 3), (100, 192, 8, 2), (100, 144, 2, 2),
                    (300, 480, 4, 2))
LDM_BATCH = 16      # train_params.ldm_batch_size of config/celebhq.yaml
TRAIN_STEPS = 3     # timed steps of the training main paths (8, 19, 25, 30), per compute type
TRAIN_WARMUP = 1
PROFILE_STEPS = 1
CHECK_STEPS = 3     # kernel-vs-plain training steps
NOISE_FLOOR = 1e-6  # |gradient| below which Adam (eps 1e-8) amplifies float noise
TOOL_IMAGES = 128   # the trainer tools' seeded dataset: 2 steps per epoch


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line, led by the seconds since this process started; JSON
    lines as they are."""
    print(msg if msg.startswith("{") else f"[{time.perf_counter() - START:7.1f} s] {msg}",
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _PlainAttention(torch.autograd.Function):
    """The plain forward and the plain backward on any device: the comparison
    model of the training phases (the port's own Function launches kernels a
    and b on CUDA tensors)."""

    @staticmethod
    def forward(ctx, qt, kt, vt):
        from controlnet_tpu_torch.ops import cuda_attention

        ctx.save_for_backward(qt, kt, vt)
        return cuda_attention.fused_attention_t_plain(qt, kt, vt)

    @staticmethod
    def backward(ctx, dout):
        from controlnet_tpu_torch.ops import cuda_attention

        return cuda_attention.fused_attention_t_bwd_plain(*ctx.saved_tensors, dout)


@contextlib.contextmanager
def plain_attention():
    """Route the attention of this process, and its gradient, through the
    plain versions (the comparison model of phases 2, 4 and 7); the port
    itself has no such switch."""
    from controlnet_tpu_torch.ops import cuda_attention

    def plain(qt, kt, vt):
        if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad or vt.requires_grad):
            return _PlainAttention.apply(qt, kt, vt)
        return cuda_attention.fused_attention_t_plain(qt, kt, vt)

    orig = cuda_attention.fused_attention_t
    cuda_attention.fused_attention_t = plain
    try:
        yield
    finally:
        cuda_attention.fused_attention_t = orig


@contextlib.contextmanager
def record_shapes(into: list):
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention.fused_attention_t

    def rec(qt, kt, vt):
        into.append((qt.shape[3], kt.shape[3], qt.shape[2], qt.shape[0] * qt.shape[1]))
        return orig(qt, kt, vt)

    cuda_attention.fused_attention_t = rec
    try:
        yield
    finally:
        cuda_attention.fused_attention_t = orig


@contextlib.contextmanager
def plain_attention_proj():
    """Route the fused projection + attention layer of this process through
    its plain version (the comparison model of phases 14 and 16); the port
    itself has no such switch."""
    from controlnet_tpu_torch.ops import cuda_attention_proj

    orig = cuda_attention_proj.fused_attention_proj
    cuda_attention_proj.fused_attention_proj = cuda_attention_proj.fused_attention_proj_plain
    try:
        yield
    finally:
        cuda_attention_proj.fused_attention_proj = orig


@contextlib.contextmanager
def record_proj_shapes(into: list):
    """Record (L, C, heads, channel-major?) of every fused-layer call."""
    from controlnet_tpu_torch.ops import cuda_attention_proj

    orig = cuda_attention_proj.fused_attention_proj

    def rec(x, in_w, in_b, out_w, out_b, heads):
        into.append((x.shape[1], x.shape[2], heads, x.stride(1) == 1))
        return orig(x, in_w, in_b, out_w, out_b, heads)

    cuda_attention_proj.fused_attention_proj = rec
    try:
        yield
    finally:
        cuda_attention_proj.fused_attention_proj = orig


# (label, parts of the kernel's mangled name ("!part": a part it must not
# have), whether its template type is bf16: True / False / None for either,
# the SASS instructions each instantiation must have, "!OP" one it must not)
# -> cuobjdump's functions of the kernel.  Kernels a, b, c and d in bf16 run
# their products as warpgroup MMA (HGMMA) and load by TMA (UTMALDG), c and d
# with no mma.sync; c's mma.sync kernel, which the planner keeps for images
# 64 wide and wider, runs HMMA; no "f32" kernel has a tensor-core
# instruction (f32 c: the implicit GEMM and the pass that adds its split
# partial sums).
SASS_KERNELS = (
    ("a bf16 (attention_fwd_bf16.cu)", ("attention_fwd_hopper_kernel",), None,
     ("HGMMA", "UTMALDG")),
    ("a f32 (attention_fwd.cu)", ("attention_fwd_t_kernel",), None, ()),
    ("b bf16 (attention_bwd_bf16.cu)", ("attention_bwd_", "_hopper_kernel"), None,
     ("HGMMA", "UTMALDG")),
    ("b f32 (attention_bwd.cu)", ("attention_bwd_", "!_hopper_kernel", "!partial_sum"), None, ()),
    ("c bf16 (conv3x3_tl_bf16.cuh)", ("conv3x3_tl_bf16_kernel",), None,
     ("HGMMA", "UTMALDG", "!HMMA")),
    ("c bf16 mma.sync, W >= 64 (conv3x3_tl_bf16_mma.cu)", ("conv3x3_tl_bf16_mma_kernel",), None,
     ("HMMA",)),
    ("c f32 (conv3x3_tl.cu)", ("conv3x3_tl_f32_",), None, ()),
    ("d bf16 (attention_proj_hopper.cuh)", ("attention_proj_hopper_kernel",), None,
     ("HGMMA", "UTMALDG", "!HMMA")),
    ("d f32 (attention_proj.cuh)", ("attention_proj_kernel",), False, ()),
)
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def start_sass(lib_path: str, nvcc: str) -> tuple:
    """``cuobjdump -sass`` of the built library into a file beside it,
    started now and read by ``phase_sass``, so that the phases in between
    overlap it (it takes ~20 s of one host core)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = open(os.path.join(os.path.dirname(lib_path), "sass.txt"), "w+")
    return subprocess.Popen([tool, "-sass", lib_path], stdout=out, stderr=subprocess.PIPE,
                            text=True), out


def phase_sass(job: tuple) -> dict:
    """Tensor-core (HMMA, HGMMA) and TMA (UTMALDG) instructions per kernel in
    the built library's SASS (``job`` from ``start_sass``): every bf16
    instantiation of kernels a, b, c and d runs its products as wgmma and holds
    a TMA load (c and d no mma.sync; c's kernel for wide images runs
    mma.sync), and no float32 instantiation has a tensor-core instruction."""
    proc, out = job
    _, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise SystemExit(f"cuobjdump failed ({proc.returncode}): {err}")
    with out:
        out.seek(0)
        sass = out.read()
    funcs: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                # "HMMA" is not a word of "HGMMA": count each as its own opcode
                if f" {op}." in line or f" {op} " in line:
                    funcs[name][op] += 1
    counts = {}
    for label, parts, bf16, needs in SASS_KERNELS:
        mine = [n for n in funcs if all((p[1:] not in n) if p[0] == "!" else (p in n)
                                        for p in parts)
                and (bf16 is None or ("__nv_bfloat16" in n) == bf16)]
        c = dict(instantiations=len(mine))
        for op in SASS_OPS:
            per = [funcs[n][op] for n in mine]
            c[op.lower()] = sum(per)
            c[f"min_{op.lower()}"] = min(per) if per else 0
        counts[label] = c
        log(f"SASS {label}: {len(mine)} instantiations; "
            + ", ".join(f"{op} {c[op.lower()]} in all, {c['min_' + op.lower()]} in the fewest"
                        for op in SASS_OPS))
        if not mine:
            raise SystemExit(f"kernel {label}: missing from the library")
        for op in needs:
            if op.startswith("!"):
                if c[op[1:].lower()] != 0:
                    raise SystemExit(f"kernel {label}: {op[1:]} in its SASS")
            elif c[f"min_{op.lower()}"] == 0:
                raise SystemExit(f"kernel {label}: an instantiation without {op} in its SASS")
        if " f32 " in label and c["hmma"] + c["hgmma"] != 0:
            raise SystemExit(f"kernel {label}: tensor-core instructions in float32")
    return counts


def device_events(prof) -> list:
    """The device activity of a profiler window (kernels, copies, fills),
    without the ranges that annotate it (the optimizer's "Optimizer.step#
    Adam.step" spans its own kernels)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_ms(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name)) / 1e3
    return 0.0


def device_span_ms(events) -> float:
    """Device time of a window's records: the length of the union of their
    [start, end] intervals, in ms.  Records overlap (kernels on other
    streams, a library's nested launches), so their summed durations can
    exceed the window's wall time; the union cannot."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if hi is None or start > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        total += hi - lo
    return total / 1e3


# time_calls's windows, the measurements they hold, and the device records in
# them launched elsewhere
PROFILER_WINDOWS = {"measurements": 0, "groups": 0, "windows": 0, "foreign": 0, "seconds": 0.0}
_RANGE = "time_calls::"


def time_calls(calls: int = 3, tries: int = 8, **fns) -> dict:
    """Device time per call of each named function, under its name, and its
    kernels' names with their ms per call under ``<name>_names``.

    After a warm-up, one torch.profiler window (CPU + CUDA) runs ``calls``
    calls of each function in turn, each inside a ``record_function`` range
    and followed by a synchronise; the device time of all the GPU work a
    function's calls launched (the wrappers' casts and copies included) is
    summed and divided by ``calls``.  A device record belongs to the
    function whose range holds its launch (a `cuda*` or `cu*` API call,
    matched by correlation id): a process that has launched millions of
    kernels since its first window was seen to report an old window's
    records in every later one (why the timing phases run in fresh
    processes).  Even a fresh process now and then loses some of a window's
    records, so a window counts only when another window kept as many for
    every function, each a nonzero multiple of ``calls``.  No agreement in
    ``tries`` windows fails the run: there is no fallback to another clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    start = time.perf_counter()
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    seen = []
    PROFILER_WINDOWS["measurements"] += len(fns)
    PROFILER_WINDOWS["groups"] += 1
    for _ in range(tries):
        PROFILER_WINDOWS["windows"] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for key, fn in fns.items():
                with record_function(_RANGE + key):
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
        cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
        spans = {e.name[len(_RANGE):]: e.time_range for e in cpu if e.name.startswith(_RANGE)}
        owner = {}  # correlation id of a launch -> the function whose range holds it
        for e in cpu:
            if e.name.startswith("cu"):
                for key, span in spans.items():
                    if span.start <= e.time_range.start <= span.end:
                        owner[e.id] = key
                        break
        everything = device_events(prof)
        mine = {key: [] for key in fns}
        for e in everything:
            if e.id in owner:
                mine[owner[e.id]].append(e)
        kept = sum(len(v) for v in mine.values())
        PROFILER_WINDOWS["foreign"] += len(everything) - kept
        counts = tuple(len(mine[key]) for key in fns)
        if all(c and c % calls == 0 for c in counts) and counts in seen:
            out = {}
            for key, events in mine.items():
                names: dict = {}
                for e in events:
                    names[e.name] = names.get(e.name, 0.0) + _device_ms(e) / calls
                out[key], out[f"{key}_names"] = sum(names.values()), names
            PROFILER_WINDOWS["seconds"] += time.perf_counter() - start
            return out
        seen.append(counts)
        last = collections.Counter(e.name[:48] for e in everything).most_common(6)
    raise SystemExit(f"the profiler recorded no consistent device time (device records per "
                     f"function and window: {seen}; the last window's, launched there or not: "
                     f"{last})")


def own_ms(names: dict, *keys: str) -> float:
    """Device time of the kernels whose names hold one of ``keys``."""
    return sum(v for k, v in names.items() if any(key in k for key in keys))


def sdpa_backend(names: dict) -> str:
    """Which scaled_dot_product_attention backend ran, from its kernel names."""
    joined = " ".join(names).lower()
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "memeff", "mem_eff"))):
        if any(m in joined for m in marks):
            return backend
    return "math"


def attention_bound_ms(bh: int, lq: int, lk: int, dh: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once at the HBM rate, or the two products (4*Lq*Lk*dh flops per slice)
    at the card's peak for the input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * bh * dh * (2 * lq + 2 * lk)
    flops = 4.0 * bh * lq * lk * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def attention_bwd_bound_ms(bh: int, lq: int, lk: int, dh: int,
                           dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one backward call: q, k, v and dO read once and dq,
    dk, dv written once at the HBM rate, or the five products the JAX cost
    estimate counts (10*Lq*Lk*dh flops per slice) at the card's peak for the
    input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * bh * dh * (3 * lq + 4 * lk)
    flops = 10.0 * bh * lq * lk * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def proj_bound_ms(b: int, l: int, c: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one fused layer call (D = C): x, the weights and the
    biases read once and y written once at the HBM rate, or the layer's
    (8*L*C^2 + 4*L^2*C)*B flops, each projection counted once, at the card's
    peak for the input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * l * c + 4 * c * c + 4 * c)
    flops = (8.0 * l * c * c + 4.0 * l * l * c) * b
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_bound_ms(cin: int, cout: int, b: int, l: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one 3x3 TL conv call: the input, the weights and the
    bias read once and the output written once at the HBM rate, or
    2*9*Cin*Cout*B*L flops at the card's peak for the input type, whichever
    is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * ((cin + cout) * b * l + 9 * cin * cout) + 4 * cout
    flops = 2.0 * 9 * cin * cout * b * l
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


@contextlib.contextmanager
def record_conv_shapes(into: list):
    """Record (Cin, Cout, H, W, B) of every 3x3 TL conv the hint encoder asks for."""
    from controlnet_tpu_torch.ops import tl_conv

    orig = tl_conv.conv3x3_tl

    def rec(weight, bias, x, hw):
        into.append((x.shape[0], weight.shape[0], int(hw[0]), int(hw[1]), x.shape[1]))
        return orig(weight, bias, x, hw)

    tl_conv.conv3x3_tl = rec
    try:
        yield
    finally:
        tl_conv.conv3x3_tl = orig


RAGGED_CONV_SHAPE = (24, 40, 30, 30, LDM_BATCH)  # (Cin, Cout, H, W, B): every edge masked
# M = 189 pixels, no multiple of a pixel tile, whose 64-row tiles straddle
# 7x9 images
STRADDLE_CONV_SHAPE = (24, 40, 7, 9, 3)


def phase_conv_kernels(shapes: list, device,
                       off_path: list = (RAGGED_CONV_SHAPE, STRADDLE_CONV_SHAPE),
                       what: str = "hint encode") -> dict:
    """Kernel c against its plain version at every distinct shape of
    ``shapes`` (the convs of one unit of the main path: a hint encode, a TL
    forward) and at the ``off_path`` shapes (inputs as (C, B, L) views of
    NCHW tensors, as the models pass them), f32 and bf16, two calls equal
    bit for bit (a split's parts are added in a fixed order); device times of
    the kernel (and of its own launches, without the wrapper's weight cast:
    f32 c's split partial sums' pass included),
    the plain version and ``F.conv2d`` on the contiguous NCHW tensor (the
    library yardstick, which the port never calls for these convs).  The
    per-unit totals sum ``shapes``, each distinct shape times its count;
    ``per_shape`` holds each distinct shape's figures."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_conv

    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, own_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0, per_shape=[])
        mix = collections.Counter(tuple(s) for s in shapes)
        for cin, cout, h, w, b in list(mix) + [tuple(s) for s in off_path]:
            n = mix.get((cin, cout, h, w, b), 0)
            on_path = n > 0
            g = torch.Generator(device=device).manual_seed(SEED)
            img = torch.randn((b, cin, h, w), generator=g, device=device).to(dtype)
            bound = 1.0 / (9 * cin) ** 0.5
            weight = (torch.rand((cout, cin, 3, 3), generator=g, device=device) * 2 - 1) * bound
            bias = (torch.rand((cout,), generator=g, device=device) * 2 - 1) * bound
            x = cuda_conv.to_tl(img)
            with torch.inference_mode():
                out = cuda_conv.conv3x3_tl(weight, bias, x, (h, w))
                ref = cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w))
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                del ref
                ok = (err <= CONV_TOL[dtype] * scale and bool(torch.isfinite(out).all())
                      and out.shape == (cout, b, h * w) and out.is_contiguous())
                del out
                wd, bd = weight.to(dtype), bias.to(dtype)
                t = time_calls(
                    ms=lambda: cuda_conv.conv3x3_tl(weight, bias, x, (h, w)),
                    plain_ms=lambda: cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w)),
                    library_ms=lambda: F.conv2d(img, wd, bd, stride=1, padding=1))
                # two calls bit for bit (a split's parts are added in a fixed order)
                same = bool(torch.equal(cuda_conv.conv3x3_tl(weight, bias, x, (h, w)),
                                        cuda_conv.conv3x3_tl(weight, bias, x, (h, w))))
                ok = ok and same
            own = own_ms(t["ms_names"], "conv3x3_tl_f32_", "conv3x3_tl_bf16_")
            bound_ms, bound_by = conv_bound_ms(cin, cout, b, h * w, dtype)
            flops = 2.0 * 9 * cin * cout * b * h * w
            log(f"conv3x3_tl {str(dtype)[6:]:8s} {cin:3d}->{cout:3d} @{h}x{w} B {b}: "
                f"err {err:.3g} (tol {CONV_TOL[dtype]:g} x max|out| {scale:.3g}), two calls "
                f"bit-equal {same} {'ok' if ok else 'FAIL'} | device: kernel {t['ms']:.4f} ms, "
                f"its own launch "
                f"{own:.4f} ms ({flops / own / 1e9:.2f} TFLOP/s, {bound_ms / own:.3f} of the "
                f"bound), plain {t['plain_ms']:.4f} ms, F.conv2d {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})"
                f"{f' | x{n} per {what}' if on_path else ' | off the main path'}")
            if not ok:
                raise SystemExit("conv kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
            del img, x
            if not on_path:
                continue
            tot["per_shape"].append(dict(shape=[cin, cout, h, w, b], count=n, ms=t["ms"],
                                         own_ms=own, plain_ms=t["plain_ms"],
                                         library_ms=t["library_ms"], bound_ms=bound_ms,
                                         bound_by=bound_by, flops=flops))
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += n * t[key]
            tot["own_ms"] += n * own
            tot["bound_ms"] += n * bound_ms
            tot["flops"] += n * flops
            tot["ops_ms"] += n * bound_ms if bound_by == "operations" else 0.0
            tot["bytes_ms"] += n * bound_ms if bound_by == "bytes" else 0.0
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        totals[dtype] = tot
        log(f"conv3x3_tl {str(dtype)[6:]} per {what} ({len(shapes)} calls), device: "
            f"kernel {tot['ms']:.4f} ms (own launches {tot['own_ms']:.4f}), plain "
            f"{tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP")
    return totals


def hint_conv_shapes(hint_size: int, hint_channels: int, c0: int, factor: int,
                     batch: int) -> list:
    """(Cin, Cout, H, W, B) of the stride-1 3x3 convs of the dynamic hint
    encoder, in call order (what ``record_conv_shapes`` sees on a real encode)."""
    shapes = [(hint_channels, 16, hint_size, hint_size, batch)]
    base, size = 16, hint_size
    while factor > 1:
        base, size, factor = base * 2, size // 2, factor // 2
        shapes.append((base, base, size, size, batch))
    return shapes + [(base, c0, size, size, batch)]


def mnist_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "mnist.yaml"))


def randomize_zero_convs(cn) -> None:
    """Make every zero conv nonzero (normal, std 0.05, from the global torch
    seed) so the control branch contributes, and takes gradient, from the
    first step."""
    with torch.no_grad():
        for conv in cn.zero_convs():
            conv.weight.normal_(0.0, 0.05)
            conv.bias.normal_(0.0, 0.05)


def write_seeded_checkpoint(config: dict, path: str) -> None:
    """A reference-format .pth of random weights from SEED, with every zero
    conv nonzero so the control branch contributes."""
    from controlnet_tpu_torch.models.controlnet import ControlNet

    torch.manual_seed(SEED)
    mp = config["model_params"]
    cn = ControlNet(mp["im_channels"], mp)
    randomize_zero_convs(cn)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(cn.state_dict(), path)


def seeded_unet_state_dict(config: dict) -> dict:
    """The base UNet's state dict, random weights from SEED (what a
    reference-format ddpm .pth holds)."""
    from controlnet_tpu_torch.models.unet import UNet

    torch.manual_seed(SEED)
    mp = config["model_params"]
    return UNet(mp["im_channels"], mp).state_dict()


def seeded_digits(n: int, size: int = 28):
    """uint8 (N, H, W) digit-like images from SEED: a bright anti-aliased
    ring arc and a bar, 1-2.5 px thick, on black, which canny turns into
    closed edge maps as it does MNIST digits."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    out = np.zeros((n, size, size), np.float32)
    for im in out:
        cy, cx = rng.uniform(0.35 * size, 0.65 * size, 2)
        r, w = rng.uniform(0.15 * size, 0.3 * size), rng.uniform(1.0, 2.5)
        ring = np.clip(w + 0.5 - np.abs(np.hypot(yy - cy, xx - cx) - r), 0.0, 1.0)
        ring *= (np.arctan2(yy - cy, xx - cx) < rng.uniform(0.0, np.pi))  # an arc
        ang = rng.uniform(0.0, np.pi)
        y0, x0 = rng.uniform(0.25 * size, 0.75 * size, 2)
        across = np.abs((xx - x0) * np.sin(ang) - (yy - y0) * np.cos(ang))
        along = np.abs((xx - x0) * np.cos(ang) + (yy - y0) * np.sin(ang))
        bar = np.clip(w + 0.5 - across, 0.0, 1.0) * (along < rng.uniform(0.15, 0.35) * size)
        im[:] = np.maximum(ring, bar) * rng.uniform(180, 255)
    return out.round().astype(np.uint8)


def seeded_hints(n: int, size: int):
    """Binary (N, H, W, 3) edge-like hints in {0, 1}, as canny maps are."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    edges = (rng.uniform(size=(n, size, size, 1)) < 0.15).astype(np.float32)
    return np.repeat(edges, 3, axis=-1)


def phase_forward(cn, device, channels: int = 1, size: int = 28, what: str = "forward") -> list:
    """Full-width forward, kernel vs plain; returns the recorded shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((BATCH, channels, size, size), generator=g, device=device)
    t = torch.randint(0, 1000, (BATCH,), generator=g, device=device)
    hint = (torch.rand((BATCH, 3, size, size), generator=g, device=device) < 0.15).float()
    shapes: list = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype)
            feats = cn.hint_features(hint).to(dtype)
            before = cuda_attention.launches
            rec: list = []
            with record_shapes(rec):
                out = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            launched = cuda_attention.launches - before
            with plain_attention():
                ref = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = (launched == 26 and len(rec) == 26 and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * max(scale, 1.0))
            log(f"{what} {str(dtype)[6:]}: batch {BATCH}, kernel launches {launched} "
                f"(expect 26), max|out| {scale:.4g}, max abs err vs plain {err:.3g} "
                f"(tol {MODEL_TOL[dtype]:g} x max(1, max|out|)) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("full-width forward failed")
            shapes = shapes or rec
    return shapes


def phase_kernels(shapes: list, device, batch: int = BATCH,
                  cross: list = (CROSS_SHAPE,) + EDGE_SHAPES) -> dict:
    """Kernel vs plain at every main-path shape and at the (Lq, Lk, head_dim)
    shapes of ``cross``, off the main path, f32 and bf16; device times, and
    the SDPA backend; in bf16 every loading route the shapes call for taken
    (``check_routes``)."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_attention

    mix = collections.Counter(shapes)
    cases = sorted(mix, key=lambda s: (-s[0], -s[2]))
    cases += [tuple(shape) if len(shape) == 4 else (*shape, batch * 4) for shape in cross]
    routes_before = collections.Counter(cuda_attention.loader_launches)
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, sdpa_backends=set())
        for lq, lk, dh, bh in cases:
            g = torch.Generator(device=device).manual_seed(SEED)
            nb = math.gcd(batch, bh)
            q = torch.randn((nb, bh // nb, dh, lq), generator=g, device=device).to(dtype)
            k = torch.randn((nb, bh // nb, dh, lk), generator=g, device=device).to(dtype)
            v = torch.randn((nb, bh // nb, dh, lk), generator=g, device=device).to(dtype)
            with torch.inference_mode():
                out = cuda_attention.fused_attention_t(q, k, v)
                ref = cuda_attention.fused_attention_t_plain(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = err <= KERNEL_TOL[dtype] and bool(torch.isfinite(out).all())
                qh, kh, vh = (a.transpose(-1, -2).contiguous() for a in (q, k, v))
                t = time_calls(
                    ms=lambda: cuda_attention.fused_attention_t(q, k, v),
                    plain_ms=lambda: cuda_attention.fused_attention_t_plain(q, k, v),
                    library_ms=lambda: F.scaled_dot_product_attention(qh, kh, vh))
            backend = sdpa_backend(t["library_ms_names"])
            bound_ms, bound_by = attention_bound_ms(bh, lq, lk, dh, dtype)
            n = mix.get((lq, lk, dh, bh), 0)
            where = f"x{n} per forward" if n else "off the main path"
            log(f"attention {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: "
                f"err {err:.3g} (tol {KERNEL_TOL[dtype]:g}) {'ok' if ok else 'FAIL'} | device: "
                f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa ({backend}) "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | {where}")
            if not ok:
                raise SystemExit("attention kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["sdpa_backends"].add(backend)
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
            tot["flops"] += n * 4.0 * bh * lq * lk * dh
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        tot["sdpa_backends"] = sorted(tot["sdpa_backends"])
        totals[dtype] = tot
        log(f"attention {str(dtype)[6:]} per forward ({sum(mix.values())} calls), device: "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
            f"({'/'.join(tot['sdpa_backends'])}) {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP")
    check_routes("a", cases, routes_before)
    return totals


def check_routes(kernel: str, cases: list, before: collections.Counter) -> None:
    """The bf16 launches of kernel a or b since ``before`` by panel group and
    loading route (``cuda_attention.loader_launches``); fails unless every
    route the cases' lengths call for (TMA where L % 8 == 0, a copy route
    elsewhere) was taken."""
    from controlnet_tpu_torch.ops import cuda_attention

    now = {k: v - before.get(k, 0) for k, v in cuda_attention.loader_launches.items()
           if k.startswith(kernel + ":") and v > before.get(k, 0)}
    log(f"kernel {kernel} bf16 launches by panel group and loading route: {now}")
    lengths = {n for lq, lk, *_ in cases for n in (lq, lk)}
    want = {"tma"} if any(n % 8 == 0 for n in lengths) else set()
    want |= {"copy"} if any(n % 8 for n in lengths) else set()
    seen = {"tma" if k.endswith(":tma") else "copy" for k in now}
    if not want <= seen:
        raise SystemExit(f"kernel {kernel}: loading routes {sorted(want - seen)} not taken")


MNIST_ANCESTRAL_STEPS = 20  # the ancestral loop's schedule length in phase 4


def phase_main_path(config: dict, ckpt: str, device) -> dict:
    """The tool's sampling function, batch 64, f32 and bf16, over the
    ancestral loop cut to a MNIST_ANCESTRAL_STEPS-step schedule (the run's
    ms/step is what is read; the full 1000 steps cost the time that phases
    17-26 need)."""
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, _ = tool.load_model(config, ckpt)
    hints = tool.gather_hints(seeded_hints(4 * BATCH, 28), BATCH, seed=SEED)
    dp = config["diffusion_params"]
    sched = make_linear_schedule(MNIST_ANCESTRAL_STEPS, dp["beta_start"], dp["beta_end"],
                                 device=device)

    # a 10-step sample, kernel vs plain attention, same generator seed
    short = make_linear_schedule(10, dp["beta_start"], dp["beta_end"], device=device)
    x0_k, _ = tool.sample(cn, short, hints[:4], seed=SEED)
    with plain_attention():
        x0_p, _ = tool.sample(cn, short, hints[:4], seed=SEED)
    err = (x0_k - x0_p).abs().max().item()
    scale = x0_p.abs().max().item()
    ok = bool(torch.isfinite(x0_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"10-step sample, batch 4: max abs err kernel vs plain {err:.3g} "
        f"(max|x0| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("short sample disagrees with the plain attention")

    results = {}
    T = sched.num_timesteps
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        start = time.perf_counter()
        x0, traj = tool.sample(cn, sched, hints, seed=SEED, compute_dtype=dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = cuda_attention.launches
        final = traj[-1]
        ok = (launches == 26 * T and x0.shape == (BATCH, 1, 28, 28)
              and bool(torch.isfinite(x0).all()) and bool(torch.isfinite(final).all())
              and final.abs().max().item() <= 1.0 and traj.shape[0] == 1)
        results[name] = dict(seconds=seconds, launches=launches,
                             samples_per_s=BATCH / seconds, ms_per_step=seconds * 1e3 / T)
        log(f"main path {name}: {T} steps, batch {BATCH}: {seconds:.3f} s, "
            f"{BATCH / seconds:.3f} samples/s, {seconds * 1e3 / T:.3f} ms/step, "
            f"attention launches {launches} (expect {26 * T}), "
            f"raw x0 range [{x0.min().item():.3g}, {x0.max().item():.3g}], "
            f"written x0 in [-1, 1]: {final.abs().max().item() <= 1.0} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"main path ({name}) failed")
    return results


def train_setup(config: dict, base: dict, device, dtype_name: str, mesh=None):
    """The trainer tool's ControlNet, train state and step at ``dtype_name``
    compute, trunks from ``base``, zero convs made nonzero from SEED;
    data-parallel over ``mesh`` when given."""
    from controlnet_tpu_torch.tools import train_ddpm_controlnet as tool

    cfg = copy.deepcopy(config)
    cfg["train_params"]["compute_dtype"] = dtype_name
    cn, state, step = tool.make_trainer(cfg, base, device, seed=SEED, mesh=mesh)
    randomize_zero_convs(cn)
    return cn, state, step


def train_batches(images: torch.Tensor, steps: int, epoch: int = 0):
    """``steps`` batches of the trainer's shuffled order, with their canny
    hints made on the card as the trainer tool makes them."""
    from controlnet_tpu_torch.data.datasets import batch_indices
    from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints

    done = 0
    while done < steps:
        for idx in batch_indices(len(images), BATCH, shuffle=True, seed=epoch):
            if done == steps:
                return
            batch = images[torch.from_numpy(idx).to(images.device)]
            yield batch, device_hints(batch)
            done += 1
        epoch += 1


@contextlib.contextmanager
def record_bwd_shapes(into: list):
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention._launch_bwd

    def rec(qt, kt, vt, out, lse, dout):
        into.append((qt.shape[3], kt.shape[3], qt.shape[2], qt.shape[0] * qt.shape[1]))
        return orig(qt, kt, vt, out, lse, dout)

    cuda_attention._launch_bwd = rec
    try:
        yield
    finally:
        cuda_attention._launch_bwd = orig


def phase_train_shapes(config: dict, base: dict, images: torch.Tensor, device) -> list:
    """One full-width training step; returns the backward attention shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    _, state, step = train_setup(config, base, device, "float32")
    shapes: list = []
    g = torch.Generator(device=device).manual_seed(SEED)
    batch, hints = next(train_batches(images, 1))
    before = cuda_attention.launches, cuda_attention.bwd_launches
    with record_bwd_shapes(shapes):
        loss = step(state, batch, hints, g)
    torch.cuda.synchronize()
    fwd = cuda_attention.launches - before[0]
    bwd = cuda_attention.bwd_launches - before[1]
    ok = fwd == 26 and bwd == 18 and len(shapes) == 18 and bool(torch.isfinite(loss))
    log(f"training step, batch {BATCH}: attention launches forward {fwd} (expect 26), "
        f"backward {bwd} (expect 18), loss {loss.item():.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("full-width training step failed")
    return shapes


def phase_kernels_bwd(shapes: list, device, batch: int = BATCH,
                      cross: list = (CROSS_SHAPE,) + EDGE_SHAPES,
                      per: str = "training step") -> dict:
    """Kernel b (and kernel a's lse) against the plain versions at every
    training shape (q, k, v as slices of one packed projection, as the model
    passes them) and at the (Lq, Lk, head_dim) shapes of ``cross``, off the
    main path, f32 and bf16; b's row term D (in bf16 rowsum(dO o O) over
    kernel a's float32 output before its rounding) against rowsum(dP o P)
    from float32 P within D_TOL, beside rowsum(dO o O) over the rounded output
    (an older form); device times, and the SDPA backend; in bf16
    every loading route the shapes call for taken.  Totals are per ``per``
    (the calls of ``shapes``)."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_attention

    mix = collections.Counter(shapes)
    cases = sorted(mix, key=lambda s: (-s[0], -s[2]))
    cases += [tuple(shape) if len(shape) == 4 else (*shape, batch * 4) for shape in cross]
    routes_before = collections.Counter(cuda_attention.loader_launches)
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0, lse_err=0.0,
                   d_err=0.0, d_err_from_o=0.0, sdpa_backends=set())
        for lq, lk, dh, bh in cases:
            nb = math.gcd(batch, bh)
            heads = bh // nb
            g = torch.Generator(device=device).manual_seed(SEED)
            if lq == lk:
                packed = torch.randn((nb, 3 * heads * dh, lq), generator=g,
                                     device=device).to(dtype)
                q, k, v = (packed[:, i * heads * dh:(i + 1) * heads * dh]
                           .reshape(nb, heads, dh, lq) for i in range(3))
            else:
                q = torch.randn((nb, heads, dh, lq), generator=g, device=device).to(dtype)
                k = torch.randn((nb, heads, dh, lk), generator=g, device=device).to(dtype)
                v = torch.randn((nb, heads, dh, lk), generator=g, device=device).to(dtype)
            dout = torch.randn((nb, heads, dh, lq), generator=g, device=device).to(dtype)
            delta = torch.empty((nb, heads, lq), dtype=torch.float32, device=device)
            # the forward as training calls it: the output, what kernel b takes
            # of it (float32 before the rounding), the row log-sum-exp
            out, saved, lse = cuda_attention.forward_for_backward(q, k, v)
            scores = torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float()) / dh ** 0.5
            lse_err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
            got = cuda_attention._launch_bwd(q, k, v, saved, lse, dout, delta)
            ref = cuda_attention.fused_attention_t_bwd_plain(q, k, v, dout)
            # D as the TPU kernel forms it, and as rowsum(dO o O) over the output
            probs = torch.softmax(scores, dim=-1)
            del scores
            d_ref = (torch.einsum("bhdq,bhdk->bhqk", dout.float(), v.float()) * probs).sum(-1)
            del probs
            d_max = d_ref.abs().max().item()
            d_err = (delta - d_ref).abs().max().item() / d_max
            d_err_o = ((dout.float() * out.float()).sum(2) - d_ref).abs().max().item() / d_max
            del d_ref
            torch.cuda.synchronize()
            abs_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
            rel_err = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for a, r in zip(got, ref))
            ok = (rel_err <= BWD_KERNEL_TOL[dtype] and lse_err <= LSE_TOL and d_err <= D_TOL
                  and all(bool(torch.isfinite(a).all()) for a in got))
            qh, kh, vh = (a.transpose(-1, -2).contiguous().requires_grad_() for a in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh)
            gh = dout.transpose(-1, -2).contiguous()
            t = time_calls(
                ms=lambda: cuda_attention._launch_bwd(q, k, v, saved, lse, dout),
                plain_ms=lambda: cuda_attention.fused_attention_t_bwd_plain(q, k, v, dout),
                library_ms=lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh,
                                                       retain_graph=True))
            del sdpa
            backend = sdpa_backend(t["library_ms_names"])
            bound_ms, bound_by = attention_bwd_bound_ms(bh, lq, lk, dh, dtype)
            n = mix.get((lq, lk, dh, bh), 0)
            where = f"x{n} per {per}" if n else "off the main path"
            log(f"attention bwd {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: "
                f"rel err {rel_err:.3g} (tol {BWD_KERNEL_TOL[dtype]:g}), abs {abs_err:.3g}, "
                f"lse err {lse_err:.3g} (tol {LSE_TOL:g}), D err {d_err:.3g} of max|D| (tol {D_TOL:g}) "
                f"(rowsum(dO o O) {d_err_o:.3g}) {'ok' if ok else 'FAIL'} | device: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa bwd ({backend}) "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | {where}")
            if not ok:
                raise SystemExit("attention backward kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
            tot["lse_err"] = max(tot["lse_err"], lse_err)
            tot["d_err"] = max(tot["d_err"], d_err)
            tot["d_err_from_o"] = max(tot["d_err_from_o"], d_err_o)
            tot["sdpa_backends"].add(backend)
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
            tot["flops"] += n * 10.0 * bh * lq * lk * dh
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        tot["sdpa_backends"] = sorted(tot["sdpa_backends"])
        totals[dtype] = tot
        log(f"attention bwd {str(dtype)[6:]} per {per} ({sum(mix.values())} calls), "
            f"device: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa bwd "
            f"({'/'.join(tot['sdpa_backends'])}) {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP; "
            f"D err {tot['d_err']:.3g} of max|D| (rowsum(dO o O) {tot['d_err_from_o']:.3g}), "
            f"grad rel err {tot['max_rel_err']:.3g}")
    check_routes("b", cases, routes_before)
    return totals


def _check_steps(config, base, images, device, dtype_name: str, plain: bool,
                 deterministic: bool = False):
    """CHECK_STEPS training steps from one start and one generator (cuDNN's
    deterministic algorithms with ``deterministic``); returns (losses,
    first-step grads, params before, params after, noise-floor mask)."""
    cn, state, step = train_setup(config, base, device, dtype_name)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, grads, noisy = [], None, {}
    with contextlib.ExitStack() as stack:
        if deterministic:
            stack.enter_context(torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True, allow_tf32=False))
        if plain:
            stack.enter_context(plain_attention())
        for batch, hints in train_batches(images, CHECK_STEPS):
            losses.append(step(state, batch, hints, g))
            for k, p in state.params.items():
                low = p.grad.abs() < NOISE_FLOOR
                noisy[k] = low if k not in noisy else noisy[k] | low
            if grads is None:
                grads = {k: p.grad.detach().clone() for k, p in state.params.items()}
    after = {k: p.detach().clone() for k, p in state.params.items()}
    return torch.stack(losses).float().cpu(), grads, before, after, noisy


def phase_train_parity(config: dict, base: dict, images: torch.Tensor, device,
                       dtype: torch.dtype, weight_tol: float = 1e-2,
                       deterministic: bool = False, what: str = "training") -> dict:
    """CHECK_STEPS steps through kernels a and b against the same steps with
    the plain attention forward and backward.  Tolerances: losses and the
    first step's gradients MODEL_TOL (relative); after three Adam steps the
    weights whose gradients stayed above the noise floor within weight_tol
    * lr (f32), or, in bf16, whose rounding flips small gradients' signs, a
    mean |difference| under 0.15 lr and a cosine of the two updates over
    0.97."""
    name = str(dtype)[6:]
    lk, gk, before, ak, nk = _check_steps(config, base, images, device, name, plain=False,
                                          deterministic=deterministic)
    lp, gp, _, ap, npl = _check_steps(config, base, images, device, name, plain=True,
                                      deterministic=deterministic)
    lr = config["train_params"]["controlnet_lr"]
    loss_err = ((lk - lp).abs().max() / lp.abs().max().clamp(min=1.0)).item()
    gmax = max(g.abs().max().item() for g in gp.values())
    grad_err = max((gk[k] - gp[k]).abs().max().item() for k in gp) / gmax
    clean, allw, upd_k, upd_p = [], [], [], []
    for k in before:
        d = (ak[k] - ap[k]).abs()
        keep = ~(nk[k] | npl[k])
        clean.append(d[keep].flatten())
        allw.append(d.flatten())
        upd_k.append((ak[k] - before[k]).flatten())
        upd_p.append((ap[k] - before[k]).flatten())
    clean, allw, upd_k, upd_p = (torch.cat(x).double() for x in (clean, allw, upd_k, upd_p))
    cos = (upd_k @ upd_p / (upd_k.norm() * upd_p.norm())).item()
    clean_max = clean.max().item() / lr
    mean_diff = allw.mean().item() / lr
    ok = (bool(torch.isfinite(lk).all()) and loss_err <= MODEL_TOL[dtype]
          and grad_err <= MODEL_TOL[dtype]
          and (mean_diff < 0.15 and cos > 0.97 if dtype == torch.bfloat16
               else clean_max < weight_tol))
    log(f"{what} {name}, {CHECK_STEPS} steps kernels vs plain attention: losses "
        f"{[round(x, 5) for x in lk.tolist()]} vs {[round(x, 5) for x in lp.tolist()]} "
        f"(rel err {loss_err:.3g}), first-step grads rel err {grad_err:.3g} "
        f"(tol {MODEL_TOL[dtype]:g}); weights after: max |diff| {clean_max:.3g} lr over the "
        f"{clean.numel() / allw.numel():.3f} whose gradients stayed above {NOISE_FLOOR:g}, "
        f"(tol {weight_tol:g}), mean {mean_diff:.3g} lr over all, update cosine {cos:.6f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"training ({name}) through the kernels disagrees with plain attention")
    return dict(loss_err=loss_err, grad_err=grad_err, clean_max_lr=clean_max,
                mean_diff_lr=mean_diff, cos=cos)


def is_kernel_a(name: str) -> bool:
    """A profiler kernel name of kernel a: its float32 or its bf16 kernel."""
    return "attention_fwd_t_kernel" in name or "attention_fwd_hopper_kernel" in name


def phase_train_main_path(config: dict, base: dict, images: torch.Tensor, device,
                          what: str = "training main path", steps: int | None = None) -> dict:
    """The training main path: ``steps`` timed steps of the trainer tool's
    step at batch 64, full width, hints from the port's canny on the card,
    f32 and bf16.  Counters set to 0 just before the timed run and read just
    after, peak memory over it; then a short torch.profiler window for
    device time and busy share (``steps`` None: TRAIN_STEPS)."""
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.ops import cuda_attention

    steps = steps or TRAIN_STEPS
    results = {}
    for name in ("float32", "bfloat16"):
        cn, state, step = train_setup(config, base, device, name)
        trainable, frozen = cn.split_params()
        t_before = {k: p.detach().clone() for k, p in trainable.items()}
        f_before = {k: p.detach().clone() for k, p in frozen.items()}
        g = torch.Generator(device=device).manual_seed(SEED)
        for batch, hints in train_batches(images, TRAIN_WARMUP, epoch=100):
            step(state, batch, hints, g)
        data = list(train_batches(images, steps + PROFILE_STEPS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_attention.launches = 0
        cuda_attention.bwd_launches = 0
        start = time.perf_counter()
        losses = [step(state, batch, hints, g) for batch, hints in data[:steps]]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fwd, bwd = cuda_attention.launches, cuda_attention.bwd_launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.stack(losses).float()

        # the device alone: this window runs in the parent, which times no
        # kernel with time_calls after it
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for batch, hints in data[steps:]:
                step(state, batch, hints, g)
            torch.cuda.synchronize()
        kernels = device_events(prof)
        dev_ms = device_span_ms(kernels) / PROFILE_STEPS
        fwd_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name))
        bwd_ms = sum(_device_ms(e) for e in kernels if "attention_bwd_" in e.name)

        moved = all(not torch.equal(p.detach(), t_before[k]) for k, p in trainable.items())
        still = all(torch.equal(p.detach(), f_before[k]) for k, p in frozen.items())
        ms_step = seconds * 1e3 / steps
        ok = (fwd == 26 * steps and bwd == 18 * steps
              and bool(torch.isfinite(losses).all()) and moved and still)
        results[name] = dict(seconds=seconds, launches=fwd, bwd_launches=bwd,
                             ms_per_step=ms_step, steps_per_s=steps / seconds,
                             device_ms_per_step=dev_ms, busy=dev_ms / ms_step,
                             kernels_per_step=len(kernels) / PROFILE_STEPS,
                             attn_fwd_device_ms=fwd_ms / PROFILE_STEPS,
                             attn_bwd_device_ms=bwd_ms / PROFILE_STEPS, peak_gb=peak_gb)
        log(f"{what} {name}: {steps} steps, batch {BATCH}: {seconds:.3f} s, "
            f"{ms_step:.3f} ms/step, {steps / seconds:.3f} steps/s, attention launches "
            f"forward {fwd} (expect {26 * steps}), backward {bwd} "
            f"(expect {18 * steps}), loss {losses[0].item():.4f} -> "
            f"{losses[-1].item():.4f}, peak {peak_gb:.2f} GB, trainable moved {moved}, "
            f"frozen unchanged {still} | "
            f"profile ({PROFILE_STEPS} steps): device {dev_ms:.3f} ms/step, busy "
            f"{dev_ms / ms_step:.3f}, {len(kernels) / PROFILE_STEPS:.1f} kernels/step, "
            f"kernel a {fwd_ms / PROFILE_STEPS:.3f} ms/step, kernel b "
            f"{bwd_ms / PROFILE_STEPS:.3f} ms/step -> {'ok' if ok else 'FAIL'}")
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + _device_ms(e) / PROFILE_STEPS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"{what} {name} top device kernels (ms/step): "
            + "; ".join(f"{k.replace('void ', '')[:56]} {v:.3f}" for k, v in top))
        if not ok:
            raise SystemExit(f"training main path ({name}) failed")
        del cn, state, step
    return results


def phase_tools(config: dict, device) -> None:
    """Each trainer tool for one epoch over TOOL_IMAGES seeded images, then
    resumed to a second epoch; the sampling tool then loads the written
    ControlNet .pth and draws a 10-step sample."""
    import numpy as np
    import yaml

    from controlnet_tpu_torch.ops.canny import canny_hints
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as sample_tool
    from controlnet_tpu_torch.tools import train_ddpm, train_ddpm_controlnet

    work = os.path.join(REPO, "build", "smoke", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    images = os.path.join(work, "images.npy")
    np.save(images, seeded_digits(TOOL_IMAGES))

    def config_path(epochs: int) -> str:
        cfg = copy.deepcopy(config)
        cfg["train_params"].update(task_name=os.path.join(work, "mnist"), num_epochs=epochs,
                                   controlnet_epochs=epochs, ckpt_save_every_epochs=1)
        path = os.path.join(work, f"mnist_{epochs}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    start = time.perf_counter()
    runs = [(tool, epochs, tool.train(config_path(epochs), images))
            for tool in (train_ddpm, train_ddpm_controlnet) for epochs in (1, 2)]
    seconds = time.perf_counter() - start
    ok = all(h["epochs"] == [epochs] and np.isfinite(h["losses"]).all() for _, epochs, h in runs)
    tp = config["train_params"]
    ckpt = os.path.join(work, "mnist", tp["controlnet_ckpt_name"])
    ok = ok and all(os.path.exists(os.path.join(work, "mnist", name[:-4], "2.pt"))
                    for name in (tp["ddpm_ckpt_name"], tp["controlnet_ckpt_name"]))
    cn, _ = sample_tool.load_model(config, ckpt)
    dp = config["diffusion_params"]
    short = make_linear_schedule(10, dp["beta_start"], dp["beta_end"], device=device)
    first = torch.from_numpy(np.load(images)[:4, :, :, None].astype(np.float32) / 255.0)
    hints = canny_hints(first.to(device)).cpu().numpy()
    x0, _ = sample_tool.sample(cn, short, hints, seed=SEED)
    ok = ok and x0.shape == (4, 1, 28, 28) and bool(torch.isfinite(x0).all())
    log(f"trainer tools: train_ddpm and train_ddpm_controlnet, 1 epoch then resumed to 2 "
        f"over {TOOL_IMAGES} images ({seconds:.1f} s; epoch losses "
        f"{[round(h['losses'][0], 4) for _, _, h in runs]}); sample tool on the written .pth, "
        f"10 steps: x0 {tuple(x0.shape)} finite -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("trainer tools failed")


def celebhq_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "celebhq.yaml"))


@contextlib.contextmanager
def plain_conv():
    """Route the 3x3 transposed-layout convs of this process through the plain
    version (the comparison model of phase 13); the port itself has no such
    switch."""
    from controlnet_tpu_torch.ops import cuda_conv, tl_conv

    orig = tl_conv.conv3x3_tl
    tl_conv.conv3x3_tl = cuda_conv.conv3x3_tl_plain
    try:
        yield
    finally:
        tl_conv.conv3x3_tl = orig


def write_seeded_ldm_checkpoints(config: dict, cn_path: str, vae_path: str) -> None:
    """Reference-format .pth files of the latent ControlNet and the VAE at the
    config's full width, random weights from SEED, every zero conv nonzero."""
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    torch.manual_seed(SEED)
    cn, vae, _ = tool.load_models(config, None, None, device="cpu")
    randomize_zero_convs(cn)
    os.makedirs(os.path.dirname(cn_path), exist_ok=True)
    torch.save(cn.state_dict(), cn_path)
    torch.save(vae.state_dict(), vae_path)


def write_seeded_ldm_hints(n: int, size: int, path: str) -> None:
    """An .npy of binary (N, size, size, 3) edge-like hints (uint8 0 / 1)."""
    import numpy as np

    np.save(path, seeded_hints(n, size).astype(np.uint8))


def seeded_ldm_files() -> tuple[str, str, str]:
    """The seeded latent ControlNet and VAE .pth files and the hints .npy at
    ``config/celebhq.yaml``'s full width (phases 10-14 and 42), written
    where missing."""
    config = celebhq_config()
    work = os.path.join(REPO, "build", "smoke", "ldm")
    os.makedirs(work, exist_ok=True)
    paths = tuple(os.path.join(work, name) for name in (
        f"ldm_controlnet_seed{SEED}.pth", f"vae_seed{SEED}.pth", f"hints_seed{SEED}.npy"))
    if not all(os.path.exists(path) for path in paths):
        write_seeded_ldm_checkpoints(config, *paths[:2])
        write_seeded_ldm_hints(2 * LDM_BATCH, config["dataset_params"]["canny_im_size"],
                               paths[2])
    return paths


def phase_hint_encode(cn, hints, device) -> list:
    """The full-width hint encode at batch LDM_BATCH: launches per chunk, the
    kernel route against the NCHW route, chunked against unchunked.  Returns
    the recorded conv shapes."""
    from controlnet_tpu_torch.ops import cuda_conv

    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    shapes: list = []
    with torch.inference_mode():
        before = cuda_conv.launches
        with record_conv_shapes(shapes):
            feats = cn.hint_features(hint)
        torch.cuda.synchronize()
        per_encode = cuda_conv.launches - before
        ref = cn.hint_block(hint)  # the same modules through F.conv2d, NCHW
        torch.cuda.synchronize()
        err = (feats - ref).abs().max().item()
        scale = ref.abs().max().item()
        del ref
        before = cuda_conv.launches
        chunked = cn.hint_features_chunked(hint, chunk=4)
        torch.cuda.synchronize()
        per_chunked = cuda_conv.launches - before
        chunk_err = (chunked - feats).abs().max().item()
        start = time.perf_counter()
        cn.hint_features_chunked(hint, chunk=LDM_BATCH)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - start) * 1e3
    n_chunks = -(-hint.shape[0] // 4)
    ok = (per_encode == 7 and len(shapes) == 7 and per_chunked == 7 * n_chunks
          and feats.shape == (hint.shape[0], cn.trained_unet.down_channels[0],
                              hint.shape[2] // cn.down_sample_factor,
                              hint.shape[3] // cn.down_sample_factor)
          and bool(torch.isfinite(feats).all())
          and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
          and chunk_err <= 1e-5 * max(scale, 1.0))
    log(f"hint encode f32, batch {hint.shape[0]}, hints {tuple(hint.shape[2:])}: conv kernel "
        f"launches {per_encode} (expect 7), chunked by 4: {per_chunked} (expect "
        f"{7 * n_chunks}); features {tuple(feats.shape)}, max|f| {scale:.4g}; max abs err "
        f"vs the NCHW F.conv2d route {err:.3g} (tol {MODEL_TOL[torch.float32]:g} x max|f|), "
        f"chunked vs unchunked {chunk_err:.3g} "
        f"({'bit-identical' if chunk_err == 0 else 'tol 1e-5 x max|f|'}); "
        f"whole encode {encode_ms:.2f} ms on the host clock -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("full-width hint encode failed")
    return shapes


def phase_ldm_forward(cn, hints, device) -> list:
    """Full-width latent ControlNet forward at batch LDM_BATCH, kernel vs
    plain attention; returns the recorded attention shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    g = torch.Generator(device=device).manual_seed(SEED)
    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    size = hint.shape[2] // cn.down_sample_factor
    x = torch.randn((LDM_BATCH, cn.trained_unet.im_channels, size, size), generator=g,
                    device=device)
    t = torch.randint(0, 1000, (LDM_BATCH,), generator=g, device=device)
    shapes: list = []
    with torch.inference_mode():
        feats32 = cn.hint_features_chunked(hint)
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
            before = cuda_attention.launches
            rec: list = []
            with record_shapes(rec):
                out = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            launched = cuda_attention.launches - before
            with plain_attention():
                ref = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = (launched == 22 and len(rec) == 22 and out.shape == x.shape
                  and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * max(scale, 1.0))
            log(f"latent forward {str(dtype)[6:]}: batch {LDM_BATCH}, attention launches "
                f"{launched} (expect 22), max|out| {scale:.4g}, max abs err vs plain {err:.3g} "
                f"(tol {MODEL_TOL[dtype]:g} x max(1, max|out|)) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("full-width latent forward failed")
            shapes = shapes or rec
    return shapes


def phase_ldm_fused_forward(cn, hints, device) -> None:
    """The full-width latent forward of ``phase_ldm_forward`` with the fused
    layer on: every attention layer has a head dim of 8..48, so all 22 go to
    kernel d and none to kernel a."""
    g = torch.Generator(device=device).manual_seed(SEED)
    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    size = hint.shape[2] // cn.down_sample_factor
    x = torch.randn((LDM_BATCH, cn.trained_unet.im_channels, size, size), generator=g,
                    device=device)
    t = torch.randint(0, 1000, (LDM_BATCH,), generator=g, device=device)
    with torch.inference_mode():
        feats = cn.hint_features_chunked(hint)
    phase_fused_forward(cn, x, t, feats, LDM_PROJ_SHAPES, 0, "latent")


LDM_ANCESTRAL_STEPS = 20  # the ancestral loop's schedule length in phase 13
LDM_MODES = (
    ("ancestral", dict()),
    ("dpm10_cfg2", dict(sampler="dpm", sampler_steps=10, cfg_scale=2.0)),
    ("ddim20", dict(sampler="ddim", sampler_steps=20)),
)


def phase_ldm_main_path(config: dict, cn, vae, sched, hints_path: str, device) -> dict:
    """The latent main path through the sample tool's functions: a short
    sample with guidance, kernels vs plain versions; then the three sampler modes at
    batch LDM_BATCH, f32 and bf16, counters set to 0 just before each run and
    read just after."""
    import numpy as np

    from controlnet_tpu_torch.ops import cuda_attention, cuda_conv
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    hints = tool.gather_hints(np.load(hints_path), LDM_BATCH, seed=SEED)

    flags = dict(sampler="dpm", sampler_steps=5, cfg_scale=2.0)
    img_k, _ = tool.sample(cn, vae, sched, hints[:2], seed=SEED, **flags)
    with plain_attention(), plain_conv():
        img_p, _ = tool.sample(cn, vae, sched, hints[:2], seed=SEED, **flags)
    err = (img_k - img_p).abs().max().item()
    scale = img_p.abs().max().item()
    ok = bool(torch.isfinite(img_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"5-step latent sample with guidance + decode, batch 2: max abs err kernels vs plain "
        f"{err:.3g} (max|image| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("short latent sample disagrees with the plain versions")

    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    dp = config["diffusion_params"]
    ancestral_sched = make_linear_schedule(LDM_ANCESTRAL_STEPS, dp["beta_start"],
                                           dp["beta_end"], ldm_scheduler=True, device=device)
    im_size, z = config["dataset_params"]["im_size"], cn.trained_unet.im_channels
    lsize = tool.latent_size(config["dataset_params"], config["autoencoder_params"])
    results: dict = {}
    for mode, mode_flags in LDM_MODES:
        run_sched = ancestral_sched if mode == "ancestral" else sched
        steps = mode_flags.get("sampler_steps", run_sched.num_timesteps)
        with_cfg = "cfg_scale" in mode_flags
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_attention.launches = 0
            cuda_conv.launches = 0
            start = time.perf_counter()
            images, traj = tool.sample(cn, vae, run_sched, hints, seed=SEED,
                                       compute_dtype=dtype, **mode_flags)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            attn, conv = cuda_attention.launches, cuda_conv.launches
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # one encode of the hints, and one of the null hint under guidance
            want_conv = 14 if with_cfg else 7
            snapshots = 1 if mode == "ancestral" else steps
            ok = (attn == 22 * steps and conv == want_conv
                  and images.shape == (LDM_BATCH, 3, im_size, im_size)
                  and traj.shape == (snapshots, LDM_BATCH, z, lsize, lsize)
                  and bool(torch.isfinite(images).all()) and bool(torch.isfinite(traj).all()))
            results[(mode, name)] = dict(
                seconds=seconds, steps=steps, ms_per_step=seconds * 1e3 / steps,
                samples_per_s=LDM_BATCH / seconds, attn_launches=attn, conv_launches=conv,
                peak_gb=peak_gb)
            log(f"latent main path {mode} {name}: {steps} steps, batch {LDM_BATCH}"
                f"{' (x2 in the model call, for guidance)' if with_cfg else ''}: {seconds:.3f} s, "
                f"{LDM_BATCH / seconds:.3f} samples/s, {seconds * 1e3 / steps:.3f} ms/step, "
                f"attention launches {attn} (expect {22 * steps}), conv launches {conv} "
                f"(expect {want_conv}), images {tuple(images.shape)} in "
                f"[{images.min().item():.3g}, {images.max().item():.3g}], peak memory "
                f"{peak_gb:.2f} GB -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"latent main path ({mode}, {name}) failed")
            del images, traj
    return results


def phase_ldm(device, extra: tuple = ()) -> dict:
    """Phases 10-13: the CelebA-HQ latent slice.  ``extra`` timing phases
    ((phase, args, kwargs) each) run in phases 10 and 12's fresh process
    after theirs; their totals come back under "extra"."""
    import numpy as np

    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    config = celebhq_config()
    start = time.perf_counter()
    cn_path, vae_path, hints_path = seeded_ldm_files()
    cn, vae, sched = tool.load_models(config, cn_path, vae_path)
    n_params = sum(p.numel() for p in cn.parameters()) + sum(p.numel() for p in vae.parameters())
    log(f"latent models: config/celebhq.yaml at full width, {n_params / 1e6:.1f} M parameters, "
        f"hint factor {cn.down_sample_factor}; seeded .pth and .npy written and loaded in "
        f"{time.perf_counter() - start:.1f} s")
    hints = tool.gather_hints(np.load(hints_path), LDM_BATCH, seed=SEED)

    conv_shapes = phase_hint_encode(cn, hints, device)
    if conv_shapes != hint_conv_shapes(hints.shape[1], 3, cn.trained_unet.down_channels[0],
                                       cn.down_sample_factor, LDM_BATCH):
        raise SystemExit(f"unexpected conv shapes in the hint encode: {conv_shapes}")
    attn_shapes = phase_ldm_forward(cn, hints, device)
    kern_conv, kern_attn, kern_proj, *more = in_fresh_processes(
        ("phase_conv_kernels", (conv_shapes,), {}),
        ("phase_kernels", (attn_shapes,), dict(batch=LDM_BATCH, cross=())),
        ("phase_proj_kernels", (LDM_PROJ_SHAPES, LDM_BATCH), dict(what="latent forward")),
        *extra)
    phase_ldm_fused_forward(cn, hints, device)
    runs = phase_ldm_main_path(config, cn, vae, sched, hints_path, device)
    return dict(conv=kern_conv, attn=kern_attn, proj=kern_proj, runs=runs, extra=more)


def is_kernel_d(name: str) -> bool:
    return "attention_proj_kernel" in name or "attention_proj_hopper_kernel" in name


def proj_plan_text(l: int, c: int, heads: int, dtype: torch.dtype, batch: int) -> str:
    """Kernel d's launch plan at a self-attention shape (D = C), in words."""
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    plan = proj.launch_plan(l, c, c, heads, dtype, batch)
    if dtype == torch.bfloat16:
        return (f"{plan.elems} elements in {plan.tiles} 64-row tiles, {plan.warpgroups} a block "
                f"({plan.per_sm} an SM), x {plan.groups} head groups a cluster, "
                f"{plan.heads_per_tile} heads a projection tile, {plan.out_cols} "
                f"output channels a tile, rings {plan.wstages} / {plan.kvstages}, {plan.smem} B "
                f"shared")
    rows, q_tiles, groups, smem = plan
    return (f"{rows} rows per block, cluster {q_tiles} tiles x {groups} head groups, {smem} B "
            f"shared")


def proj_inputs(b: int, l: int, c: int, dtype: torch.dtype, device):
    """Seeded inputs of one fused layer call: channel-major (B, C, L) unit
    normal activations, as the GroupNorm before the layer leaves them, and
    parameters drawn as ``nn.MultiheadAttention`` initialises its weights,
    with nonzero biases."""
    g = torch.Generator(device=device).manual_seed(SEED)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g, device=device) * 2 - 1) * bound).to(dtype)

    xt = torch.randn((b, c, l), generator=g, device=device).to(dtype)
    return (xt, uniform((3 * c, c), (6.0 / (4 * c)) ** 0.5), uniform((3 * c,), 0.1),
            uniform((c, c), 1.0 / c ** 0.5), uniform((c,), 0.1))


def phase_proj_kernels(cases: list, batch: int, device, what: str) -> dict:
    """Kernel d against its plain version at ``cases`` ((L, C, heads, calls
    per forward)), f32 and bf16, on the (B, L, C) view of channel-major
    activations that the model passes; timings of the kernel, the plain
    version, the split path and ``F.multi_head_attention_forward`` (device
    time, with the CUDA-event time beside)."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import attention as attention_ops
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, split_ms=0.0, flops=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0)
        for l, c, heads, n in cases:
            xt, in_w, in_b, out_w, out_b = proj_inputs(batch, l, c, dtype, device)
            x = xt.transpose(1, 2)
            args = (in_w, in_b, out_w, out_b, heads)

            def split():
                qkv = torch.matmul(in_w, xt) + in_b[:, None]
                out_t = attention_ops.multi_head_attention_t(
                    qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:], heads)
                return torch.matmul(out_w, out_t) + out_b[:, None]

            xl = x.transpose(0, 1).contiguous()  # (L, B, C), the library call's layout

            def library():
                return F.multi_head_attention_forward(
                    xl, xl, xl, c, heads, in_w, in_b, None, None, False, 0.0, out_w, out_b,
                    training=False, need_weights=False)[0]

            with torch.inference_mode():
                out = proj.fused_attention_proj(x, *args)
                equal = torch.equal(out, proj.fused_attention_proj(x, *args))
                ref = proj.fused_attention_proj_plain(x, *args)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                # the same layer on contiguous (B, L, C) tokens
                err_tok = (proj.fused_attention_proj(x.contiguous(), *args).float()
                           - ref.float()).abs().max().item()
                err_split = (split().transpose(1, 2).float() - ref.float()).abs().max().item()
                err_lib = (library().transpose(0, 1).float() - ref.float()).abs().max().item()
                phases = proj.phase_profile(x, *args)
                ok = (max(err, err_tok) <= PROJ_TOL[dtype] * scale and equal
                      and bool(torch.isfinite(out).all()) and out.shape == x.shape
                      and out.stride() == x.stride())
                del ref
                t = time_calls(ms=lambda: proj.fused_attention_proj(x, *args),
                               plain_ms=lambda: proj.fused_attention_proj_plain(x, *args),
                               split_ms=split, library_ms=library)
            ms = t["ms"]
            bound_ms, bound_by = proj_bound_ms(batch, l, c, dtype)
            flops = (8.0 * l * c * c + 4.0 * l * l * c) * batch
            clusters = proj.max_active_clusters(l, c, c, heads, dtype, batch)
            log(f"attention_proj {str(dtype)[6:]:8s} L {l:4d} C {c:3d} dh {c // heads:2d} B {batch}: "
                f"err {err:.3g}, on contiguous tokens {err_tok:.3g} (tol {PROJ_TOL[dtype]:g} x "
                f"max|out| {scale:.3g}), two calls bit-equal {equal} {'ok' if ok else 'FAIL'}; "
                f"split path vs plain {err_split:.3g}, library vs plain {err_lib:.3g} | device: "
                f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s of the layer's flops; "
                f"{proj_plan_text(l, c, heads, dtype, batch)}, {clusters} clusters at once), plain "
                f"{t['plain_ms']:.4f} ms, split path {t['split_ms']:.4f} ms, F.mha "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | x{n} per "
                f"{what} | cycles a block by phase: "
                + ", ".join(f"{p} {phases[p]:.0f}" for p in proj.phases(dtype)))
            if not ok:
                raise SystemExit("fused projection + attention kernel disagrees with its "
                                 "plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err, err_tok)
            tot["max_rel_err"] = max(tot["max_rel_err"], max(err, err_tok) / scale)
            for key in ("ms", "plain_ms", "library_ms", "split_ms"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["flops"] += n * flops
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        totals[dtype] = tot
        log(f"attention_proj {str(dtype)[6:]} per {what} at batch {batch} "
            f"({sum(n for *_, n in cases)} calls), device: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, split path {tot['split_ms']:.4f} ms, F.mha "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}), "
            f"{tot['flops'] / 1e9:.2f} GFLOP")
    return totals


def phase_fused_forward(cn, x, t, feats32, expect: list, want_a: int, what: str) -> dict:
    """One full-width forward with the fused layer switched on: launches of
    kernel d (one per entry of ``expect``) and of kernel a, against the same
    forward with the switch off and with the plain versions, f32 and bf16.
    Returns kernel d's counted launches of that forward by dtype name."""
    from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj

    want_d = sum(n for *_, n in expect)
    want = collections.Counter({(l, c, h, True): n for l, c, h, n in expect})
    launches = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
            off = cn(xin, t, hint_features=feats)
            set_attn_fused_proj(cn, True)
            try:
                before = cuda_attention_proj.launches, cuda_attention.launches
                rec: list = []
                with record_proj_shapes(rec):
                    out = cn(xin, t, hint_features=feats)
                torch.cuda.synchronize()
                got_d = cuda_attention_proj.launches - before[0]
                got_a = cuda_attention.launches - before[1]
                with plain_attention(), plain_attention_proj():
                    ref = cn(xin, t, hint_features=feats)
                torch.cuda.synchronize()
            finally:
                set_attn_fused_proj(cn, False)
            scale = max(ref.float().abs().max().item(), 1.0)
            err = (out.float() - ref.float()).abs().max().item()
            err_off = (out.float() - off.float()).abs().max().item()
            ok = (got_d == want_d and got_a == want_a and collections.Counter(rec) == want
                  and out.shape == x.shape and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * scale
                  and err_off <= FUSED_VS_SPLIT_TOL[dtype] * scale)
            log(f"{what} forward, fused layer on, {str(dtype)[6:]}: batch {x.shape[0]}, kernel d "
                f"launches {got_d} (expect {want_d}), kernel a {got_a} (expect {want_a}), all on "
                f"channel-major activations; max abs err vs the plain versions {err:.3g} (tol "
                f"{MODEL_TOL[dtype]:g} x max(1, max|out|) = {MODEL_TOL[dtype] * scale:.3g}), vs "
                f"the switch off {err_off:.3g} (tol {FUSED_VS_SPLIT_TOL[dtype]:g} x the same) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{what} forward with the fused layer failed")
            launches[str(dtype)[6:]] = got_d
    return launches


def phase_pixel_fused_forward(cn, device, channels: int, size: int, shapes: list,
                              what: str) -> dict:
    """``phase_fused_forward`` of a pixel-space ControlNet at batch BATCH on
    seeded inputs: kernel d at ``shapes``, kernel a twice (head dim 4)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((BATCH, channels, size, size), generator=g, device=device)
    t = torch.randint(0, 1000, (BATCH,), generator=g, device=device)
    hint = (torch.rand((BATCH, 3, size, size), generator=g, device=device) < 0.15).float()
    with torch.inference_mode():
        feats = cn.hint_features(hint)
    return phase_fused_forward(cn, x, t, feats, shapes, 2, what)


def phase_mnist_fused_forward(cn, device) -> dict:
    return phase_pixel_fused_forward(cn, device, 1, 28, MNIST_PROJ_SHAPES, "MNIST")


def phase_proj_checks(cases: list, batch: int, device) -> dict:
    """Kernel d against its plain version once at ``cases`` ((L, C, heads,
    calls)), in each type that has a plan for the shape, on the channel-major
    view and on contiguous tokens; no timing.  Returns, by dtype name, the
    worst error over max|out| and the shapes run."""
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    out: dict = {}
    for l, c, heads, _ in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if not proj.fused_proj_supported(l, c, c, heads, dtype):
                continue  # a wide shape with no float32 plan
            xt, *params = proj_inputs(batch, l, c, dtype, device)
            x = xt.transpose(1, 2)
            with torch.inference_mode():
                ref = proj.fused_attention_proj_plain(x, *params, heads).float()
                err = max((proj.fused_attention_proj(v, *params, heads).float() - ref)
                          .abs().max().item() for v in (x, x.contiguous()))
            torch.cuda.synchronize()
            rel = err / ref.abs().max().item()
            ok = rel <= PROJ_TOL[dtype]
            log(f"attention_proj check {str(dtype)[6:]:8s} B {batch:2d} L {l:4d} C {c:3d} dh "
                f"{c // heads:3d}: plan: {proj_plan_text(l, c, heads, dtype, batch)}; err "
                f"{rel:.3g} of max|out| (tol {PROJ_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("fused projection + attention kernel disagrees with its "
                                 "plain version")
            entry = out.setdefault(str(dtype)[6:], {"max_rel_err": 0.0, "shapes": []})
            entry["max_rel_err"] = max(entry["max_rel_err"], rel)
            entry["shapes"].append([l, c, heads])
    return out


def proj_layouts(xt: torch.Tensor) -> dict:
    """Three layouts of the same (B, L, C) tokens from channel-major xt (B, C,
    L): the transposed view the model passes, contiguous tokens, and tokens
    whose rows are C + 4 channels apart (no TMA: the copy route)."""
    b, c, l = xt.shape
    x = xt.transpose(1, 2)
    padded = torch.zeros((b, l, c + 4), dtype=xt.dtype, device=xt.device)
    padded[:, :, :c] = x
    return {"channel-major": x, "tokens": x.contiguous(), "tokens, rows C + 4 apart":
            padded[:, :, :c]}


def phase_proj_edges(device) -> dict:
    """Kernel d in bf16 against its plain version at ``PROJ_EDGE_SHAPES`` on
    the three layouts of ``proj_layouts``, each call twice and the two
    outputs bit-equal.  Returns the worst error over max|out|, the calls and
    the routes x took."""
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    dtype = torch.bfloat16
    res = {"max_rel_err": 0.0, "calls": 0, "routes": collections.Counter()}
    for l, c, heads, b in PROJ_EDGE_SHAPES:
        xt, *params = proj_inputs(b, l, c, dtype, device)
        plan = proj.launch_plan(l, c, c, heads, dtype, b)
        with torch.inference_mode():
            ref = proj.fused_attention_proj_plain(xt.transpose(1, 2), *params, heads).float()
            scale = ref.abs().max().item()
            for name, x in proj_layouts(xt).items():
                route, vec = proj.x_route(tuple(x.shape), x.stride(), x.data_ptr(), plan.elems)
                one = proj.fused_attention_proj(x, *params, heads)
                two = proj.fused_attention_proj(x, *params, heads)
                torch.cuda.synchronize()
                rel = (one.float() - ref).abs().max().item() / scale
                equal = torch.equal(one, two)
                ok = rel <= PROJ_TOL[dtype] and equal and bool(torch.isfinite(one).all())
                log(f"attention_proj edge bf16 B {b} L {l:4d} C {c:3d} dh {c // heads:3d}, {name}"
                    f" (x by {proj.X_ROUTES[route]}, {vec} a copy): "
                    f"{proj_plan_text(l, c, heads, dtype, b)}; err {rel:.3g} of max|out| (tol "
                    f"{PROJ_TOL[dtype]:g}), two calls bit-equal {equal} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("fused projection + attention kernel fails at an edge shape")
                res["max_rel_err"] = max(res["max_rel_err"], rel)
                res["calls"] += 2
                res["routes"][proj.X_ROUTES[route]] += 1
    res["routes"] = dict(res["routes"])
    return res


# The concurrent clients of phase 16, run as ``python -c`` in a process of
# their own: argv = (url, number of clients), the request body on stdin.  Each
# thread posts the body once, all released together; prints one JSON object.
CLIENT_SCRIPT = """
import io, json, sys, threading, time, urllib.request
import numpy as np
url, n = sys.argv[1], int(sys.argv[2])
body = sys.stdin.buffer.read()
out = [None] * n
gate = threading.Barrier(n + 1)
def client(i):
    gate.wait()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                timeout=300) as r:
        status, rows, raw = r.status, int(r.headers["X-Batch-Rows"]), r.read()
    ms = (time.perf_counter() - t0) * 1e3
    with np.load(io.BytesIO(raw)) as z:
        s = z["samples"]
    out[i] = (status, rows, ms, list(s.shape), bool(np.isfinite(s).all()))
threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
for t in threads:
    t.start()
gate.wait()
t0 = time.perf_counter()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
assert all(o is not None for o in out), "a client failed"
print(json.dumps({"wall_s": wall, "statuses": [o[0] for o in out], "rows": [o[1] for o in out],
                  "client_ms": [o[2] for o in out], "shapes": [o[3] for o in out],
                  "finite": [o[4] for o in out]}))
"""


def _post(url: str, body: bytes, timeout: float = 300.0):
    """POST; returns (status, headers, body, client seconds)."""
    import urllib.error
    import urllib.request

    start = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=timeout) as r:
            status, headers, out = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, headers, out = e.code, dict(e.headers), e.read()
    return status, headers, out, time.perf_counter() - start


def _npz(**arrays) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def concurrent_clients(url: str, row) -> dict:
    """SERVE_CLIENTS one-row clients posting ``row`` to ``url``, released
    together, in a process of their own (threads of this process would share
    the interpreter lock with the server's dispatcher, which real clients do
    not)."""
    out = subprocess.run([sys.executable, "-c", CLIENT_SCRIPT, url, str(SERVE_CLIENTS)],
                         input=_npz(hints=row), capture_output=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"the concurrent clients failed: {out.stderr.decode()[-2000:]}")
    r = json.loads(out.stdout)
    lat = sorted(r["client_ms"])
    good = (r["statuses"] == [200] * SERVE_CLIENTS
            and r["shapes"] == [[1, 28, 28, 1]] * SERVE_CLIENTS and all(r["finite"]))
    return dict(requests_per_s=SERVE_CLIENTS / r["wall_s"], p50_ms=lat[len(lat) // 2],
                p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                mean_rows=sum(r["rows"]) / len(r["rows"]), max_rows=max(r["rows"]), good=good)


def phase_serve(config: dict, ckpt: str, device) -> dict:
    """The serving main path through the serve tool, on the card."""
    import io
    import threading
    import types
    import urllib.request

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj
    from controlnet_tpu_torch.sample.ddim import ddim_timesteps
    from controlnet_tpu_torch.tools import serve

    T = config["diffusion_params"]["num_timesteps"]
    hints = seeded_hints(SERVE_BATCH, 28)
    mid = SERVE_STEPS[0]  # the step count of the comparisons and the client runs

    def make_args(**kw):
        base = dict(config_path=os.path.join(REPO, "config", "mnist.yaml"),
                    model="dpm_controlnet", host="127.0.0.1", port=0, seed=SEED,
                    max_batch=SERVE_BATCH, max_steps=max(SERVE_STEPS), dynamic_batching=True,
                    batch_window_ms=2.0, ckpt=ckpt, device=None, attn_fused_proj=True)
        return types.SimpleNamespace(**{**base, **kw})

    def dispatchers() -> int:
        return sum(th.name == "serve-microbatcher" for th in threading.enumerate())

    @contextlib.contextmanager
    def serving(**kw):
        before = dispatchers()
        start = time.perf_counter()
        server = serve.make_server(make_args(**kw), config)
        warm_s = time.perf_counter() - start
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{server.server_address[1]}", warm_s
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)
            if thread.is_alive() or dispatchers() != before:
                raise SystemExit("the server did not shut down: its dispatcher thread is left")

    def batch_request(base: str, rows: np.ndarray, steps: int):
        status, headers, body, seconds = _post(f"{base}/generate_batch?steps={steps}",
                                               _npz(hints=rows))
        if status != 200:
            raise SystemExit(f"/generate_batch?steps={steps} answered {status}: {body[:200]!r}")
        with np.load(io.BytesIO(body)) as z:
            samples = z["samples"]
        return (samples, float(headers["X-Latency-Ms"]), int(headers["X-Batch-Rows"]),
                seconds * 1e3)

    def clients(base: str) -> dict:
        return concurrent_clients(f"{base}/generate_batch?steps={mid}", hints[:1])

    res: dict = {}
    with serving() as (base, warm_s), serving(attn_fused_proj=False) as (base_off, _), \
            serving(model="ddim_controlnet") as (base_ddim, _):
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        ok = health == {"status": "ok", "model": "dpm_controlnet", "warm": True,
                        "max_batch": SERVE_BATCH, "max_steps": max(SERVE_STEPS),
                        "batch_window_ms": 2.0}
        log(f"server: dpm_controlnet, fused layer on, warm in {warm_s:.2f} s (one generation "
            f"per bucket 1..{SERVE_BATCH}); /healthz {health} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("/healthz is wrong")
        first = batch_request(base, hints, SERVE_STEPS[0])
        log(f"the first request after warm-up ({SERVE_BATCH} rows, {SERVE_STEPS[0]} steps): "
            f"X-Latency-Ms {first[1]:.2f}")

        # the serving main path: counters set to 0 just before, read just after
        torch.cuda.synchronize()
        cuda_attention_proj.launches = 0
        cuda_attention.launches = 0
        calls = 0
        for steps in SERVE_STEPS:
            runs = [batch_request(base, hints, steps) for _ in range(3)]
            calls += 3 * len(ddim_timesteps(T, steps))
            ok = all(samples.shape == (SERVE_BATCH, 28, 28, 1) and samples.dtype == np.float32
                     and bool(np.isfinite(samples).all())
                     and float(np.abs(samples).max()) <= 1.0 and rows == SERVE_BATCH
                     for samples, _, rows, _ in runs)
            latency_ms, client_ms = (sorted(r[i] for r in runs)[1] for i in (1, 3))
            res[f"steps{steps}"] = dict(latency_ms=latency_ms, client_ms=client_ms)
            samples = runs[0][0]
            log(f"/generate_batch?steps={steps}, {SERVE_BATCH} rows, median of 3: X-Latency-Ms "
                f"{latency_ms:.2f} ({latency_ms / steps:.2f} ms/step), client {client_ms:.2f} ms, "
                f"samples {samples.shape} in [{samples.min():.3g}, {samples.max():.3g}] -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"/generate_batch at {steps} steps failed")
        res["launches_d"], res["launches_a"] = cuda_attention_proj.launches, cuda_attention.launches
        ok = res["launches_d"] == 24 * calls and res["launches_a"] == 2 * calls
        log(f"serving main path: {calls} model calls, kernel d launches {res['launches_d']} "
            f"(expect {24 * calls}), kernel a {res['launches_a']} (expect {2 * calls}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the served requests did not go through the kernels as expected")

        try:
            import PIL  # noqa: F401
            have_pil = True
        except ImportError:
            have_pil = False
        if have_pil:
            from PIL import Image

            from controlnet_tpu_torch.io.images import encode_sample_png

            status, headers, body, _ = _post(f"{base}/generate?steps={SERVE_STEPS[0]}",
                                             encode_sample_png(hints[0][:, :, :1] * 2 - 1))
            ok = status == 200 and Image.open(io.BytesIO(body)).size == (28, 28)
            log(f"/generate?steps={SERVE_STEPS[0]} (PNG in, PNG out): {status}, X-Batch-Rows "
                f"{headers.get('X-Batch-Rows')} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("/generate failed")
        else:
            log("/generate not driven: PIL does not import on this machine "
                "(/generate_batch needs numpy only)")

        bad = [_post(f"{base}/generate_batch?steps={s}", _npz(hints=hints))[0]
               for s in (max(SERVE_STEPS) + 1, "abc")]
        log(f"steps={max(SERVE_STEPS) + 1} and steps=abc answer {bad} (expect [400, 400])")
        if bad != [400, 400]:
            raise SystemExit("an out-of-range or unparseable steps was not a 400")

        # the same request to the three servers in turns (on, off, ddim, ddim, off, on)
        turns = [("on_ms", base), ("off_ms", base_off), ("ddim_ms", base_ddim)]
        seen: dict = {name: [] for name, _ in turns}
        for order in (turns, turns[::-1]) * 3:
            for name, url in order:
                seen[name].append(batch_request(url, hints, mid)[1])
        for name, vals in seen.items():
            vals.sort()
            res[name] = (vals[2] + vals[3]) / 2
        log(f"{SERVE_BATCH}-row request at {mid} steps, X-Latency-Ms, median of 6 taken in "
            f"turns: dpm_controlnet fused layer on {res['on_ms']:.2f} (range {seen['on_ms'][0]:.2f}"
            f"-{seen['on_ms'][-1]:.2f}), off {res['off_ms']:.2f} ({seen['off_ms'][0]:.2f}-"
            f"{seen['off_ms'][-1]:.2f}); ddim_controlnet on {res['ddim_ms']:.2f} "
            f"({seen['ddim_ms'][0]:.2f}-{seen['ddim_ms'][-1]:.2f})")

        res["batched"] = clients(base)
    with serving(dynamic_batching=False) as (base, _):
        res["unbatched"] = clients(base)
    for name in ("batched", "unbatched"):
        r = res[name]
        log(f"{SERVE_CLIENTS} concurrent one-row clients in another process, steps {mid}, "
            f"{'dynamic batching' if name == 'batched' else '--no-dynamic-batching'}: "
            f"{r['requests_per_s']:.3f} requests/s, client p50 {r['p50_ms']:.1f} ms, p99 "
            f"{r['p99_ms']:.1f} ms, X-Batch-Rows mean {r['mean_rows']:.2f}, max {r['max_rows']}")
    ok = (res["batched"]["good"] and res["unbatched"]["good"] and res["batched"]["max_rows"] > 1
          and res["unbatched"]["max_rows"] == 1)
    if not ok:
        raise SystemExit("concurrent clients: bad samples, or batching did not behave")

    # a pinned x_T through build_generator: kernels against the plain versions
    g = torch.Generator(device=device).manual_seed(SEED)
    x_start = torch.randn((SERVE_BATCH, 1, 28, 28), generator=g, device=device)
    gen = serve.build_generator(make_args(), config)[0]
    out_k = gen(hints, None, 4, x_start=x_start)
    with plain_attention(), plain_attention_proj():
        out_p = gen(hints, None, 4, x_start=x_start)
    err = (out_k - out_p).abs().max().item()
    ok = (out_k.shape == (SERVE_BATCH, 1, 28, 28) and bool(torch.isfinite(out_k).all())
          and err <= MODEL_TOL[torch.float32])
    log(f"generate, 4 steps, x_T pinned, batch {SERVE_BATCH}: max abs err kernels vs plain "
        f"versions {err:.3g} (tol {MODEL_TOL[torch.float32]:g}; samples in [-1, 1]) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the served sample disagrees with the plain versions")

    # device time of one generation, switch on and off: the wall time of a run
    # without the profiler, then the device time of the same run under it
    for name, on in (("on", True), ("off", False)):
        gen = serve.build_generator(make_args(attn_fused_proj=on), config)[0]
        gen(hints, None, mid, x_start=x_start)
        torch.cuda.synchronize()
        start = time.perf_counter()
        gen(hints, None, mid, x_start=x_start).cpu()
        wall_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device alone, as phase 8's
            gen(hints, None, mid, x_start=x_start)
            torch.cuda.synchronize()
        kernels = device_events(prof)
        dev_ms = device_span_ms(kernels)
        d_ms = sum(_device_ms(e) for e in kernels if is_kernel_d(e.name))
        a_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name))
        res[f"profile_{name}"] = dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
                                      kernels=len(kernels), d_ms=d_ms, a_ms=a_ms)
        log(f"one {SERVE_BATCH}-row {mid}-step generation, fused layer {name}: {wall_ms:.2f} ms on "
            f"the host clock; under the profiler {dev_ms:.2f} ms of device time (busy "
            f"{dev_ms / wall_ms:.3f}), {len(kernels)} kernels, kernel d {d_ms:.3f} ms, kernel a "
            f"{a_ms:.3f} ms")
    return res


# ---------------------------------------------------------------------------
# Phases 17-20: consistency and DMD distillation of the MNIST ControlNet
# ---------------------------------------------------------------------------

DISTILL_KINDS = ("ddpm_distillation", "consistency_only", "manual", "dmd")
# (kernel a, kernel b) launches per distillation step: the student's 16
# attention layers forward and backward, plus the frozen ControlNet teacher's
# 26 forward (or, in consistency_only, the EMA target's 16)
DISTILL_CALLS = {"ddpm_distillation": (42, 16), "consistency_only": (32, 16), "manual": (42, 16),
                 "dmd": (42, 16)}
STUDENT_CALLS = 16  # kernel a launches per student forward (its 16 attention layers)
MODE_FLAGS = {"ddpm_distillation": {}, "consistency_only": {"use_consistency_only": True},
              "manual": {"use_ddpm_distillation": False}}
DISTILL_MAIN = ("ddpm_distillation", "dmd")  # the timed main path of phase 19
SAMPLE_REPS = 5       # timed 1-step generations of batch 64 per sample tool
DMD_TEST_IMAGES = 5 * BATCH  # the DMD trainer validates on 5 test batches


def seeded_teacher(ckpt: str) -> dict:
    return torch.load(ckpt, map_location="cpu", weights_only=True)


def distill_setup(config: dict, teacher_sd: dict, device, kind: str, dtype_name: str,
                  mesh=None):
    """The trainer tool's (model, train state, step) for ``kind`` (a
    consistency mode or "dmd") at ``dtype_name`` compute, student from SEED,
    teacher from ``teacher_sd``, data-parallel over ``mesh`` when given.  The
    DMD student's zero-initialised last hint conv is made nonzero so the hint
    path takes gradient from the first step."""
    from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_tool
    from controlnet_tpu_torch.tools import (
        train_distribution_matching_controlnet_distilled as dmd_tool)

    cfg = copy.deepcopy(config)
    cfg["train_params"]["compute_dtype"] = dtype_name
    if kind == "dmd":
        model, state, step = dmd_tool.make_trainer(cfg, teacher_sd, 100, device, seed=SEED,
                                                   mesh=mesh)
        with torch.no_grad():
            model.student.hint_block[-1].weight.normal_(0.0, 0.05)
            model.student.hint_block[-1].bias.normal_(0.0, 0.05)
        return model, state, step
    cfg["train_params"].update(MODE_FLAGS[kind])
    model, state, step, _ = cd_tool.make_trainer(cfg, teacher_sd, device, seed=SEED, mesh=mesh)
    return model, state, step


def frozen_modules(model) -> dict:
    """The frozen parts of a distillation model (teacher, EMA, features)."""
    return {name: m for name, m in model.named_children() if name != "student"}


def run_distill_phases(config: dict, ckpt: str, device, dpm_4step_ms: float | None,
                       timed: bool = True):
    """Phases 17-20 in order; returns their results.  ``timed`` False leaves
    phase 19's timed part to another group's fresh process (None here)."""
    torch.cuda.empty_cache()
    students = phase_student_forwards(config, device)
    parity = phase_distill_parity(config, seeded_teacher(ckpt), device)
    torch.cuda.empty_cache()
    distill_main = in_fresh_process("phase_distill_main_path", ckpt) if timed else None
    distill_tools = phase_distill_tools(config, ckpt, device)
    served = phase_serve_students(config, distill_tools["paths"], device, dpm_4step_ms)
    return students, parity, distill_main, distill_tools, served


def phase_student_forwards(config: dict, device) -> dict:
    """Phase 17: the full-width consistency and DMD students at batch 64 with
    seeded weights, through kernel a against the plain attention, on float32
    and on bf16 inputs; 16 kernel-a launches per forward; the output type of
    each (the consistency student runs in float32 whatever its input)."""
    from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
    from controlnet_tpu_torch.models.dmd import DistributionMatchingControlNet
    from controlnet_tpu_torch.ops import cuda_attention

    mp = config["model_params"]
    torch.manual_seed(SEED)
    cd = ConsistencyDistilled(mp["im_channels"], mp, use_ddpm_teacher=False, device=device)
    dmd = DistributionMatchingControlNet(mp["im_channels"], mp)
    with torch.no_grad():
        dmd.hint_block[-1].weight.normal_(0.0, 0.05)
    dmd = dmd.to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((BATCH, 1, 28, 28), generator=g, device=device)
    sigma = cd.sample_sigmas(BATCH, g)
    t = torch.randint(0, 1000, (BATCH,), generator=g, device=device)
    hint = (torch.rand((BATCH, 3, 28, 28), generator=g, device=device) < 0.15).float()
    want = {("consistency", torch.float32): torch.float32,
            ("consistency", torch.bfloat16): torch.float32,
            ("dmd", torch.float32): torch.float32, ("dmd", torch.bfloat16): torch.bfloat16}
    res = {}
    with torch.inference_mode():
        for name, fn in (("consistency", lambda xx, hh: cd.student(xx, sigma, hh)),
                         ("dmd", lambda xx, hh: dmd(xx, t, hh))):
            for dtype in (torch.float32, torch.bfloat16):
                xin, hin = x.to(dtype), hint.to(dtype)
                torch.cuda.synchronize()
                before = cuda_attention.launches
                out = fn(xin, hin)
                torch.cuda.synchronize()
                launched = cuda_attention.launches - before
                with plain_attention():
                    ref = fn(xin, hin)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = MODEL_TOL[out.dtype]
                ok = (launched == STUDENT_CALLS and out.dtype == want[(name, dtype)]
                      and bool(torch.isfinite(out).all()) and err <= tol * max(scale, 1.0))
                log(f"{name} student forward on {str(dtype)[6:]} inputs: batch {BATCH}, output "
                    f"{str(out.dtype)[6:]} (expect {str(want[(name, dtype)])[6:]}), kernel a "
                    f"launches {launched} (expect {STUDENT_CALLS}), max|out| {scale:.4g}, max abs "
                    f"err vs plain {err:.3g} (tol {tol:g} x max(1, max|out|)) -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"the {name} student's forward failed")
                res[f"{name}_{str(dtype)[6:]}"] = dict(out_dtype=str(out.dtype)[6:],
                                                       launches=launched, max_abs_err=err)
    return res


def _distill_steps(config, teacher_sd, images, device, kind: str, dtype_name: str,
                   plain: bool) -> dict:
    """CHECK_STEPS steps of ``kind`` from one start and one generator, through
    the kernels or (``plain``) the plain attention forward and backward."""
    from controlnet_tpu_torch.ops import cuda_attention

    model, state, step = distill_setup(config, teacher_sd, device, kind, dtype_name)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, grads, noisy, counts = [], None, {}, []
    with plain_attention() if plain else contextlib.nullcontext():
        for batch, hints in train_batches(images, CHECK_STEPS):
            torch.cuda.synchronize()
            a0, b0 = cuda_attention.launches, cuda_attention.bwd_launches
            metrics = step(batch, hints, g)
            torch.cuda.synchronize()
            counts.append((cuda_attention.launches - a0, cuda_attention.bwd_launches - b0))
            losses.append(metrics.get("total_loss", metrics.get("consistency_loss")))
            for k, p in state.params.items():
                gr = p.grad if p.grad is not None else torch.zeros_like(p)
                low = gr.abs() < NOISE_FLOOR
                noisy[k] = low if k not in noisy else noisy[k] | low
            if grads is None:
                grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
                         for k, p in state.params.items()}
    after = {k: p.detach().clone() for k, p in state.params.items()}
    ema = ({k: v.detach().clone() for k, v in model.ema_teacher.state_dict().items()}
           if kind != "dmd" else None)
    return dict(losses=torch.stack(losses).float().cpu(), grads=grads, before=before,
                after=after, noisy=noisy, ema=ema, counts=counts)


def _weights_diff(a: dict, b: dict, before: dict, noisy: dict) -> dict:
    """Max |a - b| over the weights whose gradients stayed above the noise
    floor in both runs, mean |a - b| over all, and the cosine of the two
    updates; in units of the weights, not yet of lr."""
    clean, allw, upd_a, upd_b = [], [], [], []
    for k in before:
        d = (a[k] - b[k]).abs()
        clean.append(d[~noisy[k]].flatten())
        allw.append(d.flatten())
        upd_a.append((a[k] - before[k]).flatten())
        upd_b.append((b[k] - before[k]).flatten())
    clean, allw, upd_a, upd_b = (torch.cat(x).double() for x in (clean, allw, upd_a, upd_b))
    cos = (upd_a @ upd_b / (upd_a.norm() * upd_b.norm()).clamp(min=1e-30)).item()
    return dict(clean_max=clean.max().item() if clean.numel() else 0.0, mean=allw.mean().item(),
                cos=cos, clean_share=clean.numel() / allw.numel())


def phase_distill_parity(config: dict, teacher_sd: dict, device) -> dict:
    """Phase 18: CHECK_STEPS steps of each consistency mode and of DMD through
    kernels a and b against the same steps with the plain attention, from one
    generator, f32 and bf16: the losses and the first step's gradients
    within MODEL_TOL (relative), the weights and the EMA after on the
    noise-floor rule of phase 7 (f32: within 1e-2 lr where the gradients
    stayed above the floor; bf16: mean |difference| under 0.15 lr and an
    update cosine over 0.97).  DMD's gradient jumps with rounding-level
    changes of x0 (the pixels are sorted, the feature moments cubed): in
    float32 its weights are held by mean |difference| under 0.05 lr and an
    update cosine over 0.999; in bf16 the gradient is dominated by rounding,
    and the kernel route is held to be no farther from a float32 plain run
    than the bf16 plain route is (1.5x, gradients and weights).  The launches of
    every step are held to DISTILL_CALLS.  Then a DMD step on a batch with a
    NaN: parameters, moments and count bit-identical, ``skipped`` 1."""
    from controlnet_tpu_torch.data.datasets import to_unit

    images = torch.from_numpy(to_unit(seeded_digits(4 * BATCH)))[:, None].to(device)
    lr = {k: config["train_params"]["consistency_lr"] for k in DISTILL_KINDS}
    lr["dmd"] = config["train_params"]["distribution_matching_lr"]
    res: dict = {}
    for kind in DISTILL_KINDS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            k = _distill_steps(config, teacher_sd, images, device, kind, name, plain=False)
            p = _distill_steps(config, teacher_sd, images, device, kind, name, plain=True)
            noisy = {w: k["noisy"][w] | p["noisy"][w] for w in k["noisy"]}
            loss_err = ((k["losses"] - p["losses"]).abs().max()
                        / p["losses"].abs().max().clamp(min=1.0)).item()
            gmax = max(v.abs().max().item() for v in p["grads"].values())
            grad_err = max((k["grads"][w] - p["grads"][w]).abs().max().item()
                           for w in p["grads"]) / gmax
            wd = _weights_diff(k["after"], p["after"], k["before"], noisy)
            ema = (_weights_diff(k["ema"], p["ema"], k["before"], noisy)
                   if k["ema"] is not None else None)
            counts_ok = (k["counts"] == [DISTILL_CALLS[kind]] * CHECK_STEPS
                         and p["counts"] == [(0, 0)] * CHECK_STEPS)
            ok = (counts_ok and bool(torch.isfinite(k["losses"]).all())
                  and loss_err <= MODEL_TOL[dtype])
            extra = ""
            if kind == "dmd" and dtype == torch.bfloat16:
                f = _distill_steps(config, teacher_sd, images, device, kind, "float32", plain=True)

                def gdist(a):
                    return sum(((a[w] - f["grads"][w]) ** 2).sum().item() for w in a) ** 0.5

                gk, gp = gdist(k["grads"]), gdist(p["grads"])
                wk = _weights_diff(k["after"], f["after"], k["before"], noisy)["mean"]
                wp = _weights_diff(p["after"], f["after"], k["before"], noisy)["mean"]
                ok = ok and gk <= 1.5 * gp and wk <= 1.5 * wp
                extra = (f"; from a float32 plain run: gradient distance kernel {gk:.4g} vs plain "
                         f"{gp:.4g}, weights mean |diff| kernel {wk / lr[kind]:.3g} lr vs plain "
                         f"{wp / lr[kind]:.3g} lr (kernel <= 1.5x plain)")
                res[f"{kind}_{name}_vs_f32"] = dict(grad_kernel=gk, grad_plain=gp,
                                                    weights_kernel_lr=wk / lr[kind],
                                                    weights_plain_lr=wp / lr[kind])
            elif kind == "dmd":
                # the sort of the Wasserstein term and the cubed moments make
                # DMD's gradient jump with rounding-level changes of x0
                # (first-step gradients 3.4e-5 apart, where the consistency
                # modes' are 2e-7), and Adam turns each jump into O(lr)
                ok = (ok and grad_err <= MODEL_TOL[dtype] and wd["mean"] < 0.05 * lr[kind]
                      and wd["cos"] > 0.999)
            else:
                ok = ok and grad_err <= MODEL_TOL[dtype]
                for d in (wd, ema) if ema is not None else (wd,):
                    if dtype == torch.bfloat16:
                        ok = ok and d["mean"] < 0.15 * lr[kind] and d["cos"] > 0.97
                    else:
                        ok = ok and d["clean_max"] < 1e-2 * lr[kind]
            ema_txt = ("" if ema is None else
                       f", EMA after max |diff| {ema['clean_max'] / lr[kind]:.3g} lr, mean "
                       f"{ema['mean'] / lr[kind]:.3g} lr")
            log(f"distillation {kind} {name}, {CHECK_STEPS} steps kernels vs plain attention: "
                f"launches a/b per step {k['counts']} (expect {DISTILL_CALLS[kind]}), losses "
                f"{[round(x, 5) for x in k['losses'].tolist()]} (rel err {loss_err:.3g}), "
                f"first-step grads rel err {grad_err:.3g} (tol {MODEL_TOL[dtype]:g}); weights "
                f"after: max |diff| {wd['clean_max'] / lr[kind]:.3g} lr over the "
                f"{wd['clean_share']:.3f} above {NOISE_FLOOR:g}, mean {wd['mean'] / lr[kind]:.3g} "
                f"lr, update cosine {wd['cos']:.6f}{ema_txt}{extra} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"distillation {kind} ({name}) through the kernels disagrees "
                                 "with plain attention")
            res[f"{kind}_{name}"] = dict(loss_err=loss_err, grad_err=grad_err,
                                         weights_clean_max_lr=wd["clean_max"] / lr[kind],
                                         weights_mean_lr=wd["mean"] / lr[kind], cos=wd["cos"],
                                         counts=k["counts"][0])
    res["nan_guard"] = phase_dmd_nan_guard(config, teacher_sd, images, device)
    return res


def phase_dmd_nan_guard(config: dict, teacher_sd: dict, images, device) -> dict:
    """One good DMD step, then one on a batch with a NaN: nothing of the state
    moves (parameters, moments, count), ``skipped`` is 1 and ``grad_norm`` 0,
    and the step read nothing back to the host (its metrics stay on the
    card)."""
    _, state, step = distill_setup(config, teacher_sd, device, "dmd", "float32")
    g = torch.Generator(device=device).manual_seed(SEED)
    (batch, hints), = list(train_batches(images, 1))
    step(batch, hints, g)
    params = {k: p.detach().clone() for k, p in state.params.items()}
    opt = state.optimizer.state_dict()
    bad = batch.clone()
    bad[3, 0, 10, 10] = float("nan")
    metrics = step(bad, hints, g)
    torch.cuda.synchronize()
    same = (all(torch.equal(p.detach(), params[k]) for k, p in state.params.items())
            and all(torch.equal(v, state.optimizer.state_dict()[k]) for k, v in opt.items()))
    on_card = all(v.device == batch.device for v in metrics.values())
    ok = (same and on_card and metrics["skipped"].item() == 1.0
          and metrics["grad_norm"].item() == 0.0 and state.optimizer.count.item() == 1)
    log(f"DMD step on a batch with a NaN: loss {metrics['total_loss'].item()}, skipped "
        f"{metrics['skipped'].item():g}, grad_norm {metrics['grad_norm'].item():g}; parameters, "
        f"moments and count bit-identical {same}, metrics on the card {on_card} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the DMD step moved its state on a non-finite loss")
    return dict(skipped=metrics["skipped"].item(), state_unchanged=same)


def phase_distill_main_path(ckpt: str, device) -> dict:
    """Phase 19, timed part (in a process of its own): TRAIN_STEPS steps of
    ``ddpm_distillation`` and of DMD at batch 64, full width, hints from the
    port's canny on the card, f32 and bf16.  Counters set to 0 just before
    the timed run and read just after; ms/step on the host clock; then a
    short torch.profiler window for device time and busy share.  The
    trainable weights must move, the teacher (and feature extractor) stay
    bit-identical."""
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.data.datasets import to_unit
    from controlnet_tpu_torch.ops import cuda_attention

    config = mnist_config()
    teacher_sd = seeded_teacher(ckpt)
    images = torch.from_numpy(to_unit(seeded_digits(8 * BATCH)))[:, None].to(device)
    results: dict = {torch.float32: {}, torch.bfloat16: {}}
    for kind in DISTILL_MAIN:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            model, state, step = distill_setup(config, teacher_sd, device, kind, name)
            s_before = {k: p.detach().clone() for k, p in state.params.items()}
            f_before = {n: {k: v.clone() for k, v in m.state_dict().items()}
                        for n, m in frozen_modules(model).items() if n != "ema_teacher"}
            g = torch.Generator(device=device).manual_seed(SEED)
            for batch, hints in train_batches(images, TRAIN_WARMUP, epoch=100):
                step(batch, hints, g)
            data = list(train_batches(images, TRAIN_STEPS + PROFILE_STEPS))
            torch.cuda.synchronize()
            cuda_attention.launches = 0
            cuda_attention.bwd_launches = 0
            start = time.perf_counter()
            losses = [step(batch, hints, g) for batch, hints in data[:TRAIN_STEPS]]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            fwd, bwd = cuda_attention.launches, cuda_attention.bwd_launches
            key = "total_loss"
            losses = torch.stack([m[key] for m in losses]).float()
            # the device alone, as phase 25's and 34's windows: each comes after
            # its process's time_calls, never before them (a device-only window
            # makes later time_calls windows lose records)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for batch, hints in data[TRAIN_STEPS:]:
                    step(batch, hints, g)
                torch.cuda.synchronize()
            kernels = device_events(prof)
            dev_ms = device_span_ms(kernels) / PROFILE_STEPS
            a_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name)) / PROFILE_STEPS
            b_ms = sum(_device_ms(e) for e in kernels if "attention_bwd_" in e.name) / PROFILE_STEPS
            trained = [k for k, p in state.params.items() if p.grad is not None]
            moved = all(not torch.equal(state.params[k].detach(), s_before[k]) for k in trained)
            still = all(torch.equal(v, f_before[n][k]) for n, m in frozen_modules(model).items()
                        if n in f_before for k, v in m.state_dict().items())
            ms_step = seconds * 1e3 / TRAIN_STEPS
            want_a, want_b = DISTILL_CALLS[kind]
            ok = (fwd == want_a * TRAIN_STEPS and bwd == want_b * TRAIN_STEPS
                  and bool(torch.isfinite(losses).all()) and moved and still)
            results[dtype][kind] = dict(
                ms_per_step=ms_step, steps_per_s=TRAIN_STEPS / seconds, launches=fwd,
                bwd_launches=bwd, device_ms_per_step=dev_ms, busy=dev_ms / ms_step,
                kernels_per_step=len(kernels) / PROFILE_STEPS, attn_fwd_device_ms=a_ms,
                attn_bwd_device_ms=b_ms, loss_first=losses[0].item(), loss_last=losses[-1].item())
            log(f"distillation main path {kind} {name}: {TRAIN_STEPS} steps, batch {BATCH}: "
                f"{seconds:.3f} s, {ms_step:.3f} ms/step, {TRAIN_STEPS / seconds:.3f} steps/s, "
                f"launches a {fwd} (expect {want_a * TRAIN_STEPS}), b {bwd} (expect "
                f"{want_b * TRAIN_STEPS}), loss {losses[0].item():.4f} -> {losses[-1].item():.4f}, "
                f"student moved {moved} ({len(trained)} of {len(s_before)} tensors take "
                f"gradient), teacher unchanged {still} | profile ({PROFILE_STEPS} steps): device "
                f"{dev_ms:.3f} ms/step, busy {dev_ms / ms_step:.3f}, "
                f"{len(kernels) / PROFILE_STEPS:.1f} kernels/step, kernel a {a_ms:.3f} ms/step, "
                f"kernel b {b_ms:.3f} ms/step -> {'ok' if ok else 'FAIL'}")
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + _device_ms(e) / PROFILE_STEPS
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"distillation {kind} {name} top device kernels (ms/step): "
                + "; ".join(f"{k.replace('void ', '')[:56]} {v:.3f}" for k, v in top))
            if not ok:
                raise SystemExit(f"distillation main path ({kind}, {name}) failed")
            del model, state, step
    return results


def phase_distill_tools(config: dict, ckpt: str, device) -> dict:
    """Phase 19, tools: both distillation trainer tools for one epoch over
    TOOL_IMAGES seeded images, then resumed to a second epoch (DMD with a
    seeded test split of 5 batches, its best checkpoint and sidecar
    written); then each sample tool on the written .pth: ``main`` once, and
    1-step generation at batch 64 timed (samples/s), 4-step for consistency,
    with kernel a's launches counted around the timed calls."""
    import numpy as np
    import yaml

    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.tools import sample_consistency_controlnet_distilled as cd_sample
    from controlnet_tpu_torch.tools import (
        sample_distribution_matching_controlnet_distilled as dmd_sample)
    from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train
    from controlnet_tpu_torch.tools import (
        train_distribution_matching_controlnet_distilled as dmd_train)

    work = os.path.join(REPO, "build", "smoke", "distill")
    shutil.rmtree(work, ignore_errors=True)
    task = os.path.join(work, "mnist")
    os.makedirs(task)
    shutil.copy(ckpt, os.path.join(task, config["train_params"]["controlnet_ckpt_name"]))
    digits = seeded_digits(TOOL_IMAGES + DMD_TEST_IMAGES)
    paths = {name: os.path.join(work, f"{name}.npy") for name in ("train", "test")}
    np.save(paths["train"], digits[:TOOL_IMAGES])
    np.save(paths["test"], digits[TOOL_IMAGES:])

    def config_path(epochs: int) -> str:
        cfg = copy.deepcopy(config)
        cfg["train_params"].update(task_name=task, consistency_epochs=epochs,
                                   distribution_matching_epochs=epochs, ckpt_save_every_epochs=1)
        path = os.path.join(work, f"mnist_{epochs}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    start = time.perf_counter()
    cd_runs = [cd_train.train(config_path(e), paths["train"]) for e in (1, 2)]
    cd_s = time.perf_counter() - start
    start = time.perf_counter()
    dmd_runs = [dmd_train.train(config_path(e), paths["train"], paths["test"]) for e in (1, 2)]
    dmd_s = time.perf_counter() - start
    with open(os.path.join(task, dmd_train.BEST_VAL)) as f:
        best = json.load(f)
    files = [os.path.join(task, "consistency_controlnet_distilled", "2.pt"),
             os.path.join(task, cd_train.CKPT_NAME),
             os.path.join(task, "distribution_matching_controlnet_distilled", "2.pt"),
             os.path.join(task, "distribution_matching_controlnet_best", f"{best['epoch']}.pt"),
             os.path.join(task, dmd_train.REF_CKPT), os.path.join(task, dmd_train.BEST_REF_CKPT)]
    ok = (all(os.path.exists(p) for p in files)
          and [r["epochs"] for r in cd_runs] == [[1], [2]]
          and [r["epochs"] for r in dmd_runs] == [[1], [2]]
          and all(np.isfinite(r["losses"]).all() for r in cd_runs)
          and all(np.isfinite(r["val_loss"]).all() for r in dmd_runs)
          and best["best_val"] == min(dmd_runs[0]["val_loss"] + dmd_runs[1]["val_loss"]))
    log(f"distillation trainer tools: consistency (ddpm_distillation) 1 epoch then resumed to 2 "
        f"over {TOOL_IMAGES} images ({cd_s:.1f} s; epoch losses "
        f"{[round(r['losses'][0], 4) for r in cd_runs]}); DMD likewise with {DMD_TEST_IMAGES} "
        f"test images ({dmd_s:.1f} s; val {[round(r['val_loss'][0], 4) for r in dmd_runs]}, "
        f"best {best}); checkpoints, reference .pth files and sidecar written -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the distillation trainer tools failed")

    cfg2 = config_path(2)
    for tool, extra in ((cd_sample, ["--num_steps", "4"]), (dmd_sample, ["--use_best"])):
        out = tool.main(["--config", cfg2, "--mode", "custom", "--num_samples", str(BATCH),
                         *extra])
        if out["x0"].shape != (BATCH, 1, 28, 28) or not bool(torch.isfinite(out["x0"]).all()):
            raise SystemExit(f"{tool.__name__} main failed")
    hints = torch.from_numpy(seeded_hints(BATCH, 28)).permute(0, 3, 1, 2).contiguous().to(device)
    cd_model = cd_sample.load_student(config, os.path.join(task, cd_train.CKPT_NAME))
    dmd_student = dmd_sample.load_student(config, dmd_sample.default_ckpt(task, True))
    T = config["diffusion_params"]["num_timesteps"]
    runs = {"consistency_1step": (lambda gen: cd_sample.generate(cd_model, hints, 1, gen), 1),
            "consistency_4step": (lambda gen: cd_sample.generate(cd_model, hints, 4, gen), 4),
            "dmd_1step": (lambda gen: dmd_sample.generate(dmd_student, hints, T, gen), 1)}
    res: dict = {"tools_s": {"consistency": cd_s, "dmd": dmd_s}, "best": best}
    for name, (fn, calls) in runs.items():
        gen = torch.Generator(device=device).manual_seed(SEED)
        for _ in range(2):
            fn(gen)
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        start = time.perf_counter()
        outs = [fn(gen) for _ in range(SAMPLE_REPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launched = cuda_attention.launches
        ok = (launched == STUDENT_CALLS * calls * SAMPLE_REPS
              and all(bool(torch.isfinite(o).all()) for o in outs)
              and outs[0].shape == (BATCH, 1, 28, 28))
        res[name] = dict(ms=seconds * 1e3 / SAMPLE_REPS,
                         samples_per_s=BATCH * SAMPLE_REPS / seconds, launches=launched)
        log(f"sample tool {name}, batch {BATCH}, {SAMPLE_REPS} generations: "
            f"{seconds * 1e3 / SAMPLE_REPS:.3f} ms each, {BATCH * SAMPLE_REPS / seconds:.1f} "
            f"samples/s, kernel a launches {launched} (expect "
            f"{STUDENT_CALLS * calls * SAMPLE_REPS}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the sample tool's {name} generation failed")
    res["paths"] = {"consistency": os.path.join(task, cd_train.CKPT_NAME),
                    "dmd": dmd_sample.default_ckpt(task, True)}
    return res


def somaxconn() -> str:
    """The kernel's cap on a listen backlog: a burst of connections past it
    waits out TCP's 1 s SYN retry."""
    try:
        with open("/proc/sys/net/core/somaxconn") as f:
            return f.read().strip()
    except OSError:
        return "unknown"


def phase_serve_students(config: dict, ckpts: dict, device, dpm_4step_ms: float) -> dict:
    """Phase 20: the serve tool's ``consistency`` and ``dmd`` models on the
    .pth files of phase 19, buckets up to 16, fused switch off: /healthz;
    /generate_batch of 16 rows at steps=1 (and 4 for consistency) with the
    counters set to 0 just before and read just after (16 kernel-a launches
    per model call, none of b); a pinned-x_T batch through
    ``build_generator``, kernels against plain; 32 concurrent one-row
    clients at steps=1."""
    import io
    import threading
    import types
    import urllib.request

    import numpy as np

    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.tools import serve

    hints = seeded_hints(SERVE_BATCH, 28)
    res: dict = {}
    for model in ("consistency", "dmd"):
        args = types.SimpleNamespace(
            config_path=os.path.join(REPO, "config", "mnist.yaml"), model=model,
            host="127.0.0.1", port=0, seed=SEED, max_batch=SERVE_BATCH, max_steps=8,
            dynamic_batching=True, batch_window_ms=2.0, ckpt=ckpts[model], device=None,
            attn_fused_proj=False)
        start = time.perf_counter()
        server = serve.make_server(args, config)
        warm_s = time.perf_counter() - start
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
            if health.get("model") != model or not health.get("warm"):
                raise SystemExit(f"/healthz of the {model} server is wrong: {health}")
            steps_list = (1, 4) if model == "consistency" else (1,)
            torch.cuda.synchronize()
            cuda_attention.launches = 0
            cuda_attention.bwd_launches = 0
            calls, out = 0, {}
            for steps in steps_list:
                lat = []
                for _ in range(3):
                    status, headers, body, _ = _post(f"{base}/generate_batch?steps={steps}",
                                                     _npz(hints=hints))
                    with np.load(io.BytesIO(body)) as z:
                        samples = z["samples"]
                    if (status != 200 or samples.shape != (SERVE_BATCH, 28, 28, 1)
                            or not np.isfinite(samples).all()
                            or headers["X-Batch-Rows"] != str(SERVE_BATCH)):
                        raise SystemExit(f"{model} /generate_batch?steps={steps} failed")
                    lat.append(float(headers["X-Latency-Ms"]))
                calls += 3 * (steps if model == "consistency" else 1)
                out[f"steps{steps}_ms"] = sorted(lat)[1]
                log(f"{model} /generate_batch?steps={steps}, {SERVE_BATCH} rows, median of 3: "
                    f"X-Latency-Ms {sorted(lat)[1]:.2f}, samples in [{samples.min():.3g}, "
                    f"{samples.max():.3g}]")
            launched_a, launched_b = cuda_attention.launches, cuda_attention.bwd_launches
            ok = launched_a == STUDENT_CALLS * calls and launched_b == 0
            log(f"{model} serving: {calls} model calls, kernel a launches {launched_a} (expect "
                f"{STUDENT_CALLS * calls}), kernel b {launched_b} (expect 0) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the {model} requests did not go through kernel a as expected")
            out["clients"] = concurrent_clients(f"{base}/generate_batch?steps=1", hints[:1])
            c = out["clients"]
            log(f"{model}: {SERVE_CLIENTS} concurrent one-row clients in another process, steps "
                f"1: {c['requests_per_s']:.3f} requests/s, client p50 {c['p50_ms']:.1f} ms, p99 "
                f"{c['p99_ms']:.1f} ms, X-Batch-Rows mean {c['mean_rows']:.2f}, max "
                f"{c['max_rows']} (the host's listen backlog cap, net.core.somaxconn: "
                f"{somaxconn()})")
            if not c["good"]:
                raise SystemExit(f"{model}: the concurrent clients got bad samples")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)
        if thread.is_alive():
            raise SystemExit(f"the {model} server did not shut down")
        gen = serve.build_generator(args, config)[0]
        x_start = torch.randn((SERVE_BATCH, 1, 28, 28),
                              generator=torch.Generator(device=device).manual_seed(SEED),
                              device=device)
        for steps in steps_list:
            out_k = gen(hints, torch.Generator(device=device).manual_seed(1), steps, x_start)
            with plain_attention():
                out_p = gen(hints, torch.Generator(device=device).manual_seed(1), steps, x_start)
            scale = out_p.abs().max().item()
            err = (out_k - out_p).abs().max().item()
            ok = (bool(torch.isfinite(out_k).all())
                  and err <= MODEL_TOL[torch.float32] * max(scale, 1))
            log(f"{model} generate, {steps} step(s), x_T pinned, batch {SERVE_BATCH}: max abs err "
                f"kernels vs plain {err:.3g} (tol {MODEL_TOL[torch.float32]:g} x max(1, "
                f"max|out| {scale:.3g}); not clamped) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the served {model} sample disagrees with the plain version")
        out.update(warm_s=warm_s, launches=launched_a, calls=calls)
        res[model] = out
    log(f"served {SERVE_BATCH}-row latency (X-Latency-Ms): consistency 1 step "
        f"{res['consistency']['steps1_ms']:.2f}, dmd 1 step {res['dmd']['steps1_ms']:.2f}, "
        f"consistency 4 steps {res['consistency']['steps4_ms']:.2f}; the teacher "
        f"(dpm_controlnet, fused layer on) at 4 steps in phase 16: "
        f"{'not run' if dpm_4step_ms is None else f'{dpm_4step_ms:.2f}'}")
    return res


# ---------------------------------------------------------------------------
# Phases 21-26: CelebA-HQ latent training (config/celebhq.yaml, full width)
# ---------------------------------------------------------------------------

LATENT_KINDS = ("vae", "ldm", "controlnet")
# launches of kernels a, b and c per train step of each latent trainer
LATENT_CALLS = {"vae": (0, 0, 0), "ldm": (14, 14, 0), "controlnet": (22, 14, 7)}
LATENT_BATCH = {"vae": 4, "ldm": LDM_BATCH, "controlnet": LDM_BATCH}  # train_params' batches
LATENT_STEPS_PER_EPOCH = 10**6  # no LR milestone falls inside a run here
LATENT_PROFILE_STEPS = 1  # the f32 VAE-GAN step launches ~35,000 kernels


@functools.lru_cache(maxsize=1)
def seeded_ldm_state_dict() -> dict:
    """The LDM UNet's state dict at config/celebhq.yaml's width, random
    weights from SEED (what a reference-format LDM .pth holds); the LDM
    ControlNet's trunks start from it."""
    from controlnet_tpu_torch.models.unet import UNet

    config = celebhq_config()
    torch.manual_seed(SEED)
    return UNet(config["autoencoder_params"]["z_channels"], config["ldm_params"]).state_dict()


def latent_trainer(kind: str, dtype_name: str, device, mesh=None, **train_params):
    """One latent trainer of config/celebhq.yaml at full width, from the
    trainer tools' ``make_trainer`` at ``dtype_name`` compute, with
    ``train_params`` overriding the config's: returns (modules by name,
    train states by name, ``run(batch, step_count, g, **draws) -> loss``).
    The ControlNet's zero convs are made nonzero from SEED, so the control
    branch takes gradient from the first step; its trainer is data-parallel
    over ``mesh`` when given."""
    from controlnet_tpu_torch.tools import train_ldm_controlnet, train_ldm_vae, train_vae

    cfg = celebhq_config()
    cfg["train_params"].update(compute_dtype=dtype_name, **train_params)
    if kind == "vae":
        vae, disc, g_state, d_state, step = train_vae.make_trainer(cfg, device, SEED)
        return ({"vae": vae, "disc": disc}, {"g": g_state, "d": d_state},
                lambda b, i, g, **kw: step(g_state, d_state, b, i, g, **kw)["g_loss"])
    if kind == "ldm":
        unet, state, step = train_ldm_vae.make_trainer(cfg, LATENT_STEPS_PER_EPOCH, device, SEED)
        return {"unet": unet}, {"": state}, lambda b, i, g, **kw: step(state, b, g, **kw)
    cn, state, step = train_ldm_controlnet.make_trainer(cfg, seeded_ldm_state_dict(),
                                                        LATENT_STEPS_PER_EPOCH, device, SEED,
                                                        mesh)
    randomize_zero_convs(cn)
    return {"cn": cn}, {"": state}, lambda b, i, g, **kw: step(state, b[0], b[1], g, **kw)


def latent_batch(kind: str, g: torch.Generator, device):
    """One seeded batch of ``kind``'s trainer: images in [-1, 1] at 128^2
    (VAE); latents drawn from seeded moments mean || logvar as the LDM tools
    draw them (LDM); those latents and binary edge-like hints at 1024^2
    (ControlNet)."""
    from controlnet_tpu_torch.data.datasets import latents_from_batch

    cfg = celebhq_config()
    b = LATENT_BATCH[kind]
    if kind == "vae":
        size = cfg["dataset_params"]["im_size"]
        return torch.rand((b, 3, size, size), generator=g, device=device) * 2 - 1
    ae = cfg["autoencoder_params"]
    z, lsize = ae["z_channels"], cfg["dataset_params"]["im_size"] // 2 ** sum(ae["down_sample"])
    moments = torch.randn((b, 2 * z, lsize, lsize), generator=g, device=device)
    moments[:, z:] = moments[:, z:] * 0.5 - 3.0  # logvar around -3
    latents = latents_from_batch(moments, g)
    if kind == "ldm":
        return latents
    size = cfg["dataset_params"]["canny_im_size"]
    edges = (torch.rand((b, 1, size, size), generator=g, device=device) < 0.15).float()
    return latents, edges.expand(b, 3, size, size).contiguous()


def latent_draws(kind: str, batch, g: torch.Generator, device) -> dict:
    """The step's own draws made beforehand, so two runs inject the same
    ones: the VAE's reparameterisation noise; t and noise (and the
    ControlNet's condition-drop mask)."""
    if kind == "vae":
        ae = celebhq_config()["autoencoder_params"]
        down = 2 ** sum(bool(d) for d in ae["down_sample"])
        b, _, h, w = batch.shape
        return {"noise": torch.randn((b, ae["z_channels"], h // down, w // down), generator=g,
                                     device=device)}
    lat = batch if kind == "ldm" else batch[0]
    draws = {"t": torch.randint(0, 1000, (lat.shape[0],), generator=g, device=device),
             "noise": torch.randn(lat.shape, generator=g, device=device)}
    if kind == "controlnet":
        draws["keep"] = (torch.rand((lat.shape[0],), generator=g, device=device) >= 0.25).float()
    return draws


def launch_counts() -> tuple[int, int, int]:
    from controlnet_tpu_torch.ops import cuda_attention, cuda_conv

    return cuda_attention.launches, cuda_attention.bwd_launches, cuda_conv.launches


def reset_launch_counts() -> None:
    from controlnet_tpu_torch.ops import cuda_attention, cuda_conv

    cuda_attention.launches = cuda_attention.bwd_launches = cuda_conv.launches = 0


def phase_latent_shapes(device) -> list:
    """Phase 21: one full-width step of the LDM trainer and one of the LDM
    ControlNet trainer at batch 16, f32: launches a / b / c (14 / 14 / 0 and
    22 / 14 / 7) and the backward attention shapes, which must be the same
    14 in both (the ControlNet's control copy has the LDM's down and mid
    shapes, its trunk the LDM's up shapes).  Returns those shapes."""
    found = {}
    for kind in ("ldm", "controlnet"):
        _, _, run = latent_trainer(kind, "float32", device)
        g = torch.Generator(device=device).manual_seed(SEED)
        batch = latent_batch(kind, g, device)
        shapes: list = []
        before = launch_counts()
        with record_bwd_shapes(shapes):
            loss = run(batch, 1, g)
        torch.cuda.synchronize()
        got = tuple(n - m for n, m in zip(launch_counts(), before))
        ok = got == LATENT_CALLS[kind] and bool(torch.isfinite(loss))
        found[kind] = shapes
        log(f"latent training step {kind}, batch {LDM_BATCH}: launches a / b / c {got} (expect "
            f"{LATENT_CALLS[kind]}), loss {loss.item():.4f}; backward shapes (Lq, Lk, dh, B*H) "
            f"{sorted(collections.Counter(shapes).items(), reverse=True)} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"full-width latent training step ({kind}) failed")
        del run, batch, loss
        torch.cuda.empty_cache()
    if collections.Counter(found["ldm"]) != collections.Counter(found["controlnet"]):
        raise SystemExit("the LDM and LDM ControlNet steps reach kernel b at different shapes")
    return found["ldm"]


HINT_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}  # of max|grad| per tensor


def phase_conv_autograd(device) -> dict:
    """Phase 23: kernel c under autograd.  One batch-16 hint encode of the
    full-width LDM ControlNet at 1024^2, forward and backward of a seeded
    projection of its features, through kernel c (7 launches) against the
    same encode with the plain conv route, f32 and bf16 hints: the features
    within MODEL_TOL of max|f| and every hint-encoder parameter's gradient
    within HINT_GRAD_TOL of that tensor's max|grad|."""
    from controlnet_tpu_torch.ops import cuda_conv

    modules, _, _ = latent_trainer("controlnet", "float32", device)
    cn = modules["cn"]
    params = dict(cn.hint_block.named_parameters())
    g = torch.Generator(device=device).manual_seed(SEED)
    _, hints = latent_batch("controlnet", g, device)
    out: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for plain in (False, True):
            for p in params.values():
                p.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = cuda_conv.launches
            start = time.perf_counter()
            with plain_conv() if plain else contextlib.nullcontext():
                feats = cn.hint_features(hints.to(dtype))
                w = torch.randn(feats.shape, generator=torch.Generator(device=device)
                                .manual_seed(SEED + 1), device=device)
                (feats.float() * w).sum().backward()
            torch.cuda.synchronize()
            runs.append(dict(feats=feats.detach().float(),
                             grads={k: p.grad.detach().clone() for k, p in params.items()},
                             launches=cuda_conv.launches - before,
                             ms=(time.perf_counter() - start) * 1e3,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            del feats, w
        kern, ref = runs
        scale = ref["feats"].abs().max().item()
        f_err = (kern["feats"] - ref["feats"]).abs().max().item() / max(scale, 1e-30)
        g_err = {k: ((kern["grads"][k] - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                 for k, r in ref["grads"].items()}
        worst = max(g_err, key=g_err.get)
        ok = (kern["launches"] == 7 and ref["launches"] == 0 and f_err <= MODEL_TOL[dtype]
              and max(g_err.values()) <= HINT_GRAD_TOL[dtype]
              and all(bool(torch.isfinite(t).all()) for t in kern["grads"].values()))
        name = str(dtype)[6:]
        out[name] = dict(feat_err=f_err, grad_err=max(g_err.values()), worst=worst,
                         launches=kern["launches"], ms=kern["ms"], plain_ms=ref["ms"],
                         peak_gb=kern["peak_gb"])
        log(f"hint encode under autograd {name}, batch {LDM_BATCH}, hints "
            f"{tuple(hints.shape[2:])}: conv kernel launches {kern['launches']} (expect 7), "
            f"plain route {ref['launches']}; features rel err {f_err:.3g} (tol "
            f"{MODEL_TOL[dtype]:g}), weight gradients rel err {max(g_err.values()):.3g} at "
            f"{worst} (tol {HINT_GRAD_TOL[dtype]:g}, {len(g_err)} tensors); forward + backward "
            f"{kern['ms']:.1f} ms (plain route {ref['ms']:.1f} ms) on the host clock, peak "
            f"memory {kern['peak_gb']:.2f} GB -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"hint encode under autograd ({name}) disagrees with the plain route")
        del runs, kern, ref
    del cn, modules
    torch.cuda.empty_cache()
    return out


# f32 weights after CHECK_STEPS latent steps, kernels vs plain, in lr: phase
# 7's 1e-2 does not hold here.  On an H100 80GB HBM3 at 700 W the routes'
# losses agree to 5 digits and their first-step gradients within ~2e-6 of
# max|grad|, but Adam turns a gradient difference d on a weight with
# gradient g into ~lr * d / |g|, and a GroupNorm scale of the control copy
# (downs.1; its gradient a sum over 16 x 256 pixels) moved 0.0119 lr apart,
# the same in every run.  A wrong gradient moves weights ~lr apart.
LATENT_WEIGHT_TOL = 2e-2


def _latent_check_steps(kind: str, dtype_name: str, device, plain: bool):
    """CHECK_STEPS steps of ``kind`` from one start with injected draws,
    disc_start 1 for the VAE (steps 1, 2, 3 straddle it), condition drop
    0.25 for the ControlNet; returns (losses, first-step grads, params
    before, after, noise-floor mask, launches a / b / c of each step)."""
    _, states, run = latent_trainer(kind, dtype_name, device, disc_start=1, cfg_drop_prob=0.25)
    params = {f"{n}.{k}": p for n, st in states.items() for k, p in st.params.items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, grads, noisy, launches = [], None, {}, []
    # cuDNN's deterministic algorithms in both runs: with its default ones,
    # two runs of the VAE-GAN step, which reaches no kernel, differed by
    # 5.2e-05 of max|grad| (H100 80GB HBM3, 700 W)
    routes = (plain_attention(), plain_conv()) if plain else ()
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                       deterministic=True, allow_tf32=False))
        for ctx in routes:
            stack.enter_context(ctx)
        for i in range(CHECK_STEPS):
            batch = latent_batch(kind, g, device)
            draws = latent_draws(kind, batch, g, device)
            start = launch_counts()
            losses.append(run(batch, i + 1, None, **draws))
            torch.cuda.synchronize()
            launches.append(tuple(n - m for n, m in zip(launch_counts(), start)))
            for k, p in params.items():
                low = p.grad.abs() < NOISE_FLOOR
                noisy[k] = low if k not in noisy else noisy[k] | low
            if grads is None:
                grads = {k: p.grad.detach().clone() for k, p in params.items()}
    after = {k: p.detach().clone() for k, p in params.items()}
    return torch.stack(losses).float().cpu(), grads, before, after, noisy, launches


def phase_latent_parity(device) -> dict:
    """Phase 24: CHECK_STEPS steps of each latent trainer through the
    kernels against the same steps with the plain attention and conv routes,
    with the same injected draws, f32 and bf16.  Launches per step exactly
    LATENT_CALLS (the plain runs launch none).  Tolerances as phase 7's:
    losses and first-step gradients MODEL_TOL (relative); the weights after
    within LATENT_WEIGHT_TOL lr where the gradients stayed above the noise
    floor (f32),
    or a mean |difference| under 0.15 lr and an update cosine over 0.97
    (bf16).  The VAE-GAN step reaches no kernel: its two runs differ only
    where cuDNN or an atomic reduction does (bit-identical or not is
    printed)."""
    lrs = {"vae": "autoencoder_lr", "ldm": "ldm_lr", "controlnet": "controlnet_lr"}
    results: dict = {}
    for kind in LATENT_KINDS:
        lr = celebhq_config()["train_params"][lrs[kind]]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            lk, gk, before, ak, nk, launches = _latent_check_steps(kind, name, device, False)
            lp, gp, _, ap, npl, plain_launches = _latent_check_steps(kind, name, device, True)
            loss_err = ((lk - lp).abs().max() / lp.abs().max().clamp(min=1.0)).item()
            gmax = max(g.abs().max().item() for g in gp.values())
            grad_err = max((gk[k] - gp[k]).abs().max().item() for k in gp) / gmax
            clean, allw, upd_k, upd_p, worst = [], [], [], [], ("", 0.0)
            for k in before:
                d = (ak[k] - ap[k]).abs()
                clean.append(d[~(nk[k] | npl[k])].flatten())
                if clean[-1].numel() and clean[-1].max().item() > worst[1]:
                    worst = (k, clean[-1].max().item())
                allw.append(d.flatten())
                upd_k.append((ak[k] - before[k]).flatten())
                upd_p.append((ap[k] - before[k]).flatten())
            clean, allw, upd_k, upd_p = (torch.cat(x).double() for x in (clean, allw, upd_k, upd_p))
            cos = (upd_k @ upd_p / (upd_k.norm() * upd_p.norm())).item()
            clean_max = clean.max().item() / lr
            mean_diff = allw.mean().item() / lr
            identical = loss_err == 0 and allw.max().item() == 0
            ok = (bool(torch.isfinite(lk).all())
                  and all(n == LATENT_CALLS[kind] for n in launches)
                  and all(n == (0, 0, 0) for n in plain_launches)
                  and loss_err <= MODEL_TOL[dtype] and grad_err <= MODEL_TOL[dtype]
                  and (mean_diff < 0.15 and cos > 0.97 if dtype == torch.bfloat16
                       else clean_max < LATENT_WEIGHT_TOL))
            results[f"{kind}_{name}"] = dict(loss_err=loss_err, grad_err=grad_err,
                                             clean_max_lr=clean_max, mean_diff_lr=mean_diff,
                                             cos=cos, launches_per_step=launches[0],
                                             bit_identical=identical)
            log(f"latent training {kind} {name}, {CHECK_STEPS} steps kernels vs plain routes "
                f"(injected draws{', disc_start 1' if kind == 'vae' else ''}): losses "
                f"{[round(x, 5) for x in lk.tolist()]} vs {[round(x, 5) for x in lp.tolist()]} "
                f"(rel err {loss_err:.3g}), first-step grads rel err {grad_err:.3g} (tol "
                f"{MODEL_TOL[dtype]:g}); weights after: max |diff| {clean_max:.3g} lr (at "
                f"{worst[0]}) over the {clean.numel() / allw.numel():.3f} above the noise floor, "
                f"mean {mean_diff:.3g} lr, update cosine {cos:.6f}, bit-identical {identical}; "
                f"launches a / b / c "
                f"per step {launches} (expect "
                f"{LATENT_CALLS[kind]}), plain runs {plain_launches[0]} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"latent training ({kind}, {name}) through the kernels disagrees "
                                 "with the plain routes")
            torch.cuda.empty_cache()
    return results


def phase_latent_main_path(device) -> dict:
    """Phase 25, in a process of its own: TRAIN_STEPS timed steps of each
    latent trainer at full width (VAE-GAN batch 4 at 128^2; LDM batch 16 on
    32x32x4 latents; LDM ControlNet batch 16 with 1024^2 hints), f32 and
    bf16.  Launch counters set to 0 just before the timed run and read just
    after (exactly LATENT_CALLS a step); ms/step on the host clock, peak
    memory; then a short torch.profiler window for device time, busy share
    and kernels per step.  Every trainable tensor that took gradient moves
    (the VAE's discriminator counts from step 2 on); the ControlNet's frozen
    trunk stays bit-identical."""
    from torch.profiler import ProfilerActivity, profile

    results: dict = {torch.float32: {}, torch.bfloat16: {}}
    for kind in LATENT_KINDS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            # the discriminator counts from step 2 on, so every trainable tensor moves
            t0 = time.perf_counter()
            modules, states, run = latent_trainer(kind, name, device, disc_start=1)
            params = {f"{n}.{k}": p for n, st in states.items() for k, p in st.params.items()}
            t_before = {k: p.detach().clone() for k, p in params.items()}
            frozen = modules["cn"].split_params()[1] if kind == "controlnet" else {}
            f_before = {k: p.detach().clone() for k, p in frozen.items()}
            g = torch.Generator(device=device).manual_seed(SEED)
            pool = [latent_batch(kind, g, device) for _ in range(4)]
            for i in range(TRAIN_WARMUP):
                run(pool[i % len(pool)], i + 1, g)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            start = time.perf_counter()
            losses = [run(pool[i % len(pool)], TRAIN_WARMUP + i + 1, g)
                      for i in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            losses = torch.stack(losses).float()
            t1 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:  # as phase 19's
                for i in range(LATENT_PROFILE_STEPS):
                    run(pool[i % len(pool)], TRAIN_WARMUP + TRAIN_STEPS + i + 1, g)
                torch.cuda.synchronize()
            kernels = device_events(prof)
            t2 = time.perf_counter()
            n_prof = LATENT_PROFILE_STEPS
            dev_ms = device_span_ms(kernels) / n_prof
            a_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name)) / n_prof
            b_ms = sum(_device_ms(e) for e in kernels if "attention_bwd_" in e.name) / n_prof
            c_ms = sum(_device_ms(e) for e in kernels if "conv3x3_tl" in e.name) / n_prof
            trained = [k for k, p in params.items() if p.grad is not None]
            moved = all(not torch.equal(params[k].detach(), t_before[k]) for k in trained)
            still = all(torch.equal(p.detach(), f_before[k]) for k, p in frozen.items())
            ms_step = seconds * 1e3 / TRAIN_STEPS
            want = tuple(n * TRAIN_STEPS for n in LATENT_CALLS[kind])
            ok = (launches == want and bool(torch.isfinite(losses).all()) and moved and still
                  and len(trained) > 0)
            results[dtype][kind] = dict(
                batch=LATENT_BATCH[kind], ms_per_step=ms_step, steps_per_s=TRAIN_STEPS / seconds,
                launches=launches, device_ms_per_step=dev_ms, busy=dev_ms / ms_step,
                kernels_per_step=len(kernels) / n_prof, attn_fwd_device_ms=a_ms,
                attn_bwd_device_ms=b_ms, conv_device_ms=c_ms, peak_gb=peak_gb,
                loss_first=losses[0].item(), loss_last=losses[-1].item())
            log(f"latent training main path {kind} {name}: {TRAIN_STEPS} steps, batch "
                f"{LATENT_BATCH[kind]}: {seconds:.3f} s, {ms_step:.3f} ms/step, "
                f"{TRAIN_STEPS / seconds:.3f} steps/s, launches a / b / c {launches} (expect "
                f"{want}), loss {losses[0].item():.4f} -> {losses[-1].item():.4f}, trainable "
                f"moved {moved} ({len(trained)} tensors), frozen unchanged {still}, peak memory "
                f"{peak_gb:.2f} GB | profile ({n_prof} steps): device {dev_ms:.3f} "
                f"ms/step, busy {dev_ms / ms_step:.3f}, {len(kernels) / n_prof:.1f} "
                f"kernels/step, kernel a {a_ms:.3f}, b {b_ms:.3f}, c {c_ms:.3f} ms/step -> "
                f"{'ok' if ok else 'FAIL'} (set-up and warm-up {start - t0:.1f} s, profile "
                f"window and its events {t2 - t1:.1f} s)")
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + _device_ms(e) / n_prof
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"latent training {kind} {name} top device kernels (ms/step): "
                + "; ".join(f"{k.replace('void ', '')[:56]} {v:.3f}" for k, v in top))
            if not ok:
                raise SystemExit(f"latent training main path ({kind}, {name}) failed")
            del modules, states, run, pool, params, t_before, frozen, f_before
            torch.cuda.empty_cache()
    return results


LATENT_TOOL_IMAGES = 16


def tiny_celeb_config(task: str) -> dict:
    """config/celebhq.yaml's schema at a tiny width for the tool chain:
    16x16 images, 8x8 latents, 32x32 hints (factor 4), 8 timesteps."""
    return {
        "dataset_params": {"name": "celebhq", "im_path": "unused", "im_channels": 3,
                           "im_size": 16, "canny_im_size": 32},
        "diffusion_params": {"num_timesteps": 8, "beta_start": 0.0015, "beta_end": 0.0195},
        "ldm_params": {"hint_channels": 3, "down_channels": [16, 32, 32],
                       "mid_channels": [32, 32], "down_sample": [True, False],
                       "attn_down": [False, True], "time_emb_dim": 16, "norm_channels": 8,
                       "num_heads": 2, "conv_out_channels": 16, "num_down_layers": 1,
                       "num_mid_layers": 1, "num_up_layers": 1},
        "autoencoder_params": {"z_channels": 4, "down_channels": [16, 32], "mid_channels": [32],
                               "down_sample": [True], "attn_down": [False], "norm_channels": 8,
                               "num_heads": 2, "num_down_layers": 1, "num_mid_layers": 1,
                               "num_up_layers": 1},
        "train_params": {"seed": SEED, "task_name": task, "ldm_batch_size": 4,
                         "autoencoder_batch_size": 4, "disc_start": 2, "disc_weight": 0.5,
                         "perceptual_weight": 1, "kl_weight": 0.000005, "ldm_epochs": 1,
                         "autoencoder_epochs": 1, "controlnet_epochs": 1, "num_samples": 4,
                         "num_grid_rows": 2, "ldm_lr": 0.001, "ldm_lr_steps": [1],
                         "autoencoder_lr": 0.001, "controlnet_lr": 0.001,
                         "controlnet_lr_steps": [1], "autoencoder_acc_steps": 2,
                         "autoencoder_img_save_steps": 2, "save_latents": True,
                         "vae_latent_dir_name": "vae_latents", "ldm_ckpt_name": "ddpm_ckpt.pth",
                         "controlnet_ckpt_name": "ddpm_controlnet_ckpt.pth",
                         "vae_autoencoder_ckpt_name": "vae_autoencoder_ckpt.pth",
                         "vae_discriminator_ckpt_name": "vae_discriminator_ckpt.pth"},
    }


def phase_latent_tools(device) -> dict:
    """Phase 26: the latent tool chain on the card, on a tiny celeb config
    with seeded images and hints: train_vae for 1 epoch, then resumed to 2;
    infer_vae (reconstruction grid, latent shards, and a second call that
    leaves the cache as it is); train_ldm_vae; sample_ldm_vae; then
    train_ldm_controlnet, and the existing sample_ldm_controlnet on the
    written ControlNet and VAE .pth files (loaded strictly)."""
    import numpy as np
    import yaml

    from controlnet_tpu_torch.tools import (infer_vae, sample_ldm_controlnet, sample_ldm_vae,
                                            train_ldm_controlnet, train_ldm_vae, train_vae)

    work = os.path.join(REPO, "build", "smoke", "latent_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(SEED)
    images = os.path.join(work, "images.npy")
    hints = os.path.join(work, "hints.npy")
    np.save(images, (rng.random((LATENT_TOOL_IMAGES, 16, 16, 3)) * 255).astype(np.uint8))
    np.save(hints, (rng.random((LATENT_TOOL_IMAGES, 32, 32, 3)) < 0.2).astype(np.float32))
    task = os.path.join(work, "celeb")

    def config_path(**train) -> str:
        cfg = tiny_celeb_config(task)
        cfg["train_params"].update(train)
        path = os.path.join(work, f"celeb_{len(os.listdir(work))}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    start = time.perf_counter()
    vae_runs = [train_vae.train(config_path(autoencoder_epochs=e), images) for e in (1, 2)]
    cfg = config_path()
    infer_vae.infer(cfg, images)
    shards = sorted(os.listdir(os.path.join(task, "vae_latents")))
    infer_vae.infer(cfg, images)  # leaves the cache as it is
    ldm = train_ldm_vae.train(cfg)
    sample_ldm_vae.main(["--config", cfg, "--save_every", "4"])
    cn = train_ldm_controlnet.train(cfg, hints)
    sample_ldm_controlnet.main(["--config", cfg, "--hints", hints, "--sampler", "ddim",
                                "--sampler_steps", "4"])
    seconds = time.perf_counter() - start
    files = ["vae_autoencoder_ckpt.pth", "vae_discriminator_ckpt.pth", "ddpm_ckpt.pth",
             "ddpm_controlnet_ckpt.pth", "vae_infer_samples.png", "samples/final_decoded.png",
             "samples/x0_0.png", "hint_samples/final_decoded.png",
             "vae_autoencoder_ckpt/2.pt", "vae_discriminator_ckpt/2.pt", "ddpm_ckpt/1.pt",
             "ddpm_controlnet_ckpt/1.pt"]
    missing = [f for f in files if not os.path.exists(os.path.join(task, f))]
    finite = all(np.isfinite(list(r["metrics"][0].values())).all() for r in vae_runs)
    finite = finite and all(np.isfinite(h["losses"]).all() for h in (ldm, cn))
    ok = (not missing and finite and shards == ["latents_0.npz"]
          and [r["epochs"] for r in vae_runs] == [[1], [2]]
          and os.path.exists(os.path.join(task, "vae_autoencoder_samples",
                                          "current_autoencoder_sample_1.png")))
    log(f"latent tools on the card: train_vae 1 epoch then resumed to 2, infer_vae ({shards}, "
        f"second call left the cache), train_ldm_vae (loss {ldm['losses'][0]:.4f}), "
        f"sample_ldm_vae, train_ldm_controlnet (loss {cn['losses'][0]:.4f}), "
        f"sample_ldm_controlnet on the written .pth files: {seconds:.1f} s; missing {missing} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("latent tools failed")
    return dict(seconds=seconds)


def latent_train_summary(res: dict) -> dict:
    """The ``{"latent_train": ...}`` line: per-step results of the timed
    runs, the parity and autograd checks, kernel b's per-step device times."""
    bwd = {str(d)[6:]: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "max_rel_err", "sdpa_backends")}
           for d, t in res["bwd"].items()}
    return {"main_path": {f"{kind}_{str(d)[6:]}": r for d, runs in res["main_path"].items()
                          for kind, r in runs.items()},
            "parity": res["parity"], "conv_autograd": res["conv_grad"],
            "kernel_b_per_step": bwd, "tools_s": res["tools"]["seconds"],
            "phases_s": res["seconds"]}


def run_latent_train_phases(device, extra: tuple = ()) -> dict:
    """Phases 21-26 in order; returns their results.  ``extra`` timing
    phases run last in phases 22 and 25's fresh process; their totals come
    back under "extra"."""
    torch.cuda.empty_cache()
    start = time.perf_counter()
    shapes = phase_latent_shapes(device)
    conv_grad = phase_conv_autograd(device)
    parity = phase_latent_parity(device)
    torch.cuda.empty_cache()
    # phases 22 and 25 share one fresh process
    kern_bwd, main_path, *more = in_fresh_processes(
        ("phase_kernels_bwd", (shapes,), dict(batch=LDM_BATCH, cross=(),
                                              per="latent training step")),
        ("phase_latent_main_path", (), {}), *extra)
    tools = phase_latent_tools(device)
    res = dict(bwd=kern_bwd, conv_grad=conv_grad, parity=parity, main_path=main_path,
               tools=tools, extra=more, seconds=time.perf_counter() - start)
    log(f"latent training phases 21-26: {res['seconds']:.1f} s")
    return res


# --- phases 27-31: CIFAR-10 at the full width of config/cifar.yaml -----------------------

CIFAR_TRAIN_IMAGES = 128  # the synthetic train tree: 2 steps an epoch at batch 64
CIFAR_TEST_IMAGES = 32
CIFAR_ANCESTRAL_STEPS = 20  # the ancestral loop's schedule length in phase 30
CIFAR_TOOL_STEPS = 10  # DDIM steps of the sample tools in phase 31
CELEB_TREE_IMAGES = 16


def cifar_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "cifar.yaml"))


def write_cifar_trees(root: str) -> dict:
    """RGB class trees in CIFAR-10's layout (32x32, two classes) written by
    the port's data/synthetic.py: the train and test splits."""
    from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree

    shutil.rmtree(root, ignore_errors=True)
    paths = {}
    for split, n, seed in (("train", CIFAR_TRAIN_IMAGES, SEED), ("test", CIFAR_TEST_IMAGES,
                                                                 SEED + 1)):
        paths[split] = make_synthetic_image_tree(os.path.join(root, split), num_classes=2,
                                                 per_class=n // 2, size=32, channels=3,
                                                 seed=seed)
    return paths


def phase_cifar_sampling(config: dict, ckpt: str, device) -> dict:
    """Phase 30 (second half): the ControlNet sample tool's ``sample`` at
    batch 64 over the ancestral loop cut to a CIFAR_ANCESTRAL_STEPS-step
    schedule, f32 and bf16; counters set to 0 just before and read just
    after each run (26 launches a step)."""
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, _ = tool.load_model(config, ckpt)
    hints = tool.gather_hints(seeded_hints(4 * BATCH, 32), BATCH, seed=SEED)
    dp = config["diffusion_params"]
    sched = make_linear_schedule(CIFAR_ANCESTRAL_STEPS, dp["beta_start"], dp["beta_end"],
                                 device=device)
    T = sched.num_timesteps
    results = {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        start = time.perf_counter()
        x0, traj = tool.sample(cn, sched, hints, seed=SEED, compute_dtype=dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = cuda_attention.launches
        ok = (launches == 26 * T and x0.shape == (BATCH, 3, 32, 32)
              and bool(torch.isfinite(x0).all()) and traj[-1].abs().max().item() <= 1.0)
        results[name] = dict(seconds=seconds, launches=launches,
                             samples_per_s=BATCH / seconds, ms_per_step=seconds * 1e3 / T)
        log(f"CIFAR sampling {name}: {T} ancestral steps, batch {BATCH}: {seconds:.3f} s, "
            f"{BATCH / seconds:.3f} samples/s, {seconds * 1e3 / T:.3f} ms/step, attention "
            f"launches {launches} (expect {26 * T}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"CIFAR sampling ({name}) failed")
    return results


CIFAR_FUSED_STEPS = 10  # the ancestral schedule of the fused-layer sample in phase 30


def phase_cifar_fused_sampling(config: dict, ckpt: str, device) -> dict:
    """Phase 30 (end): the ControlNet sample tool's ``sample`` at batch 64
    over a CIFAR_FUSED_STEPS-step ancestral schedule, f32, with the fused
    layer on (``--attn_fused_proj``: 24 d and 2 a launches a step) against
    the same run with it off (26 a), from one seed; counters set to 0 just
    before and read just after each run."""
    from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, _ = tool.load_model(config, ckpt)
    hints = tool.gather_hints(seeded_hints(4 * BATCH, 32), BATCH, seed=SEED)
    dp = config["diffusion_params"]
    sched = make_linear_schedule(CIFAR_FUSED_STEPS, dp["beta_start"], dp["beta_end"],
                                 device=device)
    runs = {}
    for on in (False, True):
        set_attn_fused_proj(cn, on)
        torch.cuda.synchronize()
        cuda_attention.launches = cuda_attention_proj.launches = 0
        start = time.perf_counter()
        x0, _ = tool.sample(cn, sched, hints, seed=SEED)
        torch.cuda.synchronize()
        runs[on] = dict(x0=x0, seconds=time.perf_counter() - start,
                        launches_a=cuda_attention.launches,
                        launches_d=cuda_attention_proj.launches)
    set_attn_fused_proj(cn, False)
    steps = CIFAR_FUSED_STEPS
    scale = max(runs[False]["x0"].abs().max().item(), 1.0)
    err = (runs[True]["x0"] - runs[False]["x0"]).abs().max().item()
    tol = FUSED_VS_SPLIT_TOL[torch.float32] * scale
    ok = (runs[True]["launches_d"] == 24 * steps and runs[True]["launches_a"] == 2 * steps
          and runs[False]["launches_d"] == 0 and runs[False]["launches_a"] == 26 * steps
          and bool(torch.isfinite(runs[True]["x0"]).all()) and err <= tol)
    log(f"CIFAR sampling with --attn_fused_proj, float32: {steps} ancestral steps, batch "
        f"{BATCH}: kernel d launches {runs[True]['launches_d']} (expect {24 * steps}), kernel a "
        f"{runs[True]['launches_a']} (expect {2 * steps}); off: a {runs[False]['launches_a']} "
        f"(expect {26 * steps}); max abs diff of the samples {err:.3g} (tol "
        f"{FUSED_VS_SPLIT_TOL[torch.float32]:g} x max(1, max|x0|) = {tol:.3g}); "
        f"{runs[True]['seconds']:.3f} s on, {runs[False]['seconds']:.3f} s off -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("CIFAR sampling with the fused layer failed")
    return {("on" if on else "off"): {k: v for k, v in r.items() if k != "x0"}
            for on, r in runs.items()} | {"max_abs_diff": err}


def phase_cifar_tools(config: dict, trees: dict, device) -> dict:
    """Phase 31, first half: the tools at config/cifar.yaml's full width on
    the synthetic CIFAR trees, from ``--config`` alone: train_ddpm (1 epoch,
    2 steps) -> sample_ddpm; train_ddpm_controlnet with --hint_backend tpu
    (and cv2 where cv2 imports) -> sample_ddpm_controlnet with test-split
    hints (the port's canny of the test images, and cv2's where it imports);
    the sample tools on 16 samples, DDIM CIFAR_TOOL_STEPS steps."""
    import importlib.util

    import numpy as np
    import yaml

    from controlnet_tpu_torch.tools import (sample_ddpm, sample_ddpm_controlnet, train_ddpm,
                                            train_ddpm_controlnet)

    work = os.path.join(REPO, "build", "smoke", "cifar_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tp = config["train_params"]
    backends = ["tpu"] + (["cv2"] if importlib.util.find_spec("cv2") is not None else [])

    def config_path(task: str) -> str:
        cfg = copy.deepcopy(config)
        cfg["dataset_params"].update(im_path=trees["train"], im_test_path=trees["test"])
        cfg["train_params"].update(task_name=os.path.join(work, task), num_epochs=1,
                                   controlnet_epochs=1, ckpt_save_every_epochs=1,
                                   num_samples=16)
        path = os.path.join(work, f"{task}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    few = ["--sampler", "ddim", "--sampler_steps", str(CIFAR_TOOL_STEPS)]
    start = time.perf_counter()
    ddpm = train_ddpm.train(config_path("ddpm"))
    sample_ddpm.main(["--config", config_path("ddpm"), *few])
    runs, written = {}, {}
    for backend in backends:
        task = f"cn_{backend}"
        path = config_path(task)
        os.makedirs(os.path.join(work, task))
        shutil.copy(os.path.join(work, "ddpm", tp["ddpm_ckpt_name"]),
                    os.path.join(work, task, tp["ddpm_ckpt_name"]))
        runs[backend] = train_ddpm_controlnet.train(path, hint_backend=backend)
        sample_ddpm_controlnet.main(["--config", path, "--hint_backend", backend, *few])
        written[backend] = sorted(os.listdir(os.path.join(work, task, "hint_samples")))
    seconds = time.perf_counter() - start
    grids = sorted(os.listdir(os.path.join(work, "ddpm", "samples")))
    losses = [ddpm["losses"][0]] + [r["losses"][0] for r in runs.values()]
    ok = (np.isfinite(losses).all() and len(grids) == CIFAR_TOOL_STEPS
          and all(len(w) == CIFAR_TOOL_STEPS + 1 and "hints.png" in w for w in written.values())
          and all(os.path.exists(os.path.join(work, f"cn_{b}", tp["controlnet_ckpt_name"]))
                  for b in backends))
    log(f"CIFAR tools on trees ({CIFAR_TRAIN_IMAGES} train / {CIFAR_TEST_IMAGES} test PNGs, "
        f"full width, batch {BATCH}): train_ddpm (loss {ddpm['losses'][0]:.4f}) -> "
        f"sample_ddpm ({len(grids)} grids); hint backends run: {backends} (cv2 "
        f"{'imports' if 'cv2' in backends else 'does not import: not run'}): "
        f"train_ddpm_controlnet losses {[round(r['losses'][0], 4) for r in runs.values()]} -> "
        f"sample_ddpm_controlnet with test-split hints; {seconds:.1f} s -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("CIFAR tools on trees failed")
    return dict(seconds=seconds, backends=backends)


def phase_celeb_tree_tools(device) -> dict:
    """Phase 31, second half: a CelebA-HQ style flat directory of RGB PNGs
    (the port's synthetic.py), the tiny celeb config reading it from
    ``--config`` alone: train_vae -> infer_vae (shards keyed by the images'
    basenames, as the JAX tool keys them) -> train_ldm_vae in latent mode
    (the reader finds the cache complete)."""
    import numpy as np
    import yaml

    from controlnet_tpu_torch.data.datasets import load_latents
    from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree
    from controlnet_tpu_torch.tools import infer_vae, train_ldm_vae, train_vae

    work = os.path.join(REPO, "build", "smoke", "celeb_tree")
    shutil.rmtree(work, ignore_errors=True)
    images = os.path.join(make_synthetic_image_tree(os.path.join(work, "tree"), num_classes=1,
                                                    per_class=CELEB_TREE_IMAGES, size=24,
                                                    channels=3, seed=SEED), "0")
    cfg = tiny_celeb_config(os.path.join(work, "celeb"))
    cfg["dataset_params"]["im_path"] = images
    path = os.path.join(work, "celeb.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    start = time.perf_counter()
    vae = train_vae.train(path)
    infer_vae.infer(path)
    keys = sorted(load_latents(os.path.join(work, "celeb", "vae_latents")))
    ldm = train_ldm_vae.train(path)
    seconds = time.perf_counter() - start
    names = sorted(f for f in os.listdir(images) if f.endswith(".png"))
    ok = (keys == names and np.isfinite(list(vae["metrics"][0].values())).all()
          and np.isfinite(ldm["losses"]).all())
    log(f"celeb tools on a tree of {len(names)} PNGs: train_vae -> infer_vae (keys "
        f"{keys[:2]}... = the basenames: {keys == names}) -> train_ldm_vae in latent mode "
        f"(loss {ldm['losses'][0]:.4f}); {seconds:.1f} s -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("celeb tools on a tree failed")
    return dict(seconds=seconds)


def run_cifar_phases(device) -> dict:
    """Phases 27-31 in order: the CIFAR-10 ControlNet at config/cifar.yaml's
    full width (batch 64) and the tools on file trees; returns their
    results."""
    import numpy as np

    from controlnet_tpu_torch.data.datasets import CifarDataset
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    torch.cuda.empty_cache()
    start = time.perf_counter()
    config = cifar_config()
    trees = write_cifar_trees(os.path.join(REPO, "build", "smoke", "cifar_trees"))
    ckpt = os.path.join(REPO, "build", "smoke", f"cifar_controlnet_seed{SEED}.pth")
    write_seeded_checkpoint(config, ckpt)
    cn, _ = tool.load_model(config, ckpt)
    shapes = phase_forward(cn, device, channels=3, size=32, what="CIFAR forward")
    fused = phase_pixel_fused_forward(cn, device, 3, 32, CIFAR_PROJ_SHAPES, "CIFAR")
    wide = phase_proj_checks(PROJ_WIDE_SHAPES, SERVE_BATCH, device)
    edges = phase_proj_edges(device)
    del cn
    torch.cuda.empty_cache()
    base = seeded_unet_state_dict(config)
    reader = CifarDataset("train", trees["train"])
    images = torch.from_numpy(np.stack([reader[i] for i in range(len(reader))])).permute(
        0, 3, 1, 2).contiguous().to(device)
    bwd_shapes = phase_train_shapes(config, base, images, device)
    kern, kern_bwd, proj = in_fresh_processes(
        ("phase_kernels", (shapes,), dict(cross=CIFAR_OFF_PATH_SHAPES)),
        ("phase_kernels_bwd", (bwd_shapes,), dict(cross=CIFAR_OFF_PATH_SHAPES,
                                                  per="CIFAR training step")),
        ("phase_proj_kernels", (CIFAR_PROJ_SHAPES, BATCH), dict(what="CIFAR forward")))
    parity = {str(dtype)[6:]: phase_train_parity(config, base, images, device, dtype,
                                                 deterministic=True, what="CIFAR training")
              for dtype in (torch.float32, torch.bfloat16)}
    train = phase_train_main_path(config, base, images, device, what="CIFAR training main path")
    del images
    torch.cuda.empty_cache()
    sampling = phase_cifar_sampling(config, ckpt, device)
    fused_sampling = phase_cifar_fused_sampling(config, ckpt, device)
    tools = phase_cifar_tools(config, trees, device)
    celeb = phase_celeb_tree_tools(device)
    res = dict(fwd=kern, bwd=kern_bwd, proj=proj, fused=fused, wide=wide, edges=edges,
               parity=parity,
               train=train, sampling=sampling, fused_sampling=fused_sampling, tools=tools,
               celeb=celeb, seconds=time.perf_counter() - start)
    log(f"CIFAR phases 27-31: {res['seconds']:.1f} s")
    return res


def cifar_summary(res: dict) -> dict:
    """The ``{"cifar": ...}`` line: the timed training and sampling runs,
    the parity checks, the tool runs' seconds."""
    return {"train": res["train"], "sampling": res["sampling"], "parity": res["parity"],
            "fused_sampling": res["fused_sampling"],
            "tools_s": res["tools"]["seconds"], "hint_backends": res["tools"]["backends"],
            "celeb_tree_tools_s": res["celeb"]["seconds"], "phases_s": res["seconds"]}


# --- phases 32-35: the conditional UNet (class, text and image conditioning) ---------------

# The reference's celebhq_text_image_cond.yaml over config/celebhq.yaml's
# ldm_params: CLIP text embeddings (512 wide, prompts padded to 77 tokens) and
# CelebAMask-HQ's 18 mask classes at 512^2 through a 1x1 conv to 3 channels;
# and its mnist_class_cond.yaml over config/mnist.yaml's model_params.
COND_TEXT_IMAGE = {"condition_types": ["text", "image"],
                   "text_condition_config": {"text_embed_dim": 512},
                   "image_condition_config": {"image_condition_input_channels": 18,
                                              "image_condition_output_channels": 3}}
COND_CLASS = {"condition_types": ["class"], "class_condition_config": {"num_classes": 10}}
COND_TEXT_LEN = 77
COND_MASK_SIZE = 512
COND_CALLS = 28      # kernel a (and b) launches per conditional LDM call: 14 self, 14 cross
CLASS_CALLS = 16     # kernel a launches per class-conditioned MNIST UNet call
COND_CFG_SCALE = 7.5
COND_DPM_STEPS = 10
COND_CHECK_STEPS = 5
CLASS_ANCESTRAL_STEPS = 20
CLASS_CHECK_STEPS = 10
COND_PROFILE_CALLS = 1


def cond_ldm_config() -> dict:
    config = celebhq_config()
    config["ldm_params"]["condition_config"] = copy.deepcopy(COND_TEXT_IMAGE)
    return config


def cond_ldm(device):
    """The conditional LDM UNet at config/celebhq.yaml's full width, random
    weights from SEED, through the LDM tools' loader (no .pth: the seeded
    initialisation), and its config."""
    from controlnet_tpu_torch.tools.sample_ldm_vae import load_ldm

    config = cond_ldm_config()
    torch.manual_seed(SEED)
    return load_ldm(config, None, device), config


def cond_inputs(b: int, g: torch.Generator, device) -> dict:
    """Seeded conditioning of ``b`` samples: unit-normal text embeddings
    (b, 77, 512) and one-hot 18-class masks (b, 18, 512, 512), float32."""
    width = COND_TEXT_IMAGE["text_condition_config"]["text_embed_dim"]
    n_mask = COND_TEXT_IMAGE["image_condition_config"]["image_condition_input_channels"]
    text = torch.randn((b, COND_TEXT_LEN, width), generator=g, device=device)
    labels = torch.randint(0, n_mask, (b, COND_MASK_SIZE, COND_MASK_SIZE), generator=g,
                           device=device)
    mask = torch.nn.functional.one_hot(labels, n_mask).permute(0, 3, 1, 2).float().contiguous()
    return {"text": text, "image": mask}


def cond_null(cond: dict, g: torch.Generator) -> dict:
    """The null condition of guidance: one seeded empty-prompt embedding for
    every sample (the reference's empty-text CLIP embedding is one
    embedding) and the all-zero mask."""
    empty = torch.randn((1, *cond["text"].shape[1:]), generator=g, device=cond["text"].device)
    return {"text": empty.expand_as(cond["text"]).contiguous(),
            "image": torch.zeros_like(cond["image"])}


def cond_latent_shape(config: dict) -> tuple[int, int, int]:
    ae = config["autoencoder_params"]
    size = config["dataset_params"]["im_size"] // 2 ** sum(ae["down_sample"])
    return ae["z_channels"], size, size


def phase_cond_forward(device) -> list:
    """Phase 32: the conditional LDM forward at batch LDM_BATCH through
    kernel a against the plain attention, f32 and bf16 (every conditioning
    leaf cast with x, as the samplers' cast_hint casts it): COND_CALLS
    launches, half of them at the 77-key cross shapes.  Returns the recorded
    shapes."""
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.sample.common import cast_hint

    unet, config = cond_ldm(device)
    n_params = sum(p.numel() for p in unet.parameters())
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((LDM_BATCH, *cond_latent_shape(config)), generator=g, device=device)
    t = torch.randint(0, 1000, (LDM_BATCH,), generator=g, device=device)
    cond = cond_inputs(LDM_BATCH, g, device)
    shapes: list = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin, cin = x.to(dtype), cast_hint(cond, dtype)
            before = cuda_attention.launches
            rec: list = []
            with record_shapes(rec):
                out = unet(xin, t, cin)
            torch.cuda.synchronize()
            launched = cuda_attention.launches - before
            with plain_attention():
                ref = unet(xin, t, cin)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            cross = [s for s in rec if s[1] == COND_TEXT_LEN]
            ok = (launched == COND_CALLS and len(rec) == COND_CALLS
                  and len(cross) == COND_CALLS // 2 and out.shape == x.shape
                  and out.dtype == dtype and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * max(scale, 1.0))
            log(f"conditional LDM forward {str(dtype)[6:]}: {n_params / 1e6:.1f} M parameters, "
                f"batch {LDM_BATCH}, text {tuple(cond['text'].shape)}, masks "
                f"{tuple(cond['image'].shape)}: attention launches {launched} (expect "
                f"{COND_CALLS}: {len(rec) - len(cross)} self, {len(cross)} cross), max|out| "
                f"{scale:.4g}, max abs err vs plain {err:.3g} (tol {MODEL_TOL[dtype]:g} x "
                f"max(1, max|out|)) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("conditional LDM forward failed")
            shapes = shapes or rec
    cross = collections.Counter(s for s in shapes if s[1] == COND_TEXT_LEN)
    log(f"conditional LDM cross-attention shapes (Lq, Lk, dh, B*H): "
        f"{sorted(cross.items(), reverse=True)}")
    return shapes


COND_GRAD_GROUPS = ("context_proj", "cross_attentions", "cond_conv_in")


def _cond_grad(unet, config, dtype, plain: bool, device):
    """One DDPM loss mean((eps(x_t, t, cond) - noise)^2) at batch LDM_BATCH,
    x_t and the conditioning in ``dtype`` (the loss in float32), backward
    through the model under cuDNN's deterministic algorithms.  Returns (loss,
    {name: grad}, launches of a and b)."""
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.sample.common import cast_hint
    from controlnet_tpu_torch.schedules.linear import add_noise, make_linear_schedule

    dp = config["diffusion_params"]
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 ldm_scheduler=True, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    x0 = torch.randn((LDM_BATCH, *cond_latent_shape(config)), generator=g, device=device)
    t = torch.randint(0, dp["num_timesteps"], (LDM_BATCH,), generator=g, device=device)
    noise = torch.randn(x0.shape, generator=g, device=device)
    cond = cast_hint(cond_inputs(LDM_BATCH, g, device), dtype)
    unet.zero_grad(set_to_none=True)
    before = cuda_attention.launches, cuda_attention.bwd_launches
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                       deterministic=True, allow_tf32=False))
        if plain:
            stack.enter_context(plain_attention())
        pred = unet(add_noise(sched, x0, noise, t).to(dtype), t, cond)
        loss = torch.mean((pred.float() - noise) ** 2)
        loss.backward()
    torch.cuda.synchronize()
    launches = (cuda_attention.launches - before[0], cuda_attention.bwd_launches - before[1])
    grads = {k: p.grad.detach().clone() for k, p in unet.named_parameters()}
    unet.zero_grad(set_to_none=True)
    return loss.detach(), grads, launches


def phase_cond_grad(device) -> tuple[dict, list]:
    """Phase 33: one DDPM-loss gradient through the conditional LDM, kernels
    a and b against the plain attention, f32 and bf16, under cuDNN's
    deterministic algorithms, at phase 24's limits: the loss within
    MODEL_TOL, and each group of COND_GRAD_GROUPS within MODEL_TOL of the
    group's max|grad|; COND_CALLS launches each of a and b.  Returns the
    results and the recorded backward shapes."""
    unet, config = cond_ldm(device)
    results, shapes = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        rec: list = []
        with record_bwd_shapes(rec):
            lk, gk, launches = _cond_grad(unet, config, dtype, False, device)
        lp, gp, plain_launches = _cond_grad(unet, config, dtype, True, device)
        loss_err = (lk - lp).abs().item() / max(lp.abs().item(), 1.0)
        errs = {}
        for group in COND_GRAD_GROUPS:
            keys = [k for k in gp if group in k]
            gmax = max(gp[k].abs().max().item() for k in keys)
            errs[group] = max((gk[k] - gp[k]).abs().max().item() for k in keys) / gmax
        gmax_all = max(v.abs().max().item() for v in gp.values())
        err_all = max((gk[k] - gp[k]).abs().max().item() for k in gp) / gmax_all
        ok = (launches == (COND_CALLS, COND_CALLS) and plain_launches == (0, 0)
              and len(rec) == COND_CALLS and bool(torch.isfinite(lk))
              and loss_err <= MODEL_TOL[dtype]
              and all(e <= MODEL_TOL[dtype] for e in errs.values()))
        results[name] = dict(loss=lk.item(), loss_err=loss_err, grad_errs=errs,
                             grad_err_all=err_all, launches=launches)
        log(f"conditional LDM gradient {name}, batch {LDM_BATCH}, deterministic cuDNN: loss "
            f"{lk.item():.6f} vs plain {lp.item():.6f} (rel err {loss_err:.3g}); grad rel err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {MODEL_TOL[dtype]:g} of each group's max|grad|), every weight "
            f"{err_all:.3g}; launches a / b {launches} (expect ({COND_CALLS}, {COND_CALLS})), "
            f"plain runs {plain_launches} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"conditional LDM gradient ({name}) through the kernels disagrees "
                             "with the plain attention")
        shapes = shapes or rec
        del gk, gp
        torch.cuda.empty_cache()
    return results, shapes


def _cond_sampler(config, steps: int, dtype, device):
    """DPM-Solver++ over ``steps`` steps with guidance over the conditional
    LDM's ``cond_input`` and the VAE decode; and the guided eps function."""
    from controlnet_tpu_torch.sample.cfg import make_cfg_eps_fn
    from controlnet_tpu_torch.sample.ddpm import make_ldm_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    dp = config["diffusion_params"]
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 ldm_scheduler=True, device=device)
    eps = make_cfg_eps_fn(lambda m, x, t, c: m(x, t, c), COND_CFG_SCALE)
    loop = make_ldm_sampler(eps, lambda vae, z: vae.decode(z), sched,
                            (LDM_BATCH, *cond_latent_shape(config)), ddim_steps=steps,
                            solver="dpm", compute_dtype=dtype, device=device)
    return loop, eps


def phase_cond_sampling(device) -> dict:
    """Phase 34, in a process of its own: DPM-Solver++ with guidance over the
    conditional LDM and the VAE decode, batch LDM_BATCH (both branches in one
    2 x LDM_BATCH model call).  A COND_CHECK_STEPS-step sample through the
    kernels against the plain attention from one x_T; then COND_DPM_STEPS
    steps f32 and bf16 (after a warm-up run), counters set to 0 just before
    and read just after (COND_CALLS launches of a a step): samples/s,
    ms/step, peak memory; then a profiler window over COND_PROFILE_CALLS
    guided model calls at the first step's inputs (device ms a call; busy
    share = that over ms/step).  Returns results by dtype."""
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.sample.common import cast_hint
    from controlnet_tpu_torch.tools.sample_ldm_vae import load_vae

    unet, config = cond_ldm(device)
    torch.manual_seed(SEED + 1)
    vae = load_vae(config, None, device)
    g = torch.Generator(device=device).manual_seed(SEED)
    cond = cond_inputs(LDM_BATCH, g, device)
    pair = (cond, cond_null(cond, g))
    x_start = torch.randn((LDM_BATCH, *cond_latent_shape(config)), generator=g, device=device)
    im_size = config["dataset_params"]["im_size"]

    loop, _ = _cond_sampler(config, COND_CHECK_STEPS, None, device)
    img_k, _ = loop(unet, vae, None, pair, x_start=x_start)
    with plain_attention():
        img_p, _ = loop(unet, vae, None, pair, x_start=x_start)
    err = (img_k - img_p).abs().max().item()
    scale = img_p.abs().max().item()
    ok = bool(torch.isfinite(img_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"conditional LDM {COND_CHECK_STEPS}-step DPM sample with guidance {COND_CFG_SCALE} + "
        f"decode, batch {LDM_BATCH}, one x_T: max abs err kernels vs plain {err:.3g} "
        f"(max|image| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("conditional LDM sample disagrees with the plain attention")
    del img_k, img_p

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        loop, eps = _cond_sampler(config, COND_DPM_STEPS, dtype, device)
        loop(unet, vae, None, pair, x_start=x_start)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_attention.launches = 0
        start = time.perf_counter()
        images, traj = loop(unet, vae, None, pair, x_start=x_start)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = cuda_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms_step = seconds * 1e3 / COND_DPM_STEPS
        x_in = x_start.to(dtype)
        t_in = torch.full((LDM_BATCH,), loop.timesteps[0], dtype=torch.int32, device=device)
        pair_in = cast_hint(pair, dtype)
        with torch.inference_mode():
            eps(unet, x_in, t_in, pair_in)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:  # as phase 19's
                for _ in range(COND_PROFILE_CALLS):
                    eps(unet, x_in, t_in, pair_in)
                torch.cuda.synchronize()
        kernels = device_events(prof)
        call_ms = device_span_ms(kernels) / COND_PROFILE_CALLS
        a_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name)) / COND_PROFILE_CALLS
        ok = (launches == COND_CALLS * COND_DPM_STEPS
              and images.shape == (LDM_BATCH, 3, im_size, im_size)
              and traj.shape[0] == COND_DPM_STEPS and bool(torch.isfinite(images).all()))
        results[dtype] = dict(seconds=seconds, steps=COND_DPM_STEPS, ms_per_step=ms_step,
                              samples_per_s=LDM_BATCH / seconds, launches=launches,
                              peak_gb=peak_gb, device_ms_per_call=call_ms,
                              busy=call_ms / ms_step, attn_fwd_device_ms_per_call=a_ms,
                              kernels_per_call=len(kernels) / COND_PROFILE_CALLS,
                              check_err=err)
        log(f"conditional LDM sampling {name}: DPM-Solver++ {COND_DPM_STEPS} steps, guidance "
            f"{COND_CFG_SCALE} ({2 * LDM_BATCH} rows a model call), batch {LDM_BATCH}, VAE "
            f"decode: {seconds:.3f} s, {LDM_BATCH / seconds:.3f} samples/s, {ms_step:.3f} "
            f"ms/step, attention launches {launches} (expect {COND_CALLS * COND_DPM_STEPS}), "
            f"images {tuple(images.shape)} in [{images.min().item():.3g}, "
            f"{images.max().item():.3g}], peak memory {peak_gb:.2f} GB | profile "
            f"({COND_PROFILE_CALLS} model calls): device {call_ms:.3f} ms a call, busy "
            f"{call_ms / ms_step:.3f}, {len(kernels) / COND_PROFILE_CALLS:.1f} kernels a call, "
            f"kernel a {a_ms:.3f} ms a call -> {'ok' if ok else 'FAIL'}")
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + _device_ms(e) / COND_PROFILE_CALLS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"conditional LDM sampling {name} top device kernels (ms a call): "
            + "; ".join(f"{k.replace('void ', '')[:56]} {v:.3f}" for k, v in top))
        if not ok:
            raise SystemExit(f"conditional LDM sampling ({name}) failed")
        del images, traj
        torch.cuda.empty_cache()
    return results


def phase_class_mnist(device) -> dict:
    """Phase 35: the class-conditioned MNIST UNet at config/mnist.yaml's
    width, batch BATCH: the ancestral loop on a CLASS_ANCESTRAL_STEPS-step
    schedule with guidance (the zero one-hot is the null; one 2 x BATCH model
    call a step, CLASS_CALLS kernel-a launches).  A CLASS_CHECK_STEPS-step run
    through the kernels against the plain attention on pinned x_T and noise,
    then the full schedule f32 and bf16, counters set to 0 just before and
    read just after: samples/s."""
    from controlnet_tpu_torch.models.unet import UNet
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.sample.cfg import make_cfg_eps_fn
    from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    config = mnist_config()
    mp = dict(config["model_params"], condition_config=copy.deepcopy(COND_CLASS))
    torch.manual_seed(SEED)
    unet = UNet(mp["im_channels"], mp).to(device).eval()
    n_classes = COND_CLASS["class_condition_config"]["num_classes"]
    g = torch.Generator(device=device).manual_seed(SEED)
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, n_classes, (BATCH,), generator=g, device=device), n_classes).float()
    pair = ({"class": onehot}, {"class": torch.zeros_like(onehot)})
    eps = make_cfg_eps_fn(lambda m, x, t, c: m(x, t, c), COND_CFG_SCALE)
    dp = config["diffusion_params"]
    shape = (BATCH, mp["im_channels"], mp["im_size"], mp["im_size"])

    short = make_linear_schedule(CLASS_CHECK_STEPS, dp["beta_start"], dp["beta_end"],
                                 device=device)
    noise = dict(x_start=torch.randn(shape, generator=g, device=device),
                 step_noise=torch.randn((CLASS_CHECK_STEPS, *shape), generator=g, device=device))
    sampler = make_ddpm_sampler(eps, short, shape, device=device)
    x_k, _ = sampler(unet, None, pair, **noise)
    with plain_attention():
        x_p, _ = sampler(unet, None, pair, **noise)
    err = (x_k - x_p).abs().max().item()
    scale = x_p.abs().max().item()
    ok = bool(torch.isfinite(x_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"class-conditioned MNIST {CLASS_CHECK_STEPS}-step ancestral sample with guidance "
        f"{COND_CFG_SCALE}, batch {BATCH}, pinned noise: max abs err kernels vs plain "
        f"{err:.3g} (max|x0| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("class-conditioned MNIST sample disagrees with the plain attention")

    sched = make_linear_schedule(CLASS_ANCESTRAL_STEPS, dp["beta_start"], dp["beta_end"],
                                 device=device)
    T = sched.num_timesteps
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        sampler = make_ddpm_sampler(eps, sched, shape, record_every=T, compute_dtype=dtype,
                                    device=device)
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        start = time.perf_counter()
        x0, traj = sampler(unet, torch.Generator(device=device).manual_seed(SEED), pair)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = cuda_attention.launches
        ok = (launches == CLASS_CALLS * T and x0.shape == shape
              and bool(torch.isfinite(x0).all()) and traj.shape == (1, *shape))
        results[name] = dict(seconds=seconds, launches=launches, samples_per_s=BATCH / seconds,
                             ms_per_step=seconds * 1e3 / T)
        log(f"class-conditioned MNIST sampling {name}: {T} ancestral steps, guidance "
            f"{COND_CFG_SCALE} ({2 * BATCH} rows a model call), batch {BATCH}: {seconds:.3f} s, "
            f"{BATCH / seconds:.3f} samples/s, {seconds * 1e3 / T:.3f} ms/step, attention "
            f"launches {launches} (expect {CLASS_CALLS * T}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"class-conditioned MNIST sampling ({name}) failed")
    return dict(check_err=err, runs=results)


def run_cond_phases(device) -> dict:
    """Phases 32-35 in order: the conditional LDM at config/celebhq.yaml's
    full width (forward, gradient, guided sampling) and the class-conditioned
    MNIST UNet; returns their results."""
    torch.cuda.empty_cache()
    start = time.perf_counter()
    shapes = phase_cond_forward(device)
    torch.cuda.empty_cache()
    cross = [s for s in shapes if s[1] == COND_TEXT_LEN]
    grad, bwd_shapes = phase_cond_grad(device)
    torch.cuda.empty_cache()
    bwd_cross = [s for s in bwd_shapes if s[1] == COND_TEXT_LEN]
    if collections.Counter(bwd_cross) != collections.Counter(cross):
        raise SystemExit(f"the gradient reaches kernel b at other cross shapes: {bwd_cross}")
    fwd, bwd, sampling = in_fresh_processes(
        ("phase_kernels", (cross,), dict(batch=LDM_BATCH, cross=())),
        ("phase_kernels_bwd", (bwd_cross,), dict(batch=LDM_BATCH, cross=(),
                                                 per="conditional LDM gradient")),
        ("phase_cond_sampling", (), {}))
    mnist = phase_class_mnist(device)
    res = dict(cross_shapes=sorted(collections.Counter(cross).items(), reverse=True), fwd=fwd,
               bwd=bwd, grad=grad, sampling=sampling, mnist=mnist,
               seconds=time.perf_counter() - start)
    log(f"conditional phases 32-35: {res['seconds']:.1f} s")
    return res


def cond_summary(res: dict) -> dict:
    """The ``{"cond": ...}`` line: the cross shapes, the gradient checks and
    the timed sampling runs of both conditional models."""
    return {"cross_shapes": [[list(s), n] for s, n in res["cross_shapes"]],
            "grad": res["grad"],
            "ldm_sampling": {str(d)[6:]: r for d, r in res["sampling"].items()},
            "mnist_class_sampling": res["mnist"]["runs"],
            "mnist_class_check_err": res["mnist"]["check_err"], "phases_s": res["seconds"]}


# The comparison, evaluation and conversion tools (phases 36-37) at
# config/mnist.yaml's full width.  The JAX tools default to 1000 DDPM steps;
# 50 keep the phase short, as phases 4 and 30 are cut.
COMPARE_SAMPLES = 5
COMPARE_STEPS = 20
COMPARE_CHECK_STEPS = 10
COMPARE_TREE_IMAGES = 16   # the test split the tools draw their batch from
EVAL_IMAGES = 512          # per tree: more than the 256 features, full-rank covariances
EVAL_FFD_RTOL = 1e-3       # FFD on the card against the CPU, of FFD
EVAL_LPIPS_TOL = 1e-4      # LPIPS on the card against the CPU, absolute
EVAL_SELF_RTOL = 1e-3      # FFD(a, a) against FFD(a, b)


def write_seeded_students(config: dict, task: str) -> None:
    """Reference-format .pth files of both students, random weights from
    SEED, at the names the port's trainers write (the consistency student
    with its EMA, a copy; the DMD student's zero-initialised last hint conv
    made nonzero so its hint path contributes)."""
    from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
    from controlnet_tpu_torch.models.dmd import DistributionMatchingControlNet
    from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train
    from controlnet_tpu_torch.tools import (
        train_distribution_matching_controlnet_distilled as dmd_train)

    mp = config["model_params"]
    torch.manual_seed(SEED)
    cd = ConsistencyDistilled(mp["im_channels"], mp, use_ddpm_teacher=False, device="cpu")
    torch.save(cd_train.reference_checkpoint(cd, 0, mp), os.path.join(task, cd_train.CKPT_NAME))
    torch.manual_seed(SEED + 1)
    dmd = DistributionMatchingControlNet(mp["im_channels"], mp)
    with torch.no_grad():
        dmd.hint_block[-1].weight.normal_(0.0, 0.05)
    torch.save(dmd_train.reference_checkpoint(dmd.state_dict(), 0, config),
               os.path.join(task, dmd_train.REF_CKPT))


def phase_compare_tools(config: dict, ckpt: str, device) -> dict:
    """Phase 36: both compare tools through their ``main`` at the full MNIST
    width on a digit tree written by the port's data/synthetic.py, with
    seeded .pth files of the ControlNet and both students; ``--num_samples
    5 --ddpm_steps 50``, hints from the port's canny on the card (and cv2's
    where it imports).  Counters set to 0 just before and read just after
    each tool: kernel a 26 x 50 x 2 per DDPM run (warm-up and timed) and 16
    x 2 per student.  The artifacts; then on the tools' path, a 10-step
    DDPM sample from pinned x_T and step noise and each student's 1 step
    from a pinned x_T, through the kernel against the plain attention."""
    import importlib.util

    import numpy as np
    import yaml

    from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.tools import compare_all_controlnet_models as compare_all
    from controlnet_tpu_torch.tools import compare_controlnet_models as compare

    work = os.path.join(REPO, "build", "smoke", "compare")
    shutil.rmtree(work, ignore_errors=True)
    task = os.path.join(work, "mnist")
    os.makedirs(task)
    shutil.copy(ckpt, os.path.join(task, config["train_params"]["controlnet_ckpt_name"]))
    write_seeded_students(config, task)
    tree = make_synthetic_image_tree(os.path.join(work, "test"), num_classes=2,
                                     per_class=COMPARE_TREE_IMAGES // 2, size=28, seed=SEED)
    cfg = copy.deepcopy(config)
    cfg["dataset_params"]["im_test_path"] = tree
    cfg["train_params"]["task_name"] = task
    cfg_path = os.path.join(work, "mnist.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    n, T = COMPARE_SAMPLES, COMPARE_STEPS
    want = {"compare": 26 * T * 2 + STUDENT_CALLS * 2,
            "compare_all": 26 * T * 2 + STUDENT_CALLS * 2 * 2}
    dirs = {"compare": "model_comparison", "compare_all": "all_model_comparison"}
    backends = ["tpu"] + (["cv2"] if importlib.util.find_spec("cv2") is not None else [])
    runs: dict = {}
    start = time.perf_counter()
    for backend in backends:
        for name, tool in (("compare", compare), ("compare_all", compare_all)):
            out_dir = os.path.join(task, dirs[name])
            shutil.rmtree(out_dir, ignore_errors=True)
            torch.cuda.synchronize()
            cuda_attention.launches = 0
            res = tool.main(["--config", cfg_path, "--num_samples", str(n), "--ddpm_steps",
                             str(T), "--hint_backend", backend])
            torch.cuda.synchronize()
            launches = cuda_attention.launches
            timings = res["timings"]
            if name == "compare":
                per = {"ddpm": timings["ddpm_total"] / n,
                       "consistency": timings["consistency_total"] / n}
            else:
                per = {m: s / n for m, s in timings.items()}
            files = sorted(os.listdir(out_dir))
            saved = np.load(os.path.join(out_dir, "timing_data.npy"), allow_pickle=True).item()
            ok = (launches == want[name]
                  and files == [f"comparison_{i:03d}.png" for i in range(n)] + [
                      "performance_metrics.txt", "timing_data.npy"]
                  and saved.keys() == timings.keys()
                  and all(x.shape == (n, 28, 28, 1) and np.isfinite(x).all()
                          for x in res["samples"].values())
                  and len(res["samples"]) == (2 if name == "compare" else 3))
            speedup = {m: per["ddpm"] / s for m, s in per.items() if m != "ddpm"}
            runs[f"{name}_{backend}"] = dict(launches=launches, s_per_sample=per,
                                             speedup=speedup)
            log(f"{name} tool, --hint_backend {backend}: {n} samples, DDPM {T} steps: "
                f"s/sample {', '.join(f'{m} {s:.4f}' for m, s in per.items())}; speed-up "
                f"{', '.join(f'{m} {v:.1f}x' for m, v in speedup.items())}; kernel a launches "
                f"{launches} (expect {want[name]}); {len(files)} artifacts -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the {name} tool failed (--hint_backend {backend})")
    tools_s = time.perf_counter() - start

    # the tools' path, kernel vs plain: pinned x_T (and step noise)
    _, hints = compare.draw_test_batch(cfg, n, SEED, "tpu", device)
    g = torch.Generator(device=device).manual_seed(SEED)
    x_start = torch.randn((n, 1, 28, 28), generator=g, device=device)
    step_noise = torch.randn((COMPARE_CHECK_STEPS, n, 1, 28, 28), generator=g, device=device)
    checks = {"ddpm": (compare.make_generator("ddpm", cfg, hints, COMPARE_CHECK_STEPS, device),
                       dict(x_start=x_start, step_noise=step_noise))}
    for m in ("consistency", "dmd"):
        checks[m] = (compare.make_generator(m, cfg, hints, T, device), dict(x_start=x_start))
    errs = {}
    for m, (generate, noise) in checks.items():
        out = generate(SEED, **noise)
        with plain_attention():
            ref = generate(SEED, **noise)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
        errs[m] = err
        steps = f"{COMPARE_CHECK_STEPS} steps" if m == "ddpm" else "1 step"
        log(f"compare path {m}, {steps}, x_T pinned, batch {n}: max abs err kernel vs plain "
            f"{err:.3g} (max|x0| {scale:.4g}, tol {MODEL_TOL[torch.float32]:g} x max(1, "
            f"max|x0|)) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the compare path's {m} disagrees with the plain attention")
    return dict(runs=runs, check_err=errs, tools_s=tools_s, backends=backends, task=task,
                config_path=cfg_path)


def write_png_tree(path: str, images) -> str:
    """uint8 (N, H, W) images as <path>/<i>.png."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    for i, im in enumerate(images):
        Image.fromarray(im).save(os.path.join(path, f"{i:04d}.png"))
    return path


def phase_eval_and_tf32(config: dict, compared: dict, device) -> dict:
    """Phase 37: ``eval_metrics`` through its ``main`` on the card between two
    seeded 28x28 grayscale PNG trees of EVAL_IMAGES images (full-rank
    covariances), held against the same function on the CPU, and a tree
    against itself; then both TF32 switches set on, a sample tool's ``main``
    and ``serve.make_server`` on the card, and both switches read off after
    each."""
    import types

    import numpy as np

    from controlnet_tpu_torch.tools import eval_metrics, sample_ddpm_controlnet, serve

    work = os.path.join(REPO, "build", "smoke", "eval")
    shutil.rmtree(work, ignore_errors=True)
    digits = seeded_digits(2 * EVAL_IMAGES)
    dirs = [write_png_tree(os.path.join(work, name), digits[i * EVAL_IMAGES:(i + 1) * EVAL_IMAGES])
            for i, name in enumerate(("a", "b"))]
    start = time.perf_counter()
    on_card = eval_metrics.main(["--dir_a", dirs[0], "--dir_b", dirs[1]])
    card_s = time.perf_counter() - start
    self_ffd = eval_metrics.main(["--dir_a", dirs[0], "--dir_b", dirs[0]])
    ims = [eval_metrics.load_images(d, 1) for d in dirs]
    on_cpu = eval_metrics.evaluate(*ims, 1, device="cpu")
    ffd_err = abs(on_card["ffd"] - on_cpu["ffd"])
    lpips_err = abs(on_card["lpips_mean"] - on_cpu["lpips_mean"])
    ok = (ffd_err <= EVAL_FFD_RTOL * abs(on_cpu["ffd"]) and lpips_err <= EVAL_LPIPS_TOL
          and on_card["n_a"] == on_card["n_b"] == EVAL_IMAGES
          and abs(self_ffd["ffd"]) <= EVAL_SELF_RTOL * on_card["ffd"]
          and self_ffd["lpips_mean"] == 0.0)
    log(f"eval_metrics, {EVAL_IMAGES} vs {EVAL_IMAGES} 28x28 PNGs on the card ({card_s:.2f} s): "
        f"FFD {on_card['ffd']:.6g} (CPU {on_cpu['ffd']:.6g}, diff {ffd_err:.3g}, tol "
        f"{EVAL_FFD_RTOL:g} x FFD), LPIPS {on_card['lpips_mean']:.6g} (CPU "
        f"{on_cpu['lpips_mean']:.6g}, diff {lpips_err:.3g}, tol {EVAL_LPIPS_TOL:g}); a tree "
        f"against itself: FFD {self_ffd['ffd']:.3g}, LPIPS {self_ffd['lpips_mean']:.3g} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("eval_metrics on the card disagrees with the CPU")

    def tf32() -> tuple:
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    def tf32_on() -> None:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    hints = os.path.join(work, "hints.npy")
    np.save(hints, seeded_hints(4, 28))
    tf32_on()
    sample_ddpm_controlnet.main(["--config", compared["config_path"], "--hints", hints,
                                 "--num_samples", "4", "--sampler", "ddim", "--sampler_steps",
                                 "2"])
    after_tool = tf32()
    tf32_on()
    args = types.SimpleNamespace(model="consistency", host="127.0.0.1", port=0, seed=SEED,
                                 max_batch=1, max_steps=1, dynamic_batching=True,
                                 batch_window_ms=2.0, device=None,
                                 ckpt=os.path.join(compared["task"],
                                                   "consistency_controlnet_distilled.pth"))
    server = serve.make_server(args, config)
    server.server_close()
    after_server = tf32()
    ok = after_tool == after_server == (False, False)
    log(f"TF32 switches (cudnn, cuda.matmul) set on, then read after sample_ddpm_controlnet "
        f"main: {after_tool}, after serve.make_server: {after_server} (expect (False, False)) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("an entry point left TF32 on")
    return dict(card=on_card, cpu=on_cpu, self=self_ffd, card_s=card_s,
                tf32_after={"sample_tool": after_tool, "make_server": after_server})


def run_compare_phases(config: dict, ckpt: str, device) -> dict:
    """Phases 36-37 in order; returns their results."""
    torch.cuda.empty_cache()
    start = time.perf_counter()
    compared = phase_compare_tools(config, ckpt, device)
    evaluated = phase_eval_and_tf32(config, compared, device)
    res = dict(compare=compared, eval=evaluated, seconds=time.perf_counter() - start)
    log(f"compare phases 36-37: {res['seconds']:.1f} s")
    return res


def compare_summary(res: dict) -> dict:
    """The ``{"compare": ...}`` line: each tool run's s/sample, speed-ups and
    launches, the kernel-vs-plain checks, eval_metrics on the card and the
    CPU, and the TF32 switches after the entry points."""
    ev = res["eval"]
    return {"tools": res["compare"]["runs"], "check_err": res["compare"]["check_err"],
            "samples": COMPARE_SAMPLES, "ddpm_steps": COMPARE_STEPS,
            "hint_backends": res["compare"]["backends"],
            "eval": {"card": ev["card"], "cpu": ev["cpu"], "self": ev["self"],
                     "card_s": ev["card_s"]},
            "tf32_after": ev["tf32_after"], "phases_s": res["seconds"]}


# ---------------------------------------------------------------------------
# phase 38: data parallelism
# ---------------------------------------------------------------------------
#
# NCCL refuses two ranks on one device ("Duplicate GPU detected"), so on a
# one-card machine the data-parallel semantics are held with two ranks on
# cuda:0 over gloo (which reduces CUDA tensors through the host), and the
# NCCL path, the tools' default on the card, at world size 1.  Each rank is a
# process of its own (``--parallel-rank``); the one-process references run in
# this process.

DP_WORLD = 2
DP_STEPS = 3          # ControlNet train steps of check 2, per compute type
DP_LDM_STEPS = 2      # LDM ControlNet steps of check 5 (global batch LDM_BATCH)
DP_TOOL_IMAGES = 128  # the trainer tool's seeded set: 2 steps of 64 an epoch
DP_SAMPLES = 5        # not divisible by 2: the sample tool's padding path
DP_SAMPLE_STEPS = 10
DP_SCALING_NOTE = ("two ranks time-sliced on one card, gloo through the host: not a "
                   "scaling figure")


# phase 38's one-process references and its NCCL child's model-axis-1 run,
# which phase 41 takes instead of computing them again
REFS: dict = {}


def dp_work() -> str:
    return os.path.join(REPO, "build", "smoke", "parallel")


def dp_images(device) -> torch.Tensor:
    """The seeded digit set of checks 2 and 4, NCHW in [-1, 1] on the card."""
    from controlnet_tpu_torch.data.datasets import to_unit

    return torch.from_numpy(to_unit(seeded_digits(2 * BATCH)))[:, None].to(device)


def dp_cn_steps(config: dict, base: dict, images, device, dtype_name: str, mesh=None,
                tp: bool = False) -> dict:
    """DP_STEPS ControlNet trainer steps on the global batches of
    ``train_batches`` (this rank's rows of each under ``mesh``), one seeded
    generator, cuDNN's deterministic algorithms: losses, the first step's
    (averaged) gradients, the weights before and after, the noise-floor
    mask, the launches of kernels a and b, and the wall ms of the steps after
    the first.  ``tp``: the parameters sharded over ``mesh``'s model axis
    first (``parallel/tp.py``); the tensors returned are joined whole."""
    from controlnet_tpu_torch import cli
    from controlnet_tpu_torch.parallel import tp as tp_mod
    from controlnet_tpu_torch.parallel.tp import tp_full_state_dict, tp_shard_params

    cn, state, step = train_setup(config, base, device, dtype_name, mesh)
    if tp:
        tp_shard_params(cn, mesh)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, grads, noisy, times = [], None, {}, []
    reset_launch_counts()
    tp_mod.moved_bytes = 0
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for batch, hints in train_batches(images, DP_STEPS):
            batch, hints = cli.put_batch((batch, hints), mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(state, batch, hints, g))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, p in state.params.items():
                low = p.grad.abs() < NOISE_FLOOR
                noisy[k] = low if k not in noisy else noisy[k] | low
            if grads is None:
                grads = {k: p.grad.detach().clone() for k, p in state.params.items()}
    a, b, _ = launch_counts()
    model_group_bytes = tp_mod.moved_bytes / DP_STEPS  # a step, before the joins below
    after = {k: p.detach() for k, p in state.params.items()}
    if tp:  # the shards joined whole (the mask as 0 / 1)
        grads, before, after = (tp_full_state_dict(cn, mesh, d) for d in (grads, before, after))
        noisy = {k: v > 0 for k, v in tp_full_state_dict(
            cn, mesh, {k: m.float() for k, m in noisy.items()}).items()}
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return dict(losses=torch.stack(losses).float().cpu(), grads=cpu(grads), before=cpu(before),
                after=cpu(after), noisy=cpu(noisy),
                launches=(a, b), ms=1e3 * sum(times[1:]) / max(1, len(times) - 1),
                model_group_bytes=model_group_bytes,
                allreduce_bytes=4 * (sum(p.numel() for p in state.params.values()) + 1))


def dp_distill_steps(config: dict, teacher_sd: dict, images, device, mesh=None) -> dict:
    """One ddpm_distillation and one DMD step (float32) on the first global
    batch (this rank's rows under ``mesh``): the loss terms, the (averaged)
    gradients, the weights before and after, and, for DMD, the feature
    extractor's outputs on the global batch (gathered from the ranks: its
    BatchNorm takes the global batch's statistics)."""
    from controlnet_tpu_torch import cli
    from controlnet_tpu_torch.parallel.mesh import gather_rows
    from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints

    x0 = images[:BATCH]
    x0_l, hint_l = cli.put_batch((x0, device_hints(x0)), mesh)
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for kind in ("ddpm_distillation", "dmd"):
            model, state, step = distill_setup(config, teacher_sd, device, kind, "float32", mesh)
            before = {k: p.detach().clone().cpu() for k, p in state.params.items()}
            g = torch.Generator(device=device).manual_seed(SEED)
            metrics = step(x0_l, hint_l, g)
            res = dict(metrics={k: v.item() for k, v in metrics.items()}, before=before,
                       grads={k: torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
                              for k, p in state.params.items()},
                       after={k: p.detach().cpu() for k, p in state.params.items()})
            if kind == "dmd":
                with torch.no_grad():
                    feats = model.feature_extractor(x0_l.float(), mesh)
                res["features"] = [gather_rows(f, mesh).cpu() for f in feats]
            out[kind] = res
            del model, state, step
    return out


def dp_ldm_steps(device, mesh=None, tp: bool = False, keep_grads: bool = False) -> dict:
    """DP_LDM_STEPS steps of the LDM ControlNet trainer at config/celebhq.yaml's
    full width, float32, on LDM_BATCH-row global batches with 1024^2 hints
    (this rank's rows under ``mesh``) and injected global draws: the losses,
    the launches of kernels a, b and c, the wall ms a step and the bytes a
    step through the model group; with ``keep_grads`` the first step's
    gradients, joined whole, on the CPU.  ``tp``: the parameters sharded
    over ``mesh``'s model axis first (``parallel/tp.py``), with each rank's
    parameter bytes on the card against ``tp_memory_report`` and, after the
    steps, kernel c on the gathered remainder weights."""
    from controlnet_tpu_torch import cli
    from controlnet_tpu_torch.parallel import tp as tp_mod
    from controlnet_tpu_torch.parallel.tp import (tp_full_state_dict, tp_memory_report,
                                                  tp_shard_params)

    mods, states, run = latent_trainer("controlnet", "float32", device, mesh)
    cn, params = mods["cn"], states[""].params
    res: dict = {}
    if tp:
        report = tp_memory_report(cn, mesh.model_parallel)
        tp_shard_params(cn, mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res.update(param_bytes=torch.cuda.memory_allocated(device),
                   tensor_bytes=sum(p.numel() * p.element_size() for p in cn.parameters()),
                   per_device_bytes=report["per_device_bytes"],
                   total_bytes=report["total_bytes"],
                   params=sum(p.numel() for p in cn.parameters()))
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, times, grads = [], [], None
    reset_launch_counts()
    tp_mod.moved_bytes = 0
    for i in range(DP_LDM_STEPS):
        batch = latent_batch("controlnet", g, device)
        draws = latent_draws("controlnet", batch, g, device)
        batch = cli.put_batch(batch, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run(batch, i, g, **draws).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if keep_grads and grads is None:
            grads = {k: p.grad.detach().clone() for k, p in params.items()}
    res.update(losses=losses, launches=launch_counts(),
               ms=1e3 * sum(times[1:]) / max(1, len(times) - 1),
               model_group_bytes=tp_mod.moved_bytes / DP_LDM_STEPS)
    if keep_grads:
        if tp:
            grads = tp_full_state_dict(cn, mesh, grads)
        res["grads"] = {k: v.cpu() for k, v in grads.items()}
    if tp:
        res["conv"] = tp_conv_check(cn, device)
    return res


def dp_tool_config(config: dict, task: str) -> str:
    """The ControlNet trainer tool's config at full width: one epoch of
    batch 64 under ``dp_work()/task``."""
    import yaml

    cfg = copy.deepcopy(config)
    cfg["train_params"].update(task_name=os.path.join(dp_work(), task), controlnet_epochs=1,
                               ckpt_save_every_epochs=1, batch_size=BATCH)
    path = os.path.join(dp_work(), f"{task}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def dp_tools(ckpt: str, path: str, num_samples: int) -> dict:
    """Through the tools' ``main`` on the config at ``path``:
    train_ddpm_controlnet for one epoch on the seeded .npy set (hints from
    the port's canny on the card), then sample_ddpm_controlnet (DDIM,
    DP_SAMPLE_STEPS steps, ``num_samples`` samples from the seeded .pth
    ``ckpt``).  Returns the sample tool's final samples and the trainer's
    wall seconds."""
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet, train_ddpm_controlnet

    start = time.perf_counter()
    train_ddpm_controlnet.main(["--config", path, "--images",
                                os.path.join(dp_work(), "images.npy"), "--hint_backend", "tpu"])
    train_s = time.perf_counter() - start
    traj = sample_ddpm_controlnet.main([
        "--config", path, "--ckpt", ckpt, "--hints", os.path.join(dp_work(), "hints.npy"),
        "--num_samples", str(num_samples), "--sampler", "ddim", "--sampler_steps",
        str(DP_SAMPLE_STEPS), "--save_every", str(DP_SAMPLE_STEPS)])
    return dict(samples=torch.from_numpy(traj[-1]), train_s=train_s)


def dp_nccl_world1(config: dict, device) -> dict:
    """Check 1, in a process of its own with torchrun's environment for one
    rank: one ControlNet step with no mesh, then the same step through the
    data-parallel path on an NCCL group of one (all-reduces, sliced draws),
    under deterministic cuDNN."""
    from controlnet_tpu_torch.parallel.mesh import make_mesh

    images = dp_images(device)
    base = seeded_unet_state_dict(config)
    plain = dp_cn_steps(config, base, images, device, "float32")
    mesh = make_mesh()  # the tools' default on a card: NCCL
    if mesh.backend != "nccl" or mesh.world_size != 1:
        raise SystemExit(f"expected an NCCL group of one, got {mesh}")
    dp = dp_cn_steps(config, base, images, device, "float32", mesh)
    loss_diff = (dp["losses"] - plain["losses"]).abs().max().item()
    weight_diff = max((dp["after"][k] - plain["after"][k]).abs().max().item()
                      for k in plain["after"])
    return dict(backend=mesh.backend, loss_max_abs_diff=loss_diff,
                weight_max_abs_diff=weight_diff, launches=dp["launches"], steps=DP_STEPS,
                tp=tp_nccl_world1(config, device, plain))


def parallel_rank(spec: str) -> int:
    """The child side of phases 38, 39 and 41: ``spec`` names the check and,
    for a run of several ranks, the rank and the file rendezvous.  Writes its results with
    ``torch.save`` to ``spec["out"]``."""
    import torch.distributed as dist

    args = json.loads(spec)
    if args["check"] in ("latent_tools", "tp_mnist", "tp_ldm"):
        return multi_rank(args)
    device = torch.device(DEVICE)  # every rank on the one card
    config = mnist_config()
    if args["check"] == "tp_nccl":
        torch.save(tp_nccl_world1(config, device), args["out"])
        dist.destroy_process_group()
        return 0
    if args["check"] == "nccl":
        torch.save(dp_nccl_world1(config, device), args["out"])
        dist.destroy_process_group()
        return 0
    from controlnet_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{args['init']}", rank=args["rank"],
                            world_size=DP_WORLD)
    mesh = make_mesh(device=device)
    images = dp_images(device)
    base = seeded_unet_state_dict(config)
    out = {"cn": {name: dp_cn_steps(config, base, images, device, name, mesh)
                  for name in ("float32", "bfloat16")}}
    out["distill"] = dp_distill_steps(config, seeded_teacher(args["ckpt"]), images, device, mesh)
    out["ldm"] = dp_ldm_steps(device, mesh)
    torch.cuda.empty_cache()
    out["tools"] = dp_tools(args["ckpt"], args["config"], DP_SAMPLES)
    torch.save(out, args["out"])
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(specs: list, env: dict) -> None:
    """Start one fresh process per spec (``--parallel-rank``) on the card,
    wait for all, pass their log lines on; a failure fails the run."""
    runs = run_fresh([(["--parallel-rank", json.dumps(spec)], env) for spec in specs], 600,
                     with_stderr=True)
    for i, (_, lines) in enumerate(runs):
        for line in lines[-40:]:
            log(f"  [rank {i}] {line}")
    if any(code != 0 for code, _ in runs):
        raise SystemExit(f"ranks failed (exit codes {[code for code, _ in runs]})")


def _rel_max(a: dict, b: dict) -> float:
    """max |a - b| over max |b|, over every tensor of two dicts."""
    scale = max(v.abs().max().item() for v in b.values())
    return max((a[k] - b[k]).abs().max().item() for k in b) / max(scale, 1e-30)


def phase_parallel(config: dict, ckpt: str, device) -> dict:
    """Phase 38: data parallelism on the card, at config/mnist.yaml's full
    width and global batch 64 (check 5 at config/celebhq.yaml's)."""
    import numpy as np

    from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints
    from controlnet_tpu_torch.train.state import TrainState

    shutil.rmtree(dp_work(), ignore_errors=True)
    os.makedirs(dp_work())
    np.save(os.path.join(dp_work(), "images.npy"), seeded_digits(DP_TOOL_IMAGES))
    np.save(os.path.join(dp_work(), "hints.npy"), seeded_hints(16, 28))
    base = seeded_unet_state_dict(config)
    paths = {}
    for task in ("one", "two"):  # written here: the ranks only read them
        os.makedirs(os.path.join(dp_work(), task))
        torch.save(base, os.path.join(dp_work(), task, config["train_params"]["ddpm_ckpt_name"]))
        paths[task] = dp_tool_config(config, task)
    lr = config["train_params"]["controlnet_lr"]
    start = time.perf_counter()

    # 1: NCCL at world size 1
    out1 = os.path.join(dp_work(), "nccl.pt")
    run_ranks([{"check": "nccl", "out": out1}],
              {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "RANK": "0",
               "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    nccl = torch.load(out1, weights_only=False)
    REFS["tp_nccl"] = nccl.pop("tp")
    ok1 = nccl["loss_max_abs_diff"] == 0.0 and nccl["weight_max_abs_diff"] == 0.0
    log(f"parallel 1: NCCL group of one ({nccl['backend']}), {DP_STEPS} ControlNet steps through "
        f"the data-parallel path against no mesh: losses max |diff| {nccl['loss_max_abs_diff']}, "
        f"weights {nccl['weight_max_abs_diff']} (must be 0) -> {'ok' if ok1 else 'FAIL'}")
    if not ok1:
        raise SystemExit("the NCCL path at world size 1 is not the one-process step")

    # the one-process references, then the two ranks over gloo on cuda:0
    images = dp_images(device)
    ref_cn = {name: dp_cn_steps(config, base, images, device, name)
              for name in ("float32", "bfloat16")}
    ref_distill = dp_distill_steps(config, seeded_teacher(ckpt), images, device)
    ref_ldm = dp_ldm_steps(device, keep_grads=True)  # phase 41 compares its gradients
    REFS.update(cn=ref_cn, ldm=ref_ldm)
    noisy_tool: dict = {}
    apply = TrainState.apply_gradients

    def recording(self, *extra):  # the one-process tool run's noise-floor weights
        for k, p in self.params.items():
            low = (p.grad.abs() < NOISE_FLOOR).cpu()
            noisy_tool[k] = low if k not in noisy_tool else noisy_tool[k] | low
        return apply(self, *extra)

    TrainState.apply_gradients = recording
    try:
        ref_tools = dp_tools(ckpt, paths["one"], DP_SAMPLES + 1)  # the padded count
    finally:
        TrainState.apply_gradients = apply
    del images
    torch.cuda.empty_cache()
    init = os.path.join(dp_work(), "pg")
    outs = [os.path.join(dp_work(), f"rank{r}.pt") for r in range(DP_WORLD)]
    run_ranks([{"check": "gloo", "rank": r, "init": init, "out": outs[r], "ckpt": ckpt,
                "config": paths["two"]} for r in range(DP_WORLD)], {"LOCAL_RANK": "0"})
    ranks = [torch.load(o, weights_only=False) for o in outs]
    res: dict = {"backend_two_ranks": "gloo", "world": DP_WORLD, "note": DP_SCALING_NOTE}
    ok = True

    # 2: three ControlNet steps, f32 and bf16
    res["cn"] = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        dp, ref = ranks[0]["cn"][name], ref_cn[name]
        loss_err = ((dp["losses"] - ref["losses"]).abs().max()
                    / ref["losses"].abs().max().clamp(min=1.0)).item()
        grad_err = _rel_max(dp["grads"], ref["grads"])
        noisy = {k: dp["noisy"][k] | ref["noisy"][k] for k in ref["noisy"]}
        w = _weights_diff(dp["after"], ref["after"], ref["before"], noisy)
        in_step = all(torch.equal(ranks[1]["cn"][name]["after"][k], v)
                      for k, v in dp["after"].items())
        launches = [r["cn"][name]["launches"] for r in ranks]
        want = (26 * DP_STEPS, 18 * DP_STEPS)
        good = (loss_err <= MODEL_TOL[dtype] and grad_err <= MODEL_TOL[dtype] and in_step
                and all(tuple(x) == want for x in launches)
                and (w["mean"] / lr < 0.15 and w["cos"] > 0.97 if dtype == torch.bfloat16
                     else w["clean_max"] / lr < 1e-2))
        ok = ok and good
        res["cn"][name] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                               weights_clean_max_lr=w["clean_max"] / lr,
                               weights_mean_lr=w["mean"] / lr, update_cos=w["cos"],
                               clean_share=w["clean_share"], ranks_bit_equal=in_step,
                               launches_per_rank=launches, ms_per_step_two_ranks=dp["ms"],
                               ms_per_step_one_process=ref["ms"])
        log(f"parallel 2: {DP_STEPS} ControlNet steps {name}, 2 ranks x {BATCH // DP_WORLD} rows "
            f"(gloo, cuda:0) vs 1 process x {BATCH}: losses rel err {loss_err:.3g}, first-step "
            f"grads rel err {grad_err:.3g} (tol {MODEL_TOL[dtype]:g}); weights max |diff| "
            f"{w['clean_max'] / lr:.3g} lr over the {w['clean_share']:.3f} above the floor, mean "
            f"{w['mean'] / lr:.3g} lr, cos {w['cos']:.6f}; ranks bit-equal {in_step}; launches "
            f"a/b per rank {launches} (want {want}); {dp['ms']:.1f} vs {ref['ms']:.1f} ms/step "
            f"({DP_SCALING_NOTE}) -> {'ok' if good else 'FAIL'}")
    res["allreduce_bytes_per_step"] = ranks[0]["cn"]["float32"]["allreduce_bytes"]

    # 3: the tools through their main
    tp = config["train_params"]
    name = tp["controlnet_ckpt_name"]
    step_dirs = {t: sorted(os.listdir(os.path.join(dp_work(), t, name[:-4])))
                 for t in ("one", "two")}
    one = torch.load(os.path.join(dp_work(), "one", name), weights_only=True)
    two = torch.load(os.path.join(dp_work(), "two", name), weights_only=True)
    trainable = sorted(noisy_tool)
    before = {k: v for k, v in seeded_controlnet_from_base(config, base).items()}
    w = _weights_diff({k: two[k] for k in trainable}, {k: one[k] for k in trainable},
                      {k: before[k] for k in trainable}, noisy_tool)
    frozen_equal = all(torch.equal(one[k], two[k]) for k in one if k not in noisy_tool)
    s2, s1 = ranks[0]["tools"]["samples"], ref_tools["samples"][:DP_SAMPLES]
    sample_err = ((s2 - s1).abs().max() / s1.abs().max()).item()
    good = (step_dirs == {"one": ["1.pt"], "two": ["1.pt"]} and frozen_equal
            and w["clean_max"] / lr < 1e-2 and s2.shape == s1.shape
            and sample_err <= MODEL_TOL[torch.float32])
    ok = ok and good
    res["tools"] = dict(checkpoints=step_dirs, weights_clean_max_lr=w["clean_max"] / lr,
                        clean_share=w["clean_share"], frozen_bit_equal=frozen_equal,
                        sample_rel_err=sample_err, samples=DP_SAMPLES,
                        train_s_two_ranks=ranks[0]["tools"]["train_s"],
                        train_s_one_process=ref_tools["train_s"])
    log(f"parallel 3: train_ddpm_controlnet main, 1 epoch of {DP_TOOL_IMAGES} images, 2 ranks vs "
        f"1 process: checkpoints {step_dirs}, .pth weights max |diff| {w['clean_max'] / lr:.3g} "
        f"lr over the {w['clean_share']:.3f} above the floor, frozen bit-equal {frozen_equal}; "
        f"sample_ddpm_controlnet main, DDIM {DP_SAMPLE_STEPS} steps, {DP_SAMPLES} samples "
        f"(padded to {DP_SAMPLES + 1}) vs 1 process: rel err {sample_err:.3g} -> "
        f"{'ok' if good else 'FAIL'}")

    # 4: one consistency and one DMD step
    res["distill"] = {}
    for kind in ("ddpm_distillation", "dmd"):
        dp, ref = ranks[0]["distill"][kind], ref_distill[kind]
        loss_key = "total_loss"
        loss_err = abs(dp["metrics"][loss_key] - ref["metrics"][loss_key]) / max(
            abs(ref["metrics"][loss_key]), 1.0)
        grad_err = _rel_max(dp["grads"], ref["grads"])
        noisy = {k: (ref["grads"][k].abs() < NOISE_FLOOR) | (dp["grads"][k].abs() < NOISE_FLOOR)
                 for k in ref["grads"]}
        w = _weights_diff(dp["after"], ref["after"], ref["before"], noisy)
        dlr = config["train_params"]["consistency_lr" if kind != "dmd"
                                     else "distribution_matching_lr"]
        entry = dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                     weights_clean_max_lr=w["clean_max"] / dlr)
        good = (loss_err <= MODEL_TOL[torch.float32] and grad_err <= MODEL_TOL[torch.float32]
                and w["clean_max"] / dlr < 1e-2)
        if kind == "dmd":
            feat_err = max(((a - b).abs().max() / b.abs().max()).item()
                           for a, b in zip(dp["features"], ref["features"]))
            entry["batchnorm_features_rel_err"] = feat_err
            good = good and feat_err <= MODEL_TOL[torch.float32]
        ok = ok and good
        res["distill"][kind] = entry
        log(f"parallel 4: one {kind} step, 2 ranks vs 1 process: loss rel err {loss_err:.3g}, "
            f"grads rel err {grad_err:.3g}, weights max |diff| {w['clean_max'] / dlr:.3g} lr"
            + (f", feature extractor (global-batch BatchNorm) rel err "
               f"{entry['batchnorm_features_rel_err']:.3g}" if kind == "dmd" else "")
            + f" -> {'ok' if good else 'FAIL'}")

    # 5: the LDM ControlNet trainer at full width
    dp, ref = ranks[0]["ldm"], ref_ldm
    loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(dp["losses"], ref["losses"]))
    launches = [tuple(r["ldm"]["launches"]) for r in ranks]
    want = (22 * DP_LDM_STEPS, 14 * DP_LDM_STEPS, 7 * DP_LDM_STEPS)
    good = loss_err <= MODEL_TOL[torch.float32] and all(x == want for x in launches)
    ok = ok and good
    res["ldm"] = dict(loss_rel_err=loss_err, launches_per_rank=launches,
                      ms_per_step_two_ranks=dp["ms"], ms_per_step_one_process=ref["ms"])
    log(f"parallel 5: {DP_LDM_STEPS} LDM ControlNet steps (celebhq width, 1024^2 hints), 2 ranks "
        f"x {LDM_BATCH // DP_WORLD} rows vs 1 process x {LDM_BATCH}: losses {dp['losses']} vs "
        f"{ref['losses']} (rel err {loss_err:.3g}); launches a/b/c per rank {launches} (want "
        f"{want}); {dp['ms']:.1f} vs {ref['ms']:.1f} ms/step -> {'ok' if good else 'FAIL'}")
    res["nccl_world1"] = nccl
    res["seconds"] = round(time.perf_counter() - start, 1)
    if not ok:
        raise SystemExit("data parallelism disagrees with one process")
    return res


def seeded_controlnet_from_base(config: dict, base: dict) -> dict:
    """The ControlNet trainer tool's starting weights (its ``make_trainer`` on
    the CPU): the trunks from ``base``, the control branch from its seed."""
    from controlnet_tpu_torch.tools import train_ddpm_controlnet as tool

    cn, _, _ = tool.make_trainer(config, base, "cpu", seed=int(config["train_params"].get(
        "seed", 0)))
    return {k: v.detach().clone() for k, v in cn.state_dict().items()}


# ---------------------------------------------------------------------------
# Phases 39-41: the rest of multi-GPU.  39: the four latent tools'
# data-parallel paths at config/celebhq.yaml's widths, two gloo ranks on
# cuda:0 against one process.  40: the serve tool's replicas, two on cuda:0
# against one.  41: Megatron tensor parallelism (parallel/tp.py) over a 2-D
# (data, model) mesh: an NCCL group of one with a model axis of 1; the MNIST
# ControlNet on a (2, 2) mesh of four gloo ranks; the CelebA-HQ LDM
# ControlNet on (1, 2); kernels a, b and c at the TP shapes against their
# plain versions; dryrun_multichip(4).  One card holds every rank, so every
# time here is of ranks time-sliced on it, not a scaling figure.

LT_WORLD = 2
LT_IMAGES = 8         # the latent tools' seeded 128^2 set: 2 VAE-GAN calls of 4, 1 LDM step of 8
LT_SAMPLES = 3        # the sample tools' count at two ranks, padded to 4
LT_SAMPLE_STEPS = 4   # DPM-Solver++ steps of both latent sample tools
TP_WORLD = 4          # check (ii) runs DP_STEPS MNIST ControlNet steps per compute type
# each rank's memory_allocated after sharding against tp_memory_report's
# per_device_bytes, relative: the caching allocator leaves a large block
# unsplit when less than 1 MiB would remain, so a large tensor may hold up to
# 1 MiB more than it asked (its tensors' own bytes must match exactly)
TP_BYTES_TOL = 0.05


def ranks_note(n: int) -> str:
    return f"{n} ranks time-sliced on one card, gloo through the host: not a scaling figure"


def lt_work() -> str:
    return os.path.join(REPO, "build", "smoke", "latent_dp")


def lt_config(task: str) -> str:
    """config/celebhq.yaml at full width, one epoch of each latent trainer,
    under ``lt_work()/task``.  The VAE-GAN's epoch accumulates its two calls
    into one Adam update: after a first update the two runs' weights differ
    by float rounding, which the next calls' Adam normalisation amplifies in
    this randomly initialised VAE far past the tolerance, while its one
    update from the averaged gradient holds it.  ``disc_start`` 1: the
    second call trains the PatchGAN (its BatchNorm over the global batch)
    and adds its loss to the VAE's."""
    import yaml

    cfg = celebhq_config()
    cfg["train_params"].update(task_name=os.path.join(lt_work(), task), autoencoder_epochs=1,
                               ldm_epochs=1, ckpt_save_every_epochs=1, disc_start=1,
                               autoencoder_img_save_steps=10**6,
                               autoencoder_acc_steps=LT_IMAGES // cfg["train_params"][
                                   "autoencoder_batch_size"])
    path = os.path.join(lt_work(), f"{task}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def lt_tools(config_path: str, num_samples: int, keep_grads: bool = True) -> dict:
    """Phase 39's run of the four latent tools through their ``main`` on the
    seeded files of ``lt_work()``: train_vae (1 epoch of LT_IMAGES at 128^2,
    batch 4), train_ldm_vae (1 epoch: one short batch of them, encoded by the
    seeded VAE), sample_ldm_vae and sample_ldm_controlnet (DPM
    LT_SAMPLE_STEPS steps, ``num_samples`` samples, decoded; the ControlNet's
    hints at 1024^2 through kernel c; none when it is 0) on the seeded .pth
    files.  Returns the
    decoded samples, each tool's launches of a / b / c and wall seconds, and
    with ``keep_grads`` each trained parameter's weights before its first
    update and that update's gradient (averaged over the ranks; on the
    CPU).  The trainers run cuDNN's deterministic algorithms."""
    import numpy as np

    from controlnet_tpu_torch.tools import (sample_ldm_controlnet, sample_ldm_vae, train_ldm_vae,
                                            train_vae)
    from controlnet_tpu_torch.train.state import TrainState

    work = lt_work()
    out = {"launches": {}, "seconds": {}, "samples": {}, "before": {}, "grads": {}}
    apply = TrainState.apply_gradients

    def recording(self, *extra):
        for k, p in self.params.items():
            out["before"].setdefault(k, p.detach().cpu().clone())
        updates = self.updates
        res = apply(self, *extra)
        if self.updates > updates:  # .grad holds the update's (accumulated) gradient
            for k, p in self.params.items():
                out["grads"].setdefault(k, p.grad.detach().cpu().clone())
        return res

    def run(name, fn, argv):
        reset_launch_counts()
        start = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - start
        out["launches"][name] = launch_counts()
        return res

    images, vae = os.path.join(work, "images.npy"), os.path.join(work, "vae.pth")
    if keep_grads:
        TrainState.apply_gradients = recording
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            run("train_vae", train_vae.main, ["--config", config_path, "--images", images])
            run("train_ldm_vae", train_ldm_vae.main,
                ["--config", config_path, "--images", images, "--vae_ckpt", vae])
    finally:
        TrainState.apply_gradients = apply
    fixed = ["--config", config_path, "--vae_ckpt", vae, "--num_samples", str(num_samples),
             "--sampler", "dpm", "--sampler_steps", str(LT_SAMPLE_STEPS), "--save_every",
             str(LT_SAMPLE_STEPS)]
    for name, tool, extra in () if not num_samples else (
            ("sample_ldm_vae", sample_ldm_vae, ["--ckpt", os.path.join(work, "ldm.pth")]),
            ("sample_ldm_controlnet", sample_ldm_controlnet,
             ["--ckpt", os.path.join(work, "cn.pth"), "--hints", os.path.join(work, "hints.npy")])):
        out["samples"][name] = torch.from_numpy(np.asarray(run(name, tool.main, fixed + extra)))
    return out


def phase_latent_tools_dp(device) -> dict:
    """Phase 39: the four latent tools at two ranks against one process.  A
    trainer is held by its update's gradient, each tensor within MODEL_TOL
    of that tensor's own largest gradient, and by its written weights
    (LATENT_WEIGHT_TOL lr) where the gradient stands above the noise floor
    and above 10 x MODEL_TOL of its tensor's largest: there the first check
    leaves the gradient's sign no room to flip (Adam's first step is lr
    times the sign; below, two runs may disagree on it).  Both bounds come
    from the one-process run, so a fault of the two-rank path cannot widen
    them.  The trainers run cuDNN's deterministic algorithms: with its
    default ones a discriminator weight's gradient moved by up to ~1e-2 of
    its largest between runs of the same code.  Every tensor's update
    gradient must be nonzero: the discriminator's too."""
    import numpy as np

    shutil.rmtree(lt_work(), ignore_errors=True)
    os.makedirs(lt_work())
    config = celebhq_config()
    size = config["dataset_params"]["im_size"]
    rng = np.random.default_rng(SEED)
    np.save(os.path.join(lt_work(), "images.npy"),
            (rng.random((LT_IMAGES, size, size, 3)) * 255).astype(np.uint8))
    write_seeded_ldm_hints(LT_SAMPLES + 1, config["dataset_params"]["canny_im_size"],
                           os.path.join(lt_work(), "hints.npy"))
    write_seeded_ldm_checkpoints(config, os.path.join(lt_work(), "cn.pth"),
                                 os.path.join(lt_work(), "vae.pth"))
    torch.save(seeded_ldm_state_dict(), os.path.join(lt_work(), "ldm.pth"))
    paths = {task: lt_config(task) for task in ("one", "two")}
    for task in paths:
        os.makedirs(os.path.join(lt_work(), task))
    start = time.perf_counter()

    one = lt_tools(paths["one"], LT_SAMPLES + 1)
    torch.cuda.empty_cache()
    init = os.path.join(lt_work(), "pg")
    outs = [os.path.join(lt_work(), f"rank{r}.pt") for r in range(LT_WORLD)]
    run_ranks([{"check": "latent_tools", "rank": r, "init": init, "out": outs[r],
                "world": LT_WORLD, "config": paths["two"]} for r in range(LT_WORLD)],
              {"LOCAL_RANK": "0"})
    ranks = [torch.load(o, weights_only=False) for o in outs]
    two = ranks[0]

    tp = config["train_params"]
    res: dict = {"world": LT_WORLD, "note": ranks_note(LT_WORLD)}
    ok = True
    for name, files, lr in (("train_vae", (tp["vae_autoencoder_ckpt_name"],
                                           tp["vae_discriminator_ckpt_name"]),
                             tp["autoencoder_lr"]),
                            ("train_ldm_vae", (tp["ldm_ckpt_name"],), tp["ldm_lr"])):
        a, b, dirs = {}, {}, {}
        for f in files:
            a.update(torch.load(os.path.join(lt_work(), "two", f), weights_only=True))
            b.update(torch.load(os.path.join(lt_work(), "one", f), weights_only=True))
            dirs[f] = [sorted(os.listdir(os.path.join(lt_work(), t, f[:-4])))
                       for t in ("one", "two")]
        g1, g2 = ({k: g[k] for k in b} for g in (one["grads"], two["grads"]))
        top = {k: g1[k].abs().max().item() for k in b}
        errs = {k: (g2[k] - g1[k]).abs().max().item() / max(top[k], 1e-30) for k in b}
        worst = max(errs, key=errs.get)
        trained = all(top[k] > 0 for k in b)
        floor = {k: max(NOISE_FLOOR, 10 * MODEL_TOL[torch.float32] * top[k]) for k in b}
        noisy = {k: (g1[k].abs() < floor[k]) | (g2[k].abs() < floor[k]) for k in b}
        w = _weights_diff(a, b, {k: one["before"][k] for k in b}, noisy)
        with open(os.path.join(lt_work(), f"{name}_tensors.json"), "w") as f:
            json.dump({k: dict(largest=top[k], rel_err=errs[k]) for k in b}, f, indent=0)
        launches = [tuple(r["launches"][name]) for r in ranks]
        # LATENT_WEIGHT_TOL: at these learning rates one float32 ulp of a
        # GroupNorm scale near 1 is 0.012 lr (phase 24's tolerance)
        good = (all(d == [["1.pt"], ["1.pt"]] for d in dirs.values())
                and errs[worst] <= MODEL_TOL[torch.float32] and trained
                and w["clean_max"] / lr < LATENT_WEIGHT_TOL and w["clean_share"] > 0
                and launches[0] == tuple(one["launches"][name]))
        ok = ok and good
        res[name] = dict(grad_rel_err=errs[worst], grad_worst_tensor=worst, tensors=len(b),
                         every_tensor_trained=trained, weights_clean_max_lr=w["clean_max"] / lr,
                         clean_share=w["clean_share"], update_cos=w["cos"], checkpoints=dirs,
                         launches_per_rank=launches, launches_one_process=one["launches"][name],
                         s_two_ranks=two["seconds"][name], s_one_process=one["seconds"][name])
        log(f"latent tools 39: {name} main, 1 epoch, 2 ranks vs 1 process: update gradients rel "
            f"err up to {errs[worst]:.3g} of their own tensor's largest, in {worst} (tol "
            f"{MODEL_TOL[torch.float32]:g}), each of {len(b)} tensors' nonzero {trained}; "
            f"weights max |diff| {w['clean_max'] / lr:.3g} lr over the {w['clean_share']:.3f} "
            f"above the floor, cos {w['cos']:.6f}; checkpoints {dirs}; launches a/b/c per "
            f"rank {launches} (one process {tuple(one['launches'][name])}); "
            f"{two['seconds'][name]:.1f} vs {one['seconds'][name]:.1f} s "
            f"({ranks_note(LT_WORLD)}) -> {'ok' if good else 'FAIL'}")
    for name in ("sample_ldm_vae", "sample_ldm_controlnet"):
        s2, s1 = two["samples"][name], one["samples"][name][:LT_SAMPLES]
        err = ((s2 - s1).abs().max() / s1.abs().max()).item()
        launches = [tuple(r["launches"][name]) for r in ranks]
        good = (s2.shape == s1.shape and err <= MODEL_TOL[torch.float32]
                and all(x == tuple(one["launches"][name]) for x in launches)
                and all(x[0] > 0 for x in launches)
                and (name != "sample_ldm_controlnet" or all(x[2] == 7 for x in launches)))
        ok = ok and good
        res[name] = dict(sample_rel_err=err, samples=LT_SAMPLES, launches_per_rank=launches,
                         launches_one_process=one["launches"][name],
                         s_two_ranks=two["seconds"][name], s_one_process=one["seconds"][name])
        log(f"latent tools 39: {name} main, DPM {LT_SAMPLE_STEPS} steps + decode, "
            f"{LT_SAMPLES} samples (padded to {LT_SAMPLES + 1}) at 2 ranks vs 1 process: rel err "
            f"{err:.3g} (tol {MODEL_TOL[torch.float32]:g}); launches a/b/c per rank {launches} "
            f"(one process {tuple(one['launches'][name])}) -> {'ok' if good else 'FAIL'}")
    res["seconds"] = round(time.perf_counter() - start, 1)
    if not ok:
        raise SystemExit("the latent tools' data-parallel paths disagree with one process")
    return res


def phase_serve_replicas(config: dict, ckpt: str, device) -> dict:
    """Phase 40: the serve tool with two replicas of its model on the card
    (``make_server(..., devices=)``; on a host with several cards the default
    is one replica per card) against one replica: a 16-row bucket split 8 + 8
    and a 1-row bucket on the first replica, dpm_controlnet and the
    consistency student at 4 steps, through /generate_batch."""
    import io
    import threading
    import types

    import numpy as np

    from controlnet_tpu_torch.tools import serve
    from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train

    task = os.path.join(REPO, "build", "smoke", "serve_replicas")
    shutil.rmtree(task, ignore_errors=True)
    os.makedirs(task)
    write_seeded_students(config, task)
    card = torch.device("cuda", 0) if device.type == "cuda" else device
    hints = seeded_hints(SERVE_BATCH, 28)
    res: dict = {"replicas": 2,
                 "note": "two replicas time-sliced on one card: not a scaling figure"}
    ok = True
    start = time.perf_counter()
    for model, path in (("dpm_controlnet", ckpt),
                        ("consistency", os.path.join(task, cd_train.CKPT_NAME))):
        runs = {}
        for n in (1, 2):
            args = types.SimpleNamespace(model=model, ckpt=path, host="127.0.0.1", port=0,
                                         seed=SEED, max_batch=SERVE_BATCH, max_steps=8,
                                         dynamic_batching=True, batch_window_ms=2.0, device=None,
                                         attn_fused_proj=False)
            server = serve.make_server(args, config, devices=[card] * n)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                out = {}
                for rows in (SERVE_BATCH, 1):
                    reset_launch_counts()
                    url = f"http://127.0.0.1:{server.server_address[1]}/generate_batch?steps=4"
                    status, headers, body, _ = _post(url, _npz(hints=hints[:rows]))
                    if status != 200:
                        raise SystemExit(f"{model} with {n} replicas answered {status}")
                    with np.load(io.BytesIO(body)) as z:
                        out[rows] = (torch.from_numpy(z["samples"]),
                                     float(headers["X-Latency-Ms"]), launch_counts()[0])
            finally:
                server.shutdown()
                server.server_close()
                thread.join(10)
            runs[n] = out
        entry = {}
        for rows in (SERVE_BATCH, 1):
            s2, s1 = runs[2][rows][0], runs[1][rows][0]
            err = ((s2 - s1).abs().max() / s1.abs().max()).item()
            split = serve.splits_over_replicas(rows, 2)
            good = (s2.shape == s1.shape == (rows, 28, 28, 1) and err <= MODEL_TOL[torch.float32]
                    and runs[2][rows][2] == runs[1][rows][2] * (2 if split else 1) > 0)
            ok = ok and good
            entry[f"rows{rows}"] = dict(rel_err=err, split=split,
                                        launches_a=(runs[2][rows][2], runs[1][rows][2]),
                                        latency_ms=(runs[2][rows][1], runs[1][rows][1]))
            log(f"serve replicas 40: {model}, a {rows}-row request at 4 steps, 2 replicas on "
                f"cuda:0 vs 1: rel err {err:.3g} (tol {MODEL_TOL[torch.float32]:g}), split "
                f"{split}, launches of a {runs[2][rows][2]} vs {runs[1][rows][2]}, "
                f"{runs[2][rows][1]:.1f} vs {runs[1][rows][1]:.1f} ms (two replicas time-sliced "
                f"on one card: not a scaling figure) -> {'ok' if good else 'FAIL'}")
        res[model] = entry
    res["seconds"] = round(time.perf_counter() - start, 1)
    if not ok:
        raise SystemExit("two serve replicas disagree with one")
    return res


@contextlib.contextmanager
def record_attention_calls(into: set):
    """Record the (B, H, dh, Lq, Lk) of every kernel a call (the TP shapes)."""
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention.fused_attention_t

    def rec(qt, kt, vt):
        into.add((*qt.shape, kt.shape[3]))
        return orig(qt, kt, vt)

    cuda_attention.fused_attention_t = rec
    try:
        yield
    finally:
        cuda_attention.fused_attention_t = orig


def tp_attention_check(shapes: set, device) -> dict:
    """Kernels a and b at each recorded TP shape, f32 and bf16, against their
    plain versions on seeded inputs: max abs errors of the output and of the
    three gradients (these launches are not the main path's)."""
    from controlnet_tpu_torch.ops import cuda_attention

    g = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        fwd = bwd = 0.0
        for b, h, dh, lq, lk in sorted(shapes):
            q, k, v = (torch.randn((b, h, dh, n), generator=g, device=device).to(dtype)
                       .requires_grad_() for n in (lq, lk, lk))
            dout = torch.randn((b, h, dh, lq), generator=g, device=device).to(dtype)
            o = cuda_attention.fused_attention_t(q, k, v)
            grads = torch.autograd.grad(o, (q, k, v), dout)
            ref = cuda_attention.fused_attention_t_plain(q.detach(), k.detach(), v.detach())
            ref_grads = cuda_attention.fused_attention_t_bwd_plain(q.detach(), k.detach(),
                                                                   v.detach(), dout)
            fwd = max(fwd, (o.float() - ref.float()).abs().max().item())
            bwd = max(bwd, max((a.float() - r.float()).abs().max().item() / max(
                r.float().abs().max().item(), 1e-30) for a, r in zip(grads, ref_grads)))
        good = fwd <= KERNEL_TOL[dtype] and bwd <= BWD_KERNEL_TOL[dtype]
        out[str(dtype)[6:]] = dict(a_max_abs_err=fwd, b_max_rel_err=bwd, good=good)
    return out


def tp_conv_check(cn, device) -> dict:
    """Kernel c on the hint encoder's gathered remainder weights (every
    stride-1 3x3 conv of it that the plan shards, each weight gathered over
    the model group: a collective) against the plain version, at its
    full resolution, batch 2, f32 and bf16."""
    from controlnet_tpu_torch.nn.layers import Conv2d
    from controlnet_tpu_torch.ops import cuda_conv

    g = torch.Generator(device=device).manual_seed(SEED)
    size = celebhq_config()["dataset_params"]["canny_im_size"]
    errs, n = {"float32": 0.0, "bfloat16": 0.0}, 0
    for m in cn.hint_block.modules():
        if not (isinstance(m, Conv2d) and m.tp_gather and m.stride[0] == 1
                and m.kernel_size[0] == 3):
            continue
        with torch.no_grad():
            w, bias = m._param("weight"), m._param("bias")
        n += 1
        side = size >> _stage_of(cn, m)
        hw = (side, side)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((w.shape[1], 2, hw[0] * hw[1]), generator=g, device=device).to(dtype)
            with torch.no_grad():
                got = cuda_conv.conv3x3_tl(w, bias, x, hw)
                ref = cuda_conv.conv3x3_tl_plain(w, bias, x, hw)
            errs[str(dtype)[6:]] = max(errs[str(dtype)[6:]], (
                (got.float() - ref.float()).abs().max() / ref.float().abs().max()).item())
    good = n > 0 and all(errs[str(d)[6:]] <= CONV_TOL[d] for d in CONV_TOL)
    return dict(gathered_convs=n, max_rel_err=errs, good=good)


def _stage_of(cn, conv) -> int:
    """The number of stride-2 convs of the hint encoder before ``conv``."""
    from controlnet_tpu_torch.nn.layers import Conv2d

    k = 0
    for m in cn.hint_block.modules():
        if m is conv:
            return k
        if isinstance(m, Conv2d) and m.stride[0] == 2:
            k += 1
    raise ValueError("not a conv of the hint encoder")


def tp_nccl_world1(config: dict, device, plain: dict | None = None) -> dict:
    """Phase 41's check (i), in a process with torchrun's environment for
    one rank (phase 38's, when it runs): three ControlNet steps with no mesh
    (``plain``, when given), then the same steps on an NCCL group of one with
    a model axis of 1, through ``tp_shard_params`` (which shards nothing
    there)."""
    from controlnet_tpu_torch.parallel.mesh import make_mesh

    images = dp_images(device)
    base = seeded_unet_state_dict(config)
    plain = plain or dp_cn_steps(config, base, images, device, "float32")
    mesh = make_mesh(model_parallel=1)
    if mesh.backend != "nccl" or (mesh.world_size, mesh.model_parallel) != (1, 1):
        raise SystemExit(f"expected an NCCL group of one with a model axis of 1, got {mesh}")
    tp = dp_cn_steps(config, base, images, device, "float32", mesh, tp=True)
    return dict(backend=mesh.backend,
                loss_max_abs_diff=(tp["losses"] - plain["losses"]).abs().max().item(),
                weight_max_abs_diff=max((tp["after"][k] - plain["after"][k]).abs().max().item()
                                        for k in plain["after"]))


def multi_rank(args: dict) -> int:
    """The child side of phases 39 and 41's gloo runs: join the group of
    ``args["world"]`` ranks through the file rendezvous, run the check, write
    its results with ``torch.save`` to ``args["out"]``."""
    import torch.distributed as dist

    from controlnet_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(DEVICE)  # every rank on the one card
    dist.init_process_group("gloo", init_method=f"file://{args['init']}", rank=args["rank"],
                            world_size=args["world"])
    if args["check"] == "latent_tools":  # rank 0's gradients are every rank's
        out = lt_tools(args["config"], LT_SAMPLES, keep_grads=args["rank"] == 0)
    elif args["check"] == "tp_mnist":
        config = mnist_config()
        mesh = make_mesh(device=device, model_parallel=2)
        images = dp_images(device)
        base = seeded_unet_state_dict(config)
        shapes: set = set()
        with record_attention_calls(shapes):
            out = {"cn": {name: dp_cn_steps(config, base, images, device, name, mesh, tp=True)
                          for name in ("float32", "bfloat16")}}
        out["mesh"] = (mesh.data_size, mesh.model_parallel, mesh.data_index, mesh.model_index)
        out["shapes"] = sorted(shapes)
        if args["rank"] == 0:
            out["kernels"] = tp_attention_check(shapes, device)
        from controlnet_tpu_torch.parallel.dryrun import dryrun_multichip

        out["dryrun"] = dryrun_multichip(args["world"], device)
    else:  # tp_ldm; the first step's gradients joined on every rank, kept by rank 0
        mesh = make_mesh(device=device, model_parallel=2)
        out = dp_ldm_steps(device, mesh, tp=True, keep_grads=True)
        if args["rank"] != 0:
            del out["grads"]
    torch.save(out, args["out"])
    dist.destroy_process_group()
    return 0


def phase_tp(config: dict, device) -> dict:
    """Phase 41: tensor parallelism on the card."""
    shutil.rmtree(tp_work(), ignore_errors=True)
    os.makedirs(tp_work())
    lr = config["train_params"]["controlnet_lr"]
    start = time.perf_counter()
    res: dict = {}
    ok = True

    # (i) an NCCL group of one, model axis 1 (in phase 38's NCCL process when
    # it ran)
    nccl = REFS.get("tp_nccl")
    if nccl is None:
        out1 = os.path.join(tp_work(), "nccl.pt")
        run_ranks([{"check": "tp_nccl", "out": out1}],
                  {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "RANK": "0",
                   "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
        nccl = torch.load(out1, weights_only=False)
    good = nccl["loss_max_abs_diff"] == 0.0 and nccl["weight_max_abs_diff"] == 0.0
    ok = ok and good
    res["nccl_world1"] = nccl
    log(f"tensor parallel 41 (i): NCCL group of one, model axis 1, {DP_STEPS} ControlNet steps "
        f"through tp_shard_params and the mesh against no mesh: losses max |diff| "
        f"{nccl['loss_max_abs_diff']}, weights {nccl['weight_max_abs_diff']} (must be 0) -> "
        f"{'ok' if good else 'FAIL'}")

    # the one-process references: phase 38's, the same steps, when it ran
    ref_cn, ref_ldm = REFS.get("cn"), REFS.get("ldm")
    if ref_cn is None:
        images = dp_images(device)
        base = seeded_unet_state_dict(config)
        ref_cn = {name: dp_cn_steps(config, base, images, device, name)
                  for name in ("float32", "bfloat16")}
        del images
    if ref_ldm is None:
        ref_ldm = dp_ldm_steps(device, keep_grads=True)
    torch.cuda.empty_cache()

    # (ii), (iv), (v): four ranks, a (2, 2) mesh
    init = os.path.join(tp_work(), "pg4")
    outs = [os.path.join(tp_work(), f"mnist{r}.pt") for r in range(TP_WORLD)]
    run_ranks([{"check": "tp_mnist", "rank": r, "init": init, "out": outs[r],
                "world": TP_WORLD} for r in range(TP_WORLD)], {"LOCAL_RANK": "0"})
    ranks = [torch.load(o, weights_only=False) for o in outs]
    res["cn"] = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        tp, ref = ranks[0]["cn"][name], ref_cn[name]
        loss_err = ((tp["losses"] - ref["losses"]).abs().max()
                    / ref["losses"].abs().max().clamp(min=1.0)).item()
        grad_err = _rel_max(tp["grads"], ref["grads"])
        noisy = {k: tp["noisy"][k] | ref["noisy"][k] for k in ref["noisy"]}
        w = _weights_diff(tp["after"], ref["after"], ref["before"], noisy)
        in_step = all(torch.equal(r["cn"][name]["after"][k], v) for r in ranks[1:]
                      for k, v in tp["after"].items())
        launches = [tuple(r["cn"][name]["launches"]) for r in ranks]
        want = (26 * DP_STEPS, 18 * DP_STEPS)
        good = (loss_err <= MODEL_TOL[dtype] and grad_err <= MODEL_TOL[dtype] and in_step
                and all(x == want for x in launches)
                and (w["mean"] / lr < 0.15 and w["cos"] > 0.97 if dtype == torch.bfloat16
                     else w["clean_max"] / lr < 1e-2))
        ok = ok and good
        res["cn"][name] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                               weights_clean_max_lr=w["clean_max"] / lr,
                               weights_mean_lr=w["mean"] / lr, update_cos=w["cos"],
                               clean_share=w["clean_share"], ranks_equal=in_step,
                               launches_per_rank=launches, ms_per_step_four_ranks=tp["ms"],
                               ms_per_step_one_process=ref["ms"],
                               model_group_bytes_per_step=tp["model_group_bytes"])
        log(f"tensor parallel 41 (ii): {DP_STEPS} MNIST ControlNet steps {name} on a (2, 2) mesh "
            f"(4 gloo ranks on cuda:0, {BATCH // 2} rows a data index, 2 of 4 heads a rank) vs 1 "
            f"process x {BATCH}: losses rel err {loss_err:.3g}, first-step grads rel err "
            f"{grad_err:.3g} (tol {MODEL_TOL[dtype]:g}); weights max |diff| "
            f"{w['clean_max'] / lr:.3g} lr over the {w['clean_share']:.3f} above the floor, mean "
            f"{w['mean'] / lr:.3g} lr, cos {w['cos']:.6f}; joined weights equal on every rank "
            f"{in_step}; launches a/b per rank {launches} (want {want}); "
            f"{tp['model_group_bytes']:.0f} B a step a rank through the model group; "
            f"{tp['ms']:.1f} vs "
            f"{ref['ms']:.1f} ms/step ({ranks_note(TP_WORLD)}) -> {'ok' if good else 'FAIL'}")
    kern = ranks[0]["kernels"]
    good = all(v["good"] for v in kern.values())
    ok = ok and good
    res["kernels_tp_shapes"] = {"shapes": ranks[0]["shapes"], **kern}
    log(f"tensor parallel 41 (iv): kernels a and b at the {len(ranks[0]['shapes'])} per-rank TP "
        f"shapes (B, H/2, dh, Lq, Lk) {ranks[0]['shapes']} vs plain: "
        + ", ".join(f"{d}: a {v['a_max_abs_err']:.3g}, b rel {v['b_max_rel_err']:.3g}"
                    for d, v in kern.items()) + f" -> {'ok' if good else 'FAIL'}")
    dry = [r["dryrun"] for r in ranks]
    losses = dry[0]["losses"]
    good = (all(d["mesh"] == (2, 2) and d["losses"] == losses for d in dry)
            and sum(losses[-5:]) < sum(losses[:5]))
    ok = ok and good
    res["dryrun"] = dict(mesh=dry[0]["mesh"], loss_first5=sum(losses[:5]) / 5,
                         loss_last5=sum(losses[-5:]) / 5)
    log(f"tensor parallel 41 (v): dryrun_multichip(4) on cuda:0 (mesh (2, 2)), 20 steps: loss "
        f"{sum(losses[:5]) / 5:.5f} -> {sum(losses[-5:]) / 5:.5f} -> {'ok' if good else 'FAIL'}")

    # (iii): two ranks, a (1, 2) mesh, the CelebA-HQ LDM ControlNet
    init = os.path.join(tp_work(), "pg2")
    outs = [os.path.join(tp_work(), f"ldm{r}.pt") for r in range(2)]
    run_ranks([{"check": "tp_ldm", "rank": r, "init": init, "out": outs[r], "world": 2}
               for r in range(2)], {"LOCAL_RANK": "0"})
    ranks = [torch.load(o, weights_only=False) for o in outs]
    tp = ranks[0]
    loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(tp["losses"], ref_ldm["losses"]))
    # the first step's gradients, each tensor against its own largest: the
    # backward of the rank's heads, of the gathered weights and of the
    # GroupNorm sums over the model group
    grad_errs = {k: _rel_max({k: tp["grads"][k]}, {k: v}) for k, v in ref_ldm["grads"].items()}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    launches = [tuple(r["launches"]) for r in ranks]
    want = (22 * DP_LDM_STEPS, 14 * DP_LDM_STEPS, 7 * DP_LDM_STEPS)
    bytes_err = [abs(r["param_bytes"] - r["per_device_bytes"]) / r["per_device_bytes"]
                 for r in ranks]
    good = (loss_err <= MODEL_TOL[torch.float32] and grad_err <= MODEL_TOL[torch.float32]
            and set(tp["grads"]) == set(ref_ldm["grads"]) and all(x == want for x in launches)
            and all(e <= TP_BYTES_TOL for e in bytes_err) and all(r["conv"]["good"] for r in ranks)
            and all(r["tensor_bytes"] == r["per_device_bytes"] for r in ranks))
    ok = ok and good
    res["ldm"] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err, grad_worst_tensor=worst,
                      grad_rel_err_global=_rel_max(tp["grads"], ref_ldm["grads"]),
                      launches_per_rank=launches,
                      param_bytes_per_rank=[r["param_bytes"] for r in ranks],
                      tensor_bytes_per_rank=[r["tensor_bytes"] for r in ranks],
                      per_device_bytes=tp["per_device_bytes"], total_bytes=tp["total_bytes"],
                      bytes_rel_err=bytes_err, conv=tp["conv"],
                      model_group_bytes_per_step=tp["model_group_bytes"],
                      ms_per_step_two_ranks=tp["ms"], ms_per_step_one_process=ref_ldm["ms"])
    heads = celebhq_config()["ldm_params"]["num_heads"]
    log(f"tensor parallel 41 (iii): {DP_LDM_STEPS} LDM ControlNet steps (celebhq width, "
        f"{tp['total_bytes'] / 4e6:.1f} M parameters, {heads // 2} of {heads} heads a rank, "
        f"1024^2 hints) on a "
        f"(1, 2) mesh x {LDM_BATCH} vs 1 process: losses {tp['losses']} vs {ref_ldm['losses']} "
        f"(rel err {loss_err:.3g}); first-step gradients rel err {grad_err:.3g} of their own "
        f"tensor's largest, at worst in {worst} (tol {MODEL_TOL[torch.float32]:g}; "
        f"{res['ldm']['grad_rel_err_global']:.3g} of the largest of all); launches a/b/c per rank "
        f"{launches} (want {want}); parameter "
        f"bytes per rank {[r['param_bytes'] for r in ranks]} allocated, "
        f"{[r['tensor_bytes'] for r in ranks]} in the tensors, vs tp_memory_report "
        f"{tp['per_device_bytes']} (rel {max(bytes_err):.3g}, tol {TP_BYTES_TOL}); kernel c on "
        f"the {tp['conv']['gathered_convs']} gathered remainder weights vs plain "
        f"{tp['conv']['max_rel_err']}; {tp['model_group_bytes']:.0f} B a step a rank through "
        f"the model group; {tp['ms']:.1f} vs {ref_ldm['ms']:.1f} ms/step "
        f"({ranks_note(2)}) -> {'ok' if good else 'FAIL'}")
    res["seconds"] = round(time.perf_counter() - start, 1)
    if not ok:
        raise SystemExit("tensor parallelism disagrees with one process")
    return res


def tp_work() -> str:
    return os.path.join(REPO, "build", "smoke", "tp")


# Phase 42: the transposed-layout and dual-trunk forwards (UNet.forward_tl,
# ControlNet.forward_tl / forward_paired / forward_fused).  The fused forward
# is checked, not timed: no path runs it.
TL_TIMED = ("forward", "forward_tl", "forward_paired")
# launches of kernels (c, a, d) per call, the hint encode outside it: c on
# every stride-1 3x3 conv of a TL forward, a on every self-attention layer
# (one call for a paired layer of both trunks), d with the fused layer on
# (not at head dim 4: the decoder's last two MNIST layers stay on a)
TL_LAUNCHES = {
    "mnist": {"forward": (0, 26, 0), "forward_tl": (63, 26, 0), "forward_paired": (0, 16, 0),
              "forward_fused": (0, 16, 0), "unet_forward_tl": (38, 16, 0),
              "forward_paired_fused_proj": (0, 12, 4)},
    "ldm": {"forward": (0, 22, 0), "forward_tl": (51, 22, 0), "forward_paired": (0, 14, 0),
            "forward_fused": (0, 14, 0)},
}
TL_TIMED_CALLS = 3    # host-clock calls of each forward a round
TL_ROUNDS = 2         # rounds, in turns: TL_TIMED, then reversed
TL_PROFILE_CALLS = 1  # calls of each forward in its profiler window


def tl_counts() -> tuple[int, int, int]:
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj, cuda_conv

    return cuda_conv.launches, cuda_attention.launches, cuda_attention_proj.launches


def reset_tl_counts() -> None:
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj, cuda_conv

    cuda_conv.launches = cuda_attention.launches = cuda_attention_proj.launches = 0


@contextlib.contextmanager
def checked_conv(into: dict):
    """Hold every kernel-c call of this process against the plain version on
    the same inputs (the activations and views the model hands it): under
    (Cin, Cout, H, W, B), the calls and the worst max|err| / max|plain out|."""
    from controlnet_tpu_torch.ops import cuda_conv, tl_conv

    orig = tl_conv.conv3x3_tl

    def check(weight, bias, x, hw):
        out = orig(weight, bias, x, hw)
        ref = cuda_conv.conv3x3_tl_plain(weight, bias, x, hw)
        scale = max(ref.float().abs().max().item(), 1e-30)
        rel = (out.float() - ref.float()).abs().max().item() / scale
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            rel = float("inf")
        key = (x.shape[0], weight.shape[0], int(hw[0]), int(hw[1]), x.shape[1])
        calls, worst = into.get(key, (0, 0.0))
        into[key] = (calls + 1, max(worst, rel))
        return out

    tl_conv.conv3x3_tl = check
    try:
        yield
    finally:
        tl_conv.conv3x3_tl = orig


def tl_models(config: dict, ckpt: str) -> dict:
    """The MNIST ControlNet from the seeded .pth and the latent one at
    ``config/celebhq.yaml``'s width from phase 10's seeded files, each with
    its batch and hint size."""
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as mnist_tool
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as ldm_tool

    cn_path, _, _ = seeded_ldm_files()
    ldm, _, _ = ldm_tool.load_models(celebhq_config(), cn_path, None)
    return {"mnist": (mnist_tool.load_model(config, ckpt)[0], BATCH, 28),
            "ldm": (ldm, LDM_BATCH, celebhq_config()["dataset_params"]["canny_im_size"])}


def tl_inputs(cn, batch: int, hint_size: int, device):
    """Seeded x_t, t and hint features (the hints binary, as canny maps are)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    hint = (torch.rand((batch, 3, hint_size, hint_size), generator=g, device=device)
            < 0.15).float()
    size = hint_size // (cn.down_sample_factor or 1)
    x = torch.randn((batch, cn.trained_unet.im_channels, size, size), generator=g, device=device)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device)
    with torch.inference_mode():
        feats = cn.hint_features_chunked(hint)
    return x, t, feats


def phase_tl_forwards(width: str, cn, batch: int, hint_size: int, device) -> dict:
    """Phase 42 (ii)-(iii): each forward of TL_LAUNCHES[width] against the
    default forward (the same function by another route) and against itself
    with the plain versions of kernels a and c (the kernels' check), f32 and
    bf16, launches of c, a and d counted from 0 around the call; MNIST's
    UNet.forward_tl against UNet.forward, and a paired call with the fused
    layer on.  A TL forward runs once more with every kernel-c call held
    against the plain version at CONV_TOL (``checked_conv``)."""
    from controlnet_tpu_torch.nn.layers import set_attn_fused_proj

    x, t, feats32 = tl_inputs(cn, batch, hint_size, device)
    res: dict = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
            refs = {"controlnet": cn(xin, t, hint_features=feats),
                    "unet": cn.trained_unet(xin, t)}
            for name, want in TL_LAUNCHES[width].items():
                if name == "forward":
                    continue
                unet = name.startswith("unet_")
                call = ((lambda: cn.trained_unet.forward_tl(xin, t)) if unet else
                        (lambda n=name.replace("_fused_proj", ""):
                         getattr(cn, n)(xin, t, hint_features=feats)))
                set_attn_fused_proj(cn, name.endswith("_fused_proj"))
                try:
                    torch.cuda.synchronize()
                    reset_tl_counts()
                    out = call()
                    torch.cuda.synchronize()
                    got = tl_counts()
                    with plain_attention(), plain_conv(), plain_attention_proj():
                        plain = call()
                finally:
                    set_attn_fused_proj(cn, False)
                conv_ok, conv_check = True, []
                if got[0]:
                    per_shape: dict = {}
                    with checked_conv(per_shape):
                        call()
                    conv_ok = sum(n for n, _ in per_shape.values()) == want[0] and all(
                        r <= CONV_TOL[dtype] for _, r in per_shape.values())
                    conv_check = [dict(shape=list(k), calls=n, rel_err=r)
                                  for k, (n, r) in per_shape.items()]
                    log(f"42 {width} {name} {str(dtype)[6:]}: kernel c against its plain "
                        f"version on each of its {sum(n for n, _ in per_shape.values())} calls, "
                        f"{len(per_shape)} distinct shapes: worst max|err| / max|out| "
                        f"{max(r for _, r in per_shape.values()):.3g} (tol "
                        f"{CONV_TOL[dtype]:g}) -> {'ok' if conv_ok else 'FAIL'}")
                    if not conv_ok:
                        raise SystemExit(f"{width} {name} ({dtype}): kernel c disagrees with "
                                         "its plain version")
                ref = refs["unet" if unet else "controlnet"]
                scale = max(ref.float().abs().max().item(), 1.0)
                err = (out.float() - ref.float()).abs().max().item()
                err_plain = (out.float() - plain.float()).abs().max().item()
                ok = (got == want and out.shape == ref.shape and out.dtype == dtype
                      and bool(torch.isfinite(out).all()) and err <= MODEL_TOL[dtype] * scale
                      and err_plain <= MODEL_TOL[dtype] * scale)
                res[f"{name}_{str(dtype)[6:]}"] = dict(launches_c_a_d=got, max_abs_err=err,
                                                       max_abs_err_plain=err_plain, scale=scale,
                                                       conv_check=conv_check)
                log(f"42 {width} {name} {str(dtype)[6:]}: batch {batch}, launches c/a/d {got} "
                    f"(expect {want}); max abs err vs "
                    f"{'UNet.forward' if unet else 'forward'} {err:.3g}, vs its plain versions "
                    f"{err_plain:.3g} (tol {MODEL_TOL[dtype]:g} x max(1, max|out|) = "
                    f"{MODEL_TOL[dtype] * scale:.3g}) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{width} {name} ({dtype}) disagrees with forward")
    return res


def tl_conv_shapes(cn, batch: int, hint_size: int, device, unet: bool = True) -> dict:
    """(Cin, Cout, H, W, B) of every 3x3 conv the ControlNet's forward_tl
    (and, with ``unet``, its UNet's) asks kernel c for, at ``batch`` in f32."""
    x, t, feats = tl_inputs(cn, batch, hint_size, device)
    shapes: dict = {"forward_tl": [], "unet_forward_tl": []}
    with torch.inference_mode():
        with record_conv_shapes(shapes["forward_tl"]):
            cn.forward_tl(x, t, hint_features=feats)
        if unet:
            with record_conv_shapes(shapes["unet_forward_tl"]):
                cn.trained_unet.forward_tl(x, t)
    return shapes


def phase_tl_timing(width: str, cn, batch: int, hint_size: int, device) -> dict:
    """Phase 42 (v): wall ms per call of the ControlNet forwards of TL_TIMED
    on the host clock, in turns (TL_ROUNDS rounds, every other one
    reversed; TL_TIMED_CALLS calls each a round, ending in a synchronise;
    the median round, and the fastest and slowest), and each one's device
    ms per call from a profiler window of TL_PROFILE_CALLS calls that
    traces the device alone (the union of the window's device records:
    nothing else runs), with the busy share device ms / wall ms (not over
    the profiled call's own time, which the profiler's host work stretches
    by up to 1.4x); f32 and bf16.  Returns the figures by dtype, then
    forward."""
    from torch.profiler import ProfilerActivity, profile

    x, t, feats32 = tl_inputs(cn, batch, hint_size, device)
    out: dict = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
            fns = {name: (lambda n=name: getattr(cn, n)(xin, t, hint_features=feats))
                   for name in TL_TIMED}
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            rounds: dict = {name: [] for name in fns}
            for k in range(TL_ROUNDS):
                for name in TL_TIMED[::-1] if k % 2 else TL_TIMED:
                    start = time.perf_counter()
                    for _ in range(TL_TIMED_CALLS):
                        fns[name]()
                    torch.cuda.synchronize()
                    rounds[name].append((time.perf_counter() - start) * 1e3 / TL_TIMED_CALLS)
            wall = {name: statistics.median(r) for name, r in rounds.items()}
            out[dtype] = {}
            for name, fn in fns.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(TL_PROFILE_CALLS):
                        fn()
                    torch.cuda.synchronize()
                events = device_events(prof)
                if not events:
                    raise SystemExit(f"the profiler recorded no device time for {name}")
                dev = device_span_ms(events) / TL_PROFILE_CALLS
                r = out[dtype][f"{width}_{name}"] = dict(
                    wall_ms=wall[name], wall_ms_min=min(rounds[name]),
                    wall_ms_max=max(rounds[name]), device_ms=dev, busy=dev / wall[name],
                    kernels=len(events) / TL_PROFILE_CALLS)
                log(f"42 {width} {name} {str(dtype)[6:]}, batch {batch}: wall "
                    f"{r['wall_ms']:.3f} ms a call (host clock, the median of {TL_ROUNDS} rounds "
                    f"of {TL_TIMED_CALLS} calls in turns; rounds {r['wall_ms_min']:.3f} to "
                    f"{r['wall_ms_max']:.3f}), device {dev:.3f} ms a call (the union of "
                    f"its records), busy {r['busy']:.3f}, {r['kernels']:.0f} device records "
                    "a call")
    return out


def phase_tl_measured(ckpt: str, device) -> dict:
    """Phase 42's work on the card, in a process of its own (the models
    loaded once): (i) kernel c against its plain version and F.conv2d at
    every conv shape of the MNIST ControlNet's forward_tl, batch 64, and of
    the latent ControlNet's, batch 16, first, as the other timing phases run
    first in theirs; then (ii)-(iii) the forwards at both widths against the
    default one, c against its plain version on every call of a TL forward,
    and (v) the timed forwards.  Returns by dtype the checks, c's figures
    (per_shape included; the latent ones under ``conv_ldm``), the times and,
    under float32, the MNIST conv shapes."""
    models = tl_models(mnist_config(), ckpt)
    shapes = tl_conv_shapes(models["mnist"][0], BATCH, 28, device)
    conv = phase_conv_kernels(shapes["forward_tl"], device, off_path=[],
                              what=f"MNIST ControlNet forward_tl, batch {BATCH}")
    ldm, ldm_batch, ldm_hint = models["ldm"]
    ldm_shapes = tl_conv_shapes(ldm, ldm_batch, ldm_hint, device, unet=False)["forward_tl"]
    conv_ldm = phase_conv_kernels(ldm_shapes, device, off_path=[],
                                  what=f"latent ControlNet forward_tl, batch {ldm_batch}")
    checks, timing = {}, {}
    for width in list(models):
        cn, batch, hint_size = models.pop(width)
        checks[width] = phase_tl_forwards(width, cn, batch, hint_size, device)
        timing[width] = phase_tl_timing(width, cn, batch, hint_size, device)
        del cn
        torch.cuda.empty_cache()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        out[dtype] = dict(
            forwards={w: {k[:-len(name) - 1]: r for k, r in c.items() if k.endswith(name)}
                      for w, c in checks.items()},
            conv=conv[dtype], conv_ldm=conv_ldm[dtype],
            timing={k: v for w in timing for k, v in timing[w][dtype].items()},
            conv_shapes=shapes if dtype == torch.float32 else {})
    return out


def phase_tl(config: dict, ckpt: str, device) -> dict:
    """Phase 42: the forwards' checks (ii-iii), kernel c at the MNIST TL
    shapes (i) and the forwards' times (v) in a fresh process
    (``phase_tl_measured``).  Kernel c's times per forward are summed for
    the ControlNet's 63 calls and for the UNet's 38."""
    start = time.perf_counter()
    measured = in_fresh_process("phase_tl_measured", ckpt)
    f32 = measured[torch.float32]
    unet = collections.Counter(tuple(x) for x in f32["conv_shapes"]["unet_forward_tl"])
    conv_unet = {}
    for dtype, m in measured.items():
        rows = [(unet[tuple(r["shape"])], r) for r in m["conv"]["per_shape"]]
        conv_unet[dtype] = {k: sum(n * r[k] for n, r in rows)
                            for k in ("ms", "own_ms", "plain_ms", "library_ms", "bound_ms",
                                      "flops")}
        log(f"42 conv3x3_tl {str(dtype)[6:]} per MNIST UNet forward_tl ({sum(unet.values())} "
            f"calls), device: kernel {conv_unet[dtype]['ms']:.4f} ms (own launches "
            f"{conv_unet[dtype]['own_ms']:.4f}), plain {conv_unet[dtype]['plain_ms']:.4f} ms, "
            f"F.conv2d {conv_unet[dtype]['library_ms']:.4f} ms, bound "
            f"{conv_unet[dtype]['bound_ms']:.4f} ms, {conv_unet[dtype]['flops'] / 1e9:.2f} GFLOP")
    forwards = {w: {f"{k}_{str(d)[6:]}": r for d, m in measured.items()
                    for k, r in m["forwards"][w].items()} for w in f32["forwards"]}
    return dict(forwards=forwards,
                conv={d: m["conv"] for d, m in measured.items()}, conv_unet=conv_unet,
                conv_ldm={d: m["conv_ldm"] for d, m in measured.items()},
                timing={d: m["timing"] for d, m in measured.items()},
                seconds=round(time.perf_counter() - start, 1))


def tl_summary(res: dict) -> dict:
    keys = ("ms", "own_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flops",
            "max_abs_err", "max_rel_err")
    return {"forwards": res["forwards"],
            "conv_per_mnist_forward_tl": {str(d)[6:]: {k: t[k] for k in keys}
                                          for d, t in res["conv"].items()},
            "conv_per_mnist_unet_forward_tl": {str(d)[6:]: t for d, t in res["conv_unet"].items()},
            "conv_per_latent_forward_tl": {str(d)[6:]: {k: t[k] for k in keys}
                                           for d, t in res["conv_ldm"].items()},
            "timing": {str(d)[6:]: t for d, t in res["timing"].items()},
            "seconds": res["seconds"]}


# --- phase 43: background checkpoint saves -------------------------------------------------

def _tree_diff(a, b, where: str = "") -> list:
    """Where two checkpoint trees differ (structure, types or any value)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [where]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{where}: keys"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{where}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _tree_diff(x, y, f"{where}/{i}")]
    return [] if a == b else [where]


def phase_background_save(device) -> dict:
    """Phase 43: the checkpoint tree ``train_ldm_controlnet`` saves (its train
    state with Adam's two moments, and the frozen split) of config/celebhq.yaml's
    LDM ControlNet at full width, f32, after one seeded step.  The training
    thread's ms inside ``save_checkpoint`` and inside
    ``save_checkpoint_background``, and the seconds until the worker's write
    commits; one in-place Adam update of the live tensors right after the
    background call, after which the file must equal, tensor by tensor, a
    host copy taken before it (the clones are ordered on the stream before
    the update).  The files are deleted afterwards."""
    from controlnet_tpu_torch.io import checkpoint as ckpt

    work = os.path.join(REPO, "build", "smoke", "background_save")
    shutil.rmtree(work, ignore_errors=True)
    modules, states, run = latent_trainer("controlnet", "float32", device)
    cn, state = modules["cn"], states[""]
    g = torch.Generator(device=device).manual_seed(SEED)
    batch = latent_batch("controlnet", g, device)
    run(batch, 0, g, **latent_draws("controlnet", batch, g, device))  # moments nonzero
    _, frozen = cn.split_params()

    def tree() -> dict:  # what train_ldm_controlnet saves each epoch
        return {"state": state.state_dict(), "frozen": {k: p.detach() for k, p in frozen.items()}}

    params = sum(p.numel() for p in cn.parameters())
    torch.cuda.synchronize()
    start = time.perf_counter()
    ckpt.save_checkpoint(work, "blocking.pth", 1, tree())
    blocking_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    before = ckpt._map_tensors(tree(), lambda t: t.detach().cpu().clone())  # a host copy
    live = next(iter(state.params.values()))
    live_before = live.detach().clone()
    torch.cuda.synchronize()
    start = time.perf_counter()
    path = ckpt.save_checkpoint_background(work, "background.pth", 1, tree())
    background_ms = (time.perf_counter() - start) * 1e3
    state.optimizer.step()  # in place, on the live tensors, at once (.grad is last step's)
    update_ms = (time.perf_counter() - start) * 1e3
    ckpt.wait_for_checkpoints()
    commit_s = time.perf_counter() - start
    moved = not torch.equal(live, live_before)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    diffs = _tree_diff(saved, before)
    size = os.path.getsize(path)
    ok = moved and not diffs and bool(before["state"]["opt_state"]["state"])  # moments saved
    del saved, before, live_before
    shutil.rmtree(work)
    log(f"background checkpoint save: LDM ControlNet train state, f32, {params} parameters, "
        f"a {size / 1e9:.3f} GB file: training thread "
        f"{blocking_ms:.1f} ms in save_checkpoint, {background_ms:.1f} ms in "
        f"save_checkpoint_background (then the in-place Adam update issued by "
        f"{update_ms:.1f} ms), the write committed {commit_s:.2f} s after the call; the "
        f"update moved the live weights: {moved}; the file against the host copy taken "
        f"before the update: {'equal, tensor by tensor' if not diffs else diffs[:5]} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("background checkpoint save failed")
    return dict(parameters=params, file_gb=size / 1e9, blocking_ms=blocking_ms,
                background_ms=background_ms, commit_s=commit_s)


# The kernel-timing phases (3, 6, 10, 12, 15, 22, 27, 28, 32, 33 and 42's) and
# the timed distillation, latent-training and conditional sampling main paths
# and the four forwards of phase 42 (19, 25, 34, 42).  Each runs in a
# process of its own (``in_fresh_process``): on the H100 a process that has
# launched millions of kernels since its first profiler window loses device
# records in later windows, often all of a window's own, while a fresh one
# does not.
TIMING_PHASES = ("phase_kernels", "phase_kernels_bwd", "phase_conv_kernels",
                 "phase_proj_kernels", "phase_distill_main_path", "phase_latent_main_path",
                 "phase_cond_sampling", "phase_tl_measured")


# Fresh processes (the timing phases' and the ranks') are forked from a server
# that imported torch once, at the start of the run (``start_fork_server``):
# each is a new process with no CUDA context and no profiler state, as one
# started from the command line, without paying Python's and torch's start-up
# again (~10 s a process on the card's host).
_FORK = multiprocessing.get_context("forkserver")
_FRESH = itertools.count()


def start_fork_server() -> None:
    """Start the fork server now, so that its import of torch overlaps the
    kernel build."""
    _FORK.set_forkserver_preload(["torch"])
    multiprocessing.forkserver.ensure_running()


def _fresh_child(argv: list, env: dict, log_path: str, with_stderr: bool) -> None:
    """A process from the fork server: ``env``, its output into ``log_path``
    (stderr too when ``with_stderr``), then ``main`` on ``argv``."""
    os.environ.update(env)
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    if with_stderr:
        os.dup2(fd, 2)
    os.close(fd)
    sys.argv = [os.path.abspath(__file__), *argv]
    sys.exit(main())


def run_fresh(children: list, timeout: float, with_stderr: bool = False) -> list:
    """Start a fresh process on the card for each (argv, env) of
    ``children``, all at once, and wait for all (killing any still running at
    ``timeout`` seconds); returns each one's (exit code, output lines)."""
    torch.cuda.empty_cache()  # the children allocate their own memory
    work = os.path.join(REPO, "build", "fresh")
    os.makedirs(work, exist_ok=True)
    procs = []
    for argv, env in children:
        path = os.path.join(work, f"{os.getpid()}_{next(_FRESH)}.log")
        proc = _FORK.Process(target=_fresh_child, args=(argv, env, path, with_stderr))
        proc.start()
        procs.append((proc, path))
    deadline = time.monotonic() + timeout
    for proc, _ in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    out = []
    for proc, path in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
        lines = []
        if os.path.exists(path):  # a process that died early may have written nothing
            with open(path) as f:
                lines = f.read().splitlines()
            os.remove(path)
        out.append((proc.exitcode, lines))
    return out


def in_fresh_process(phase: str, *args, **kwargs) -> dict:
    """Run the timing phase ``phase`` (one of TIMING_PHASES) with JSON-able
    ``args`` / ``kwargs`` and ``device`` set to the card, in a new Python
    process on the same card; return its totals by dtype."""
    return in_fresh_processes((phase, args, kwargs))[0]


def in_fresh_processes(*calls) -> list:
    """Run the timing phases ``calls`` ((phase, args, kwargs) each) one after
    another in one new Python process on the same card; pass its log lines
    on and return each phase's totals by dtype, in order.  A failure there
    fails the run."""
    spec = json.dumps([[phase, list(args), kwargs] for phase, args, kwargs in calls])
    [(code, lines)] = run_fresh([(["--timing-phase", spec], {})], 1200)
    for line in lines[:-1]:
        print(line, flush=True)  # the child's lines, with its own clock
    names = [phase for phase, _, _ in calls]
    if code != 0 or not lines:
        raise SystemExit(f"{names} failed in their own process (exit code {code})")
    result = json.loads(lines[-1])
    for key in PROFILER_WINDOWS:
        PROFILER_WINDOWS[key] += result["profiler_windows"][key]
    return [{getattr(torch, name): tot for name, tot in totals.items()}
            for totals in result["totals"]]


def timing_phase(spec: str) -> int:
    """The child side of ``in_fresh_processes``: run the phases, print their
    totals and this process's profiler windows as the last line."""
    out = []
    for phase, args, kwargs in json.loads(spec):
        if phase not in TIMING_PHASES:
            raise SystemExit(f"no timing phase {phase!r}")
        # shape lists come back from JSON as lists of lists; the phases count them
        args = [[tuple(x) for x in a] if isinstance(a, list) and a and isinstance(a[0], list)
                else a for a in args]
        totals = globals()[phase](*args, device=torch.device(DEVICE), **kwargs)
        out.append({str(d)[6:]: tot for d, tot in totals.items()})
    print(json.dumps({"totals": out, "profiler_windows": PROFILER_WINDOWS}), flush=True)
    return 0


# The groups of phases main() runs, in order; ``--phases`` selects some.
PHASE_GROUPS = ("1-4", "5-9", "10-14", "15-16", "17-20", "21-26", "27-31", "32-35", "36-37",
                "38", "39", "40", "41", "42", "43")
ALIASES = {"distill_only": "17-20", "latent_train_only": "21-26", "cifar_only": "27-31",
           "cond_only": "32-35", "compare_only": "36-37", "tl_only": "42"}


def parse_phases(spec: str | None) -> set | None:
    """``--phases``' phase numbers ("38", "1-5,38"), or None for every phase."""
    if spec is None:
        return None
    picked = set()
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        picked.update(range(int(lo), int(hi or lo) + 1))
    if not picked <= set(range(1, 44)):
        raise SystemExit(f"--phases {spec!r}: phases are 1-43")
    return picked


def group_phases(group: str) -> set:
    lo, _, hi = group.partition("-")
    return set(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--verbose-build", action="store_true",
                        help="print nvcc's register and shared-memory report")
    parser.add_argument("--phases", default=None,
                        help="run only these phases, e.g. 38 or 1-5,38 (each group of phases "
                             "that holds one runs whole; 1, the card and the build, always "
                             "runs); the final line is printed when they pass")
    for flag, group in ALIASES.items():
        parser.add_argument("--" + flag.replace("_", "-"), action="store_true",
                            help=f"the same as --phases {group}")
    parser.add_argument("--timing-phase", help=argparse.SUPPRESS)  # set by in_fresh_process
    parser.add_argument("--parallel-rank", help=argparse.SUPPRESS)  # set by run_ranks
    args = parser.parse_args()
    picked = parse_phases(args.phases)
    for flag, group in ALIASES.items():
        if getattr(args, flag):
            picked = (picked or set()) | group_phases(group)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from controlnet_tpu_torch.ops import _build, cuda_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.timing_phase:
        _build.load()
        return timing_phase(args.timing_phase)
    if args.parallel_rank:
        _build.load()
        return parallel_rank(args.parallel_rank)
    device = torch.device(DEVICE)
    start_fork_server()
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    start = time.perf_counter()
    _build.build(verbose=args.verbose_build)
    _build.load()
    log(f"kernel build: {time.perf_counter() - start:.2f} s ({_build.LIB_PATH.name} from "
        f"{', '.join(p.name for p in _build.sources())})")
    sass_job = start_sass(str(_build.LIB_PATH), _build._nvcc())

    config = mnist_config()
    ckpt = os.path.join(REPO, "build", "smoke", f"mnist_controlnet_seed{SEED}.pth")
    write_seeded_checkpoint(config, ckpt)
    from controlnet_tpu_torch.data.datasets import to_unit
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    def want(group: str) -> bool:
        return picked is None or bool(picked & group_phases(group))

    full = all(want(g) for g in PHASE_GROUPS)
    seconds: dict = {"build": time.perf_counter() - start}  # wall time by group of phases
    mark = time.perf_counter()

    def done(group: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        seconds[group] = round(now - mark, 1)
        mark = now

    # A group's timing phases share another group's fresh process where both
    # groups run: phase 3's with 6's, 15's with 10 and 12's, 19's timed part
    # with 22 and 25's.  Not 42's: after phase 34's profiler windows in one
    # process, its time_calls of kernel c lost a record in every window.
    if want("1-4"):
        cn, _ = tool.load_model(config, ckpt)
        shapes = phase_forward(cn, device)
        fused_launches = phase_mnist_fused_forward(cn, device)
        del cn
        if not want("5-9"):
            kern = in_fresh_process("phase_kernels", shapes)
        main_path = phase_main_path(config, ckpt, device)
        done("1-4")

    if want("5-9"):
        base = seeded_unet_state_dict(config)
        images = torch.from_numpy(to_unit(seeded_digits(8 * BATCH)))[:, None].to(device)
        bwd_shapes = phase_train_shapes(config, base, images, device)
        if want("1-4"):
            kern, kern_bwd = in_fresh_processes(("phase_kernels", (shapes,), {}),
                                                ("phase_kernels_bwd", (bwd_shapes,), {}))
        else:
            kern_bwd = in_fresh_process("phase_kernels_bwd", bwd_shapes)
        for dtype in (torch.float32, torch.bfloat16):
            phase_train_parity(config, base, images, device, dtype)
        train = phase_train_main_path(config, base, images, device)
        phase_tools(config, device)
        del images
        torch.cuda.empty_cache()
        done("5-9")
    mnist_proj = (
        ("phase_proj_kernels", (MNIST_PROJ_SHAPES, SERVE_BATCH), dict(what="MNIST forward")),
        ("phase_proj_kernels", (MNIST_PROJ_SHAPES, BATCH), dict(what="MNIST forward")))
    if want("10-14"):
        ldm = phase_ldm(device, mnist_proj if want("15-16") else ())
        done("10-14")
    served = None
    if want("15-16"):
        proj16, proj64 = ldm["extra"] if want("10-14") else in_fresh_processes(*mnist_proj)
        served = phase_serve(config, ckpt, device)
        done("15-16")

    if want("17-20"):
        students, parity, distill_main, distill_tools, served_students = run_distill_phases(
            config, ckpt, device, None if served is None else served["steps4"]["latency_ms"],
            timed=not want("21-26"))
        done("17-20")
    if want("21-26"):
        latent = run_latent_train_phases(
            device, (("phase_distill_main_path", (ckpt,), {}),) if want("17-20") else ())
        if want("17-20"):
            [distill_main] = latent["extra"]
        done("21-26")
    if want("27-31"):
        cifar = run_cifar_phases(device)
        done("27-31")
    if want("32-35"):
        cond = run_cond_phases(device)
        done("32-35")
    if want("36-37"):
        compared = run_compare_phases(config, ckpt, device)
        done("36-37")
    if want("38"):
        parallel = phase_parallel(config, ckpt, device)
        done("38")
    if want("39"):
        latent_dp = phase_latent_tools_dp(device)
        done("39")
    if want("40"):
        replicas = phase_serve_replicas(config, ckpt, device)
        done("40")
    if want("41"):
        tensor_parallel = phase_tp(config, device)
        done("41")
    if want("42"):
        tl = phase_tl(config, ckpt, device)
        done("42")
    if want("43"):
        background_save = phase_background_save(device)
        done("43")
    sass = phase_sass(sass_job)  # phase 1's SASS count, overlapped with the phases
    log(json.dumps({"phase_seconds": seconds}))

    if not full:  # a selection: the summaries of what ran, then the final line
        if want("17-20"):
            log(json.dumps({"distill": {"parity": parity, "sample": distill_tools}},
                           default=str))
        for group, key, summary in (("21-26", "latent_train", lambda: latent_train_summary(latent)),
                                    ("27-31", "cifar", lambda: cifar_summary(cifar)),
                                    ("32-35", "cond", lambda: cond_summary(cond)),
                                    ("36-37", "compare", lambda: compare_summary(compared)),
                                    ("38", "parallel", lambda: parallel),
                                    ("39", "latent_dp", lambda: latent_dp),
                                    ("40", "serve_replicas", lambda: replicas),
                                    ("41", "tensor_parallel", lambda: tensor_parallel),
                                    ("42", "tl", lambda: tl_summary(tl)),
                                    ("43", "background_save", lambda: background_save)):
            if want(group):
                log(json.dumps({key: summary()}))
        log(f"time_calls: {PROFILER_WINDOWS}")
        print(f"{smi}; phases {args.phases or ''} {sorted(a for a in ALIASES if getattr(args, a))} "
              f"passed (a partial run: no kernels line)", flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0

    def kernel_entry(name, source, replaces, tots, launches, bf16_launches, per):
        f32, bf16 = tots[torch.float32], tots[torch.bfloat16]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            # per ControlNet forward (kernel a) or training step (kernel b): every
            # call at its main-path shape, f32; device time (time_calls)
            "per": per,
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "bf16": {"ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
                     "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
                     "library_ms": bf16["library_ms"], "max_abs_err": bf16["max_abs_err"],
                     "launches": bf16_launches},
        }

    fwd_entry = kernel_entry("attention_fwd_t", "controlnet_tpu_torch/csrc/attention_fwd.cu",
                             "controlnet_tpu/ops/pallas_attention.py:36", kern,
                             main_path["float32"]["launches"],
                             main_path["bfloat16"]["launches"], "forward (26 calls)")
    fwd_entry["train_launches"] = train["float32"]["launches"]
    # the latent main path: launches of each run, and the per-forward times at
    # the latent shapes (22 calls, B*H = 256)
    fwd_entry["ldm_launches"] = {f"{mode}_{name}": r["attn_launches"]
                                 for (mode, name), r in ldm["runs"].items()}
    ldm_fwd = kernel_entry("attention_fwd_t", "", "", ldm["attn"],
                           ldm["runs"][("ancestral", "float32")]["attn_launches"],
                           ldm["runs"][("ancestral", "bfloat16")]["attn_launches"],
                           "latent forward (22 calls)")
    fwd_entry["ldm"] = {k: ldm_fwd[k] for k in ("per", "launches", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err", "bf16")}
    bwd_entry = kernel_entry("attention_bwd_t", "controlnet_tpu_torch/csrc/attention_bwd.cu",
                             "controlnet_tpu/ops/pallas_attention.py:100", kern_bwd,
                             train["float32"]["bwd_launches"],
                             train["bfloat16"]["bwd_launches"], "training step (18 calls)")
    bwd_entry["max_rel_err"] = kern_bwd[torch.float32]["max_rel_err"]
    bwd_entry["lse_max_abs_err"] = max(t["lse_err"] for t in kern_bwd.values())
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tot = kern_bwd[dtype]
        bwd_entry[f"d_err_{key}"] = tot["d_err"]
        bwd_entry[f"d_err_from_o_{key}"] = tot["d_err_from_o"]
        bwd_entry[f"sdpa_backends_{key}"] = tot["sdpa_backends"]
    bwd_entry["bf16"]["max_rel_err"] = kern_bwd[torch.bfloat16]["max_rel_err"]
    bwd_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/attention_bwd_bf16.cu"
    fwd_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/attention_fwd_bf16.cu"
    conv_entry = kernel_entry("conv3x3_tl_f32_kernel", "controlnet_tpu_torch/csrc/conv3x3_tl.cu",
                              "controlnet_tpu/ops/pallas_conv.py:44", ldm["conv"],
                              ldm["runs"][("ancestral", "float32")]["conv_launches"],
                              ldm["runs"][("ancestral", "bfloat16")]["conv_launches"],
                              "hint encode (7 calls)")
    conv_entry["max_rel_err"] = ldm["conv"][torch.float32]["max_rel_err"]
    conv_entry["bf16"]["max_rel_err"] = ldm["conv"][torch.bfloat16]["max_rel_err"]
    conv_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/conv3x3_tl_bf16.cuh"
    # the planner's kernel for images 64 wide and wider (most of a hint encode)
    conv_entry["bf16"]["wide_source"] = "controlnet_tpu_torch/csrc/conv3x3_tl_bf16_mma.cu"
    conv_entry["own_ms"] = ldm["conv"][torch.float32]["own_ms"]
    conv_entry["bf16"]["own_ms"] = ldm["conv"][torch.bfloat16]["own_ms"]
    conv_entry["ldm_launches"] = {f"{mode}_{name}": r["conv_launches"]
                                  for (mode, name), r in ldm["runs"].items()}
    fwd_entry["serve_launches"] = served["launches_a"]
    # kernel d: launches of the served requests (24 per model call); times per
    # MNIST forward at the server's largest bucket, then at batch 64 and per
    # latent forward at batch 16, each beside the split path's time
    proj_entry = kernel_entry("attention_proj", "controlnet_tpu_torch/csrc/attention_proj.cu",
                              "controlnet_tpu/ops/pallas_attention.py:358", proj16,
                              served["launches_d"], None,
                              f"MNIST forward at batch {SERVE_BATCH} (24 calls)")
    keys = ("ms", "plain_ms", "split_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "max_rel_err")
    proj_entry["split_ms"] = proj16[torch.float32]["split_ms"]
    proj_entry["max_rel_err"] = proj16[torch.float32]["max_rel_err"]
    proj_entry["bf16"] = {k: proj16[torch.bfloat16][k] for k in keys}
    # no served run computes in bf16; these are the counts of the one fused
    # MNIST forward of each dtype at batch 64, read from the counter around it
    proj_entry["fused_forward_launches"] = fused_launches
    for name, tots in ((f"batch{BATCH}", proj64), ("ldm", ldm["proj"])):
        proj_entry[name] = {str(dtype)[6:]: {k: tots[dtype][k] for k in keys}
                            for dtype in (torch.float32, torch.bfloat16)}
    # config/cifar.yaml (phases 27 and 30): d's times per CIFAR forward at
    # batch 64 (24 calls at its six shapes), its launches in the batch-64
    # forward and the 10-step sample with the switch, and the shapes past head
    # dim 64 held against the plain version off the model paths
    proj_entry["cifar"] = {"shapes": CIFAR_PROJ_SHAPES, **{
        str(dtype)[6:]: {k: cifar["proj"][dtype][k] for k in keys}
        for dtype in (torch.float32, torch.bfloat16)}}
    proj_entry["cifar_launches"] = {
        **{f"forward_{n}": d for n, d in cifar["fused"].items()},
        "sample_float32": cifar["fused_sampling"]["on"]["launches_d"]}
    proj_entry["wide_shapes"] = cifar["wide"]
    proj_entry["bf16_edge_shapes"] = cifar["edges"]
    proj_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/attention_proj_bf16.cu"
    proj_entry["served"] = {k: served[k] for k in (
        *(f"steps{n}" for n in SERVE_STEPS), "on_ms", "off_ms", "ddim_ms", "batched",
        "unbatched", "profile_on", "profile_off")}
    for entry, kernel in ((fwd_entry, "a"), (bwd_entry, "b"), (conv_entry, "c"),
                          (proj_entry, "d")):
        entry["sass"] = {k: v for k, v in sass.items() if k.startswith(kernel + " ")}
    fwd_entry["sdpa_backends"] = {str(d)[6:]: kern[d]["sdpa_backends"] for d in kern}
    # the distillation main path (phase 19): launches of each timed run of
    # TRAIN_STEPS steps, then of the served students (phase 20)
    for entry, key in ((fwd_entry, "launches"), (bwd_entry, "bwd_launches")):
        entry["distill_launches"] = {f"{kind}_{str(dtype)[6:]}": runs[kind][key]
                                     for dtype, runs in distill_main.items() for kind in runs}
    fwd_entry["distill_launches"].update(
        {f"serve_{m}": served_students[m]["launches"] for m in served_students})
    distill = {
        "student_forwards": students,
        "parity": parity,
        "main_path": {f"{kind}_{str(dtype)[6:]}": r for dtype, runs in distill_main.items()
                      for kind, r in runs.items()},
        "sample": {k: distill_tools[k] for k in ("consistency_1step", "consistency_4step",
                                                 "dmd_1step", "tools_s")},
        "serve": served_students,
        "serve_dpm_controlnet_4step_ms": served["steps4"]["latency_ms"],
    }
    log(json.dumps({"distill": distill}))
    # the latent-training main path (phase 25): launches of each timed run of
    # TRAIN_STEPS steps; kernel b's times per latent training step (phase 22)
    # and kernel c's gradients under autograd (phase 23)
    for entry, i in ((fwd_entry, 0), (bwd_entry, 1), (conv_entry, 2)):
        entry["latent_train_launches"] = {
            f"{kind}_{str(dtype)[6:]}": runs[kind]["launches"][i]
            for dtype, runs in latent["main_path"].items() for kind in runs}
    lat_b = kernel_entry("attention_bwd_t", "", "", latent["bwd"], None, None,
                         "latent training step (14 calls)")
    bwd_entry["latent_train"] = {k: lat_b[k] for k in ("per", "ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms", "max_abs_err",
                                                       "bf16")}
    bwd_entry["latent_train"]["max_rel_err"] = latent["bwd"][torch.float32]["max_rel_err"]
    bwd_entry["latent_train"]["bf16"]["max_rel_err"] = latent["bwd"][torch.bfloat16]["max_rel_err"]
    conv_entry["latent_train_autograd"] = latent["conv_grad"]
    log(json.dumps({"latent_train": latent_train_summary(latent)}))
    # CIFAR-10 (phases 27-31): launches of each timed run (10 training steps,
    # the 50-step sample), and a's times per CIFAR forward (26 calls), b's per
    # CIFAR training step (18 calls)
    for entry, key in ((fwd_entry, "launches"), (bwd_entry, "bwd_launches")):
        entry["cifar_launches"] = {f"train_{n}": r[key] for n, r in cifar["train"].items()}
    fwd_entry["cifar_launches"].update(
        {f"sample_{n}": r["launches"] for n, r in cifar["sampling"].items()})
    keys = ("per", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "bf16")
    cifar_a = kernel_entry("attention_fwd_t", "", "", cifar["fwd"], None, None,
                           "CIFAR forward (26 calls)")
    cifar_b = kernel_entry("attention_bwd_t", "", "", cifar["bwd"], None, None,
                           "CIFAR training step (18 calls)")
    fwd_entry["cifar"] = {k: cifar_a[k] for k in keys}
    bwd_entry["cifar"] = {k: cifar_b[k] for k in keys}
    bwd_entry["cifar"]["max_rel_err"] = cifar["bwd"][torch.float32]["max_rel_err"]
    bwd_entry["cifar"]["bf16"]["max_rel_err"] = cifar["bwd"][torch.bfloat16]["max_rel_err"]
    log(json.dumps({"cifar": cifar_summary(cifar)}))
    # the conditional UNet (phases 32-35): launches of each timed run (the
    # 20-step guided DPM sample, the 50-step class-conditioned MNIST sample),
    # and a's times per conditional LDM forward, b's per gradient, at the 14
    # cross-attention calls (Lk 77)
    cond_a = kernel_entry("attention_fwd_t", "", "", cond["fwd"], None, None,
                          "conditional LDM forward, its 14 cross-attention calls")
    cond_b = kernel_entry("attention_bwd_t", "", "", cond["bwd"], None, None,
                          "conditional LDM gradient, its 14 cross-attention calls")
    fwd_entry["cond"] = {k: cond_a[k] for k in keys}
    bwd_entry["cond"] = {k: cond_b[k] for k in keys}
    bwd_entry["cond"]["max_rel_err"] = cond["bwd"][torch.float32]["max_rel_err"]
    bwd_entry["cond"]["bf16"]["max_rel_err"] = cond["bwd"][torch.bfloat16]["max_rel_err"]
    fwd_entry["cond_launches"] = {
        **{f"ldm_sample_{str(d)[6:]}": r["launches"] for d, r in cond["sampling"].items()},
        **{f"mnist_class_sample_{n}": r["launches"] for n, r in cond["mnist"]["runs"].items()},
        **{f"ldm_grad_{n}": r["launches"][0] for n, r in cond["grad"].items()}}
    bwd_entry["cond_launches"] = {f"ldm_grad_{n}": r["launches"][1]
                                  for n, r in cond["grad"].items()}
    log(json.dumps({"cond": cond_summary(cond)}))
    # the comparison tools (phase 36): kernel a's launches in each tool's run
    # (26 x 50 x 2 per DDPM run, 16 x 2 per student)
    fwd_entry["compare_launches"] = {k: r["launches"]
                                     for k, r in compared["compare"]["runs"].items()}
    log(json.dumps({"compare": compare_summary(compared)}))
    log(json.dumps({"parallel": parallel}))
    # phases 39-41: launches per rank of a / b / c in the latent tools at two
    # ranks, of a in the served requests at two replicas, and of a / b (c) per
    # rank under tensor parallelism
    for entry, i in ((fwd_entry, 0), (bwd_entry, 1), (conv_entry, 2)):
        entry["latent_tools_dp_launches"] = {
            k: [x[i] for x in latent_dp[k]["launches_per_rank"]]
            for k in ("train_vae", "train_ldm_vae", "sample_ldm_vae", "sample_ldm_controlnet")}
        entry["tp_launches"] = {"ldm_controlnet_1x2": [x[i] for x in tensor_parallel["ldm"][
            "launches_per_rank"]]}
        if i < 2:
            entry["tp_launches"].update({
                f"mnist_controlnet_2x2_{n}": [x[i] for x in r["launches_per_rank"]]
                for n, r in tensor_parallel["cn"].items()})
    fwd_entry["serve_replicas_launches"] = {
        f"{m}_rows{rows}": replicas[m][f"rows{rows}"]["launches_a"][0]
        for m in ("dpm_controlnet", "consistency") for rows in (SERVE_BATCH, 1)}
    log(json.dumps({"latent_dp": latent_dp}))
    log(json.dumps({"serve_replicas": replicas}))
    log(json.dumps({"tensor_parallel": tensor_parallel}, default=str))
    # phase 42: launches of c, a and d per call of the TL, paired and fused
    # forwards (f32 and bf16), and kernel c's times per MNIST TL forward at
    # batch 64 (63 calls a ControlNet, 38 a UNet)
    tl_runs = {(w, k): r["launches_c_a_d"] for w, runs in tl["forwards"].items()
               for k, r in runs.items()}

    def tl_launches(i: int, *names: str) -> dict:
        return {f"{w}_{k}": n[i] for (w, k), n in tl_runs.items()
                if any(name in k for name in names)}

    conv_entry["tl_launches"] = tl_launches(0, "forward_tl")
    fwd_entry["tl_launches"] = tl_launches(1, "forward_tl")
    fwd_entry["paired_launches"] = tl_launches(1, "forward_paired")
    fwd_entry["fused_launches"] = tl_launches(1, "forward_fused")
    proj_entry["paired_launches"] = tl_launches(2, "forward_paired")
    proj_entry["fused_launches"] = tl_launches(2, "forward_fused")
    tl_c = kernel_entry("conv3x3_tl", "", "", tl["conv"], None, None,
                        f"MNIST ControlNet forward_tl at batch {BATCH} (63 calls)")
    conv_entry["tl"] = {k: tl_c[k] for k in keys}
    conv_entry["tl"]["unet_forward_tl"] = {str(d)[6:]: t for d, t in tl["conv_unet"].items()}
    tl_ldm = kernel_entry("conv3x3_tl", "", "", tl["conv_ldm"], None, None,
                          f"latent ControlNet forward_tl at batch {LDM_BATCH} (51 calls)")
    conv_entry["tl_ldm"] = {k: tl_ldm[k] for k in keys}
    log(json.dumps({"tl": tl_summary(tl)}))
    log(f"time_calls: {PROFILER_WINDOWS['windows']} profiler windows for "
        f"{PROFILER_WINDOWS['measurements']} measurements in {PROFILER_WINDOWS['groups']} "
        f"groups (2 windows a group when no window lost records), "
        f"{PROFILER_WINDOWS['foreign']} device records left out as launched outside a window, "
        f"{PROFILER_WINDOWS['seconds']:.1f} s in all")
    log(json.dumps({"background_save": background_save}))
    log(json.dumps({"kernels": [fwd_entry, bwd_entry, conv_entry, proj_entry]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
