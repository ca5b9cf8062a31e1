#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lipreading_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``lipreading_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together, then one link; cached by a hash of
   the sources), print the build seconds, each kernel's registers and
   spills (the Hopper flash and the CTC lattice kernels must not spill, and
   those that trade registers with ``setmaxnreg`` must be built for its
   pool), how many ``HGMMA`` and ``UTMALDG`` instructions the library holds
   (both > 0) and how many ``LDGSTS`` (asynchronous copies) each CTC
   lattice kernel holds (> 0 in each);
2. print the card's name and power limit as ``nvidia-smi`` reports them;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time the kernel (CUDA events around
   its bare C entry: the device time), the plain version and one PyTorch
   yardstick beside it (by ``torch.profiler`` device time). ``[ctc]``:
   both lattice kernels at the training path's shape (B 8, T 128, S 81),
   the long-clip fine-tuning shape (B 4, T 1024, S 513) and S 121, 601,
   1025 and 2049, whose skip transitions cross lane and warp boundaries;
   two launches must give the same bytes, a planted fault (one skip flag
   cleared) must break the limits the kernels meet; the kernels'
   branch-free log1p must equal log1pf on every float in [0, 1]; each
   kernel's device time beside its bounds: bytes, operations and the chain
   of dependent steps (``ctc_chain_probe``), ``F.ctc_loss``'s device
   time, and the kernels' device time under every K they are built for
   (the same bytes as ``lattice_plan``'s choice);
4. drive the serving path: fixture clips at 160x160 -> ``preprocess_clips``
   -> the released ``transformer_hybrid_universal4`` model at full width ->
   ``greedy_conf`` -> transcripts, with every kernel's launch count set to 0
   just before and read just after; the transcripts must equal those of the
   same run on the CPU (plain versions there);
5. drive the training path: ``FusedTrainer`` warm-started from the release,
   full width and depth, with the release's dropout and ROI jitter, on a
   fixture corpus at batch 8: a few steps with finite losses, one launch
   of the ROI and of each CTC lattice kernel and two of ``conv3d_dgrad``
   (the patchify stem's convA and convB) per step (counts set to 0 just
   before, read just after), the time of each stage of a step, then
   steps on one fixed batch whose loss must fall, and a checkpoint saved and
   reloaded with equal parameters; ``[train-avsr]``: the Auto-AVSR model
   (ResNet-18 trunk, 12 Conformer blocks at d 768, 5,002 outputs) from the
   seed through ``Trainer.train_step`` at B 8 x T 128: finite losses and
   13 launches of ``conv3d_dgrad`` a step (the trunk's stride-1 3x3
   convolutions), the step's time and the peak memory;
6. one step without dropout or jitter on 2 clips on the card and on the CPU
   (plain versions there): loss, gradients and updated parameters agree
   within limits that a planted fault on the card must break;
7. print the kernels' JSON line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Flash attention (``model.flash_attention=1``) adds three phases:

* ``[flash]``: the forward (with and without lse), the fused backward and
  the two-pass pair against their plain versions at the path's shape
  (B 4, T 1024, H 4, Dh 64, ragged lengths with a 0), at T 8192 and at a
  ragged B 3, T 200, H 2, Dh 100 (lengths 200, 1, 0; not timed), in bf16
  and float32, within limits that a planted fault (each key mask one short)
  must break; two launches of the two-pass pair giving the same bytes;
  each kernel's own device time (CUDA events around its bare C entry), its
  TFLOP/s and share of the bound, the wrapper's time, the plain version's
  and SDPA's device time (its kernels' sum in ``torch.profiler``, the
  backward's kernels apart) beside them; the ``auto`` policy's readings
  (forward + backward under xla, fused and pallas);
* ``[path-flash]``: the release with flash on transcribes the short clips of
  ``[path]`` and 4 long clips (about 1000 frames, padded to 1024, rendered
  in worker processes meanwhile), with one forward launch per encoder layer;
  the transcripts must equal the CPU's (the long clips from the card's
  ROIs); flash off beside it, reported;
* ``[train-flash]``: fine-tuning on the long clips under each backward
  policy with the launches of each step counted (they are the flash rows'
  ``launches``; one launch of each CTC lattice kernel a step is checked
  too), one float32 step's gradient of pallas and fused against
  xla within limits that a planted fault must break, a fixed batch whose
  loss falls, and peak memory with flash on and off.

``[conv-dgrad]`` holds the stride-1 convolutions' data-gradient kernel
(``models/nn.conv3d_dgrad``, ``csrc/conv3d_dgrad.cu``) against its plain
version at odd shapes, at the four stem shapes of the release training
cells (B 64 x T 96: conv1 24x24 3x5x5 32 <- 64, conv2 12x12 3x3x3 64 <-
96, convA 6x6 and convB 3x3 3x3x3 256 <- 256) and at the ResNet-18
trunk's four (B 32 x T 256, 1x3x3: 22x22 64 <- 64, 11x11 128 <- 128, 6x6
256 <- 256, 3x3 512 <- 512), within a limit that a planted
fault (the weight left unflipped) must break, two launches the same
bytes; times the kernel (CUDA events around its bare C entry), the
wrapper, the plain version and cuDNN's dgrad on the layouts the old path
handed it (CUDA events; torch.profiler names cuDNN's kernel) beside the
bf16 FLOP bound, and cuDNN's data gradient in three other forms (a forward
convolution of dY with the flipped weight; its backward on operands all
channels_last_3d or all NCDHW); and holds ``nn.conv3d``'s forward and
weight gradient to the old path's bytes, with the routing counter and the
launches.

``[cascade]`` drives cascade decoding as the JAX server decodes (beam 8,
char-LM weight 0.4): the short clips of ``[path]`` through
``preprocess_clips`` and ``transcribe_cascade`` at the default margins and
at ``margin=inf`` (every clip through the joint beam), and ``transcribe``
with and without the lexicon; every transcript and the default run's flags
must equal the same calls on the CPU, and the cascade the full beam. The
long clips of ``[path-flash]`` (flash on, T 1024) go through the joint beam
at ``margin=inf``; from one encoder output (the card's) the beam must give
the same transcripts on the card and the CPU, and the CPU's own run from
the card's ROIs is printed beside them (its bf16 encoder rounds apart from
the card's, and a near tie may resolve either way). Around each call the
counts are set to 0 and read: one ROI launch per
``preprocess_clips``, one greedy launch per cascade call, no CTC lattice
launch, and with flash one forward launch per encoder layer (the rescore
leg decodes from the greedy leg's encoder output). It prints the greedy
and rescore legs' times, the beam steps before the early exit and the ms
per step, padded frames/s, and each clip's best minus second-best score.

The default serving deployment (``scripts/serve.py``'s defaults: tracked
preprocessing with the conv landmarker, the cascade) adds three phases:

* ``[tracked]``: the serving clips plus ``make_clip(61)`` with frames 4-6
  blanked and ``make_clip(62)`` with a second face (10 clips x 96 frames)
  through ``preprocess_clips_tracked`` on the card and on the CPU: ``valid``
  equal, the face boxes, landmarks and ROIs within limits that a planted
  fault (the card's frames shifted one pixel) must break; the cutaway's
  frames invalid with frame 3's box and the second face never taking the
  track (the JAX robustness tests' properties); kernel 1 at the face-crop
  shape (N 960, R 64, integer boxes, ``normalize=0``) against its plain
  version, timed as in ``[roi]``; 2 ROI launches a tracked call and 1
  greedy launch a cascade call; each stage's host ms and the tracking
  loop's device ops;
* ``[segmented]``: a cutaway video and a hard cut through
  ``preprocess_padded_tracked`` and ``transcribe_segmented(cascade=True)``:
  2 segments each, spans and transcripts equal on the card and the CPU;
* ``[serve]``: ``serve()`` of ``python -m lipreading_tpu_torch.serve`` on 64
  rendered fixture clips (B 16, bucket 96, beam 8, LM 0.4) with the launch
  counts set to 0 before and read after: its JSON report, each steady
  batch's stage split, every result present, ``0 <= rescored_frac <= 1``,
  the ring's processes gone; on one steady batch's own inputs, kernel 1
  (face crop N 1536 R 64, normalize=0; sub-pixel mouth ROIs N 1536 R 96)
  and kernel 2 (B 16 x T 96) against their plain versions and timed; a
  profile of that batch (device busy ms and idle share); the first 4
  clips' transcripts equal the CPU's.

The rest of training (the dataview trainer, the tracked fused trainer,
remat and the evaluation entry) adds five phases, on the release at full
width and depth (batch 8, buckets 32-128):

* ``[dataview]``: the training corpus's fixture dataview (12 clips) built
  on the card untracked with the ERT and tracked with the conv landmarker
  (faceless frames kept, masked): build seconds and ROI launches (1 a clip,
  2 with the conv landmarker); the first 4 clips built on the CPU too: the
  index and the masks equal, the stored bytes equal or, by 1, where the
  value sits within the ROI limit of a rounding boundary; the held-out
  view (4 clips of the training entry's held-out seed);
* ``[train-dataview]``: ``Trainer`` from that view, warm-started:
  ``batch_to_device``'s normalised ROIs card equal to CPU (PyTorch's own
  scalar division, the planted fault, is not); the
  held-out evaluation (joint beam 8) at step 0 card equal to CPU, then
  ``fit`` with an evaluation at its last step: losses, one launch of each
  CTC kernel a step and none of the ROI or greedy kernel, ``eval_cer``,
  ``eval_wer`` and the eval ms, each stage's ms;
* ``[train-tracked]``: ``FusedTrainer(tracked=True)`` with the conv
  landmarker and the presence head on batches whose first sample is
  faceless: 2 ROI launches and one of each CTC kernel a step, stage ms;
  the faceless sample's weight 0 and the loss bit-identical across two
  faceless backgrounds; kernel 1 at the step's face-crop and mouth shapes
  (N 1024) against its plain version and timed; one dropout-off step card
  against CPU within limits a planted fault (a length one short) breaks;
  the tracked evaluation's transcripts card equal to CPU;
* ``[remat]``: ``[train-flash]``'s long batch (4 x 1024, flash on,
  ``flash_bwd=pallas``), one generator: the loss with ``train.remat`` equal
  to the loss without, the gradient within limits that a recompute which
  reseeds the generator breaks; peak memory and step ms both ways;
* ``[evaluate]``: ``python -m lipreading_tpu_torch.evaluate`` in-process
  on the JAX script's 6 held-out clips from the release,
  ``decode=cascade`` and ``decode=ctc beam=1``: CER, launches (one ROI
  launch a clip; one greedy launch for the cascade's batch, one a clip for
  the CTC head) and the transcripts card equal to CPU.

The bi-GRU family and the conv3d stem (the ``bigru_ctc`` and
``transformer_hybrid_universal`` releases at full width and depth) add
four phases:

* ``[bigru]``: ``bigru_ctc`` on ``[path]``'s 8 clips (bucket 96, untracked
  ERT): greedy transcripts card equal to CPU with one ROI and one greedy
  launch a call; the cascade (beam 8, LM 0.4) at the default margins and
  at ``margin=inf`` card equal to CPU, one greedy launch a call; the
  encoder output card against CPU from the card's ROIs within a limit a
  planted fault (the backward direction reversed over the padded T with
  ``torch.flip``) breaks; CER, the host ms of the stem, the recurrence and
  head + greedy, one recurrence's device ops and busy ms
  (``torch.profiler``), peak memory;
* ``[conv3d]``: ``transformer_hybrid_universal`` on the same clips at
  buckets 96 and 128: greedy and cascade transcripts card equal to CPU
  with launches counted; the stem's output within a limit a symmetric pad
  of the 5x5 stride-2 convolution breaks; the stem's ms beside the patchify
  stem's;
* ``[serve-bigru]``: ``serve_batch`` on one steady batch of 16 rendered
  clips with ``release=bigru_ctc`` and the tracked conv preprocessing:
  every result present, 2 ROI launches, the stage split, the first 4
  clips equal to the CPU's;
* ``[train-bigru]``: ``FusedTrainer`` from ``bigru_ctc`` (batch 8, buckets
  32-128, the release's training config): finite losses, one ROI, one
  launch of each CTC kernel and two of ``conv3d_dgrad`` (the conv3d stem's
  conv1 and conv2) a step, the stages; a fixed batch's loss falls
  from the seeded initialisation; a bf16 step card against CPU within
  ``[parity]``'s kind of limits that a length one short breaks; a float32
  ``decoder=hybrid`` model (the Bahdanau decoder): its teacher-forced
  logits card against CPU within a limit that the attention mask off
  breaks, then one step; one step at ``teacher_forcing=0.5``.

Streaming and the demo add two phases:

* ``[stream]``: the ``greedy`` (untracked, beam 1) and ``quality``
  (tracked with ``cut_flush``, beam 4, LM 0.4) configs of ``python -m
  lipreading_tpu_torch.stream_latency`` on universal4 over
  make_clip(33001-33003) in chunks of 8 (robust assets): a warm pass, then
  a timed pass with the counts set to 0 before and read after (one ROI
  launch a chunk, one more a re-acquire at a hard cut, no other kernel);
  the same stream on the CPU, whose transcript after every feed and at
  the end must equal the card's unless the streams part at an argmax
  flip under ``NEAR_TIE_NATS`` (the frame and both margins printed); the
  argmax, the prefix beam and the Viterbi path from the card's own
  log-probs card == CPU; rtf, chunk ms p50 / p95 / max, finish ms, CER,
  the commits, Viterbi and beam-tail calls, and one decode-bearing chunk
  under ``torch.profiler`` (device busy ms, idle share). The pinned styled
  stream of ``test_styled_stream_ladder_pin`` (33001 and 33002 at
  variation 0.6, the quality config, window 64) must read CER 0 with a cut
  event. ``ctc_viterbi_align`` card vs CPU at a window's shape (1 x 64 x
  31) and on a seeded ragged batch: equal paths that collapse to their
  labels; a planted fault (the skip allowed between repeated labels) must
  break the gate;
* ``[demo]``: ``python -m lipreading_tpu_torch.demo`` in-process on
  fixture clip 3 (bigru_ctc, beam 8), the untracked batch mode and
  ``stream=16``: the printed transcripts card equal to CPU; launches, and
  the stream's Viterbi alignments on the card.

Preprocessor training adds one phase, ``[preproc-train]``, at the models'
full widths (the detector 1->8->16->32->4, the conv landmarker at width 1.0,
16->96 channels and a dense layer of 256; batch 64, the presence head full
batch), on clips rendered in the worker processes meanwhile: the first 3
steps of ``train_detector`` (train_all's corpus), ``fit_presence_head``
(the shipped trunk, ``scripts/train_presence.py``'s corpus and negatives)
and ``train_conv_landmarker`` with ``roi_loss_weight`` 0 and 1, each card
against CPU from one start and one set of numpy indices within
``PRE_WEIGHT_LIMIT`` of the weights' norm, which a planted fault (the ROI
term's landmarks detached) must break; each trainer's ms a step
(``time_ms``) and device share (``device_ms``); the detector's 1500 steps
and its held-out box error; the presence head's 600 steps and held-out
confidences; ERT boosting on the host (2 stages x 96 trees, depth 4, pool
128), timed; the JAX test's distillation (6 clips, 700 steps at batch 32)
behind the shipped detector and ERT, whose held-out error must be below
3 px on the card and equal to the CPU's within ``LMK_ERR_LIMIT`` (the
rounded-box agreement within one frame), with one ROI launch a 512 frames
in its teacher pass (counted) and kernel 1 against its plain version at
the teacher crop's shape; and the transcript gate (the
``transformer_hybrid_universal`` release behind both landmarkers, beam 8,
LM 0.4) with the card's transcripts equal to the CPU's.

The reference contracts add two phases before it:

* ``[parity-gate]``: the fp32 transcript parity gate (TF32 off for the
  phase, restored after). The ``bigru_ctc`` release at full width in
  float32 is exported by ``train/importer.export_model_state_dict`` to the
  reference-shaped torch model of ``tests/torch_ref.py`` (loaded by its
  path; strict) and imported back bit-exact. On the per-frame oracle's
  ROIs of make_clip(33000-33004) the port's greedy (kernel 2, one launch)
  and prefix-beam-16 transcripts on the card must be string-identical to
  the reference model's greedy and numpy prefix search (width 64) on the
  CPU; a clip that parts only at frames whose two best CPU logits lie
  within ``NEAR_TIE_LOGIT`` is printed with its margins and held against
  the reference run on the card instead. Then the four seeded legs of
  ``tests/test_parity_gate.py`` at its small widths (CTC greedy, CTC
  prefix beam with the x64 head, attention greedy, attention beam 4) card
  against the reference on the CPU, and a planted fault: the GRU's r and
  z gates swapped in the import must change a transcript;
* ``[oracle]``: ``oracle.pipeline.run_clip`` on clip 0 equal to
  ``tests/golden/clip0.npz`` exactly; ``preprocess_frames`` on the card
  (kernel 1, one launch) over its first 48 frames against it: face boxes
  and landmarks within 1e-2 (an ERT knife-edge frame, whose face box
  agrees within 1e-3 px while a nearest-pixel lookup flips, is printed;
  at most 2), mouth boxes equal, ROIs within 1e-3 (printed as
  ``parity_max_diff``), which mouth boxes shifted one pixel must break;
  ``native.preprocess_clip`` (the g++-built host oracle) against it; one
  frames/s reading each of the numpy oracle, the C++ oracle and the card's
  preprocess by ``profiling.Timer``; a ``profiling.capture`` trace of a
  card preprocess that names the ROI kernel (taken again up to 5 times).

The measurement entries add one phase, ``[measure]``, before it: each of
the eight entries' ``main`` in-process at a cut size (``MEASURE_ARGS``), its
printed table echoed: ``microbench``, ``roofline_preprocess``,
``bench_flash``, ``bench_stem``, ``profile_train``, ``profile_decode``,
``bench_decode_knee`` (these two on ``transformer_hybrid_universal``, which
has ``transformer_hybrid``'s architecture and preprocessing: the smoke reads
no other weights) and ``bench_ingest``. Each entry must print every row or
key of its JAX script, in its order, under the port's names
(``MEASURE_ROWS``); every time and rate must be finite and above 0 (the
decode profile's residual, a difference, finite; the codec keys of
``bench_ingest`` null where OpenCV is missing); the launch counts, set to 0
before each entry and read after, must show every kernel the entry runs
(``MEASURE_KERNELS``), each row naming a kernel its own
(``MEASURE_ROW_KERNELS``), and no ``_plain`` row a launch.

Multi-GPU training adds one phase, ``[multigpu]``, last: 4 ranks spawned
from this process (the kernels already built), one card each over NCCL
where 4 cards exist, else all on ``cuda:0`` over gloo (a log line says
which, and that ranks sharing one card give no scaling figure). Each rank
runs the release at full width (dropout and jitter off, labels rolled by
one sample since the release fits the fixtures' own) through ``Trainer``
in four layouts of ``MG_LAYOUTS``: DP 4 and DP 2 x TP 2 on the training
corpus's 8 samples, DP 2 x SP 2 (ring attention) and DP 2 x PP 2 (flash
on, 2 microbatches) on ``[train-flash]``'s long batch; ``MG_STEPS``
steps each, every rank's losses and norms equal, and against the same
global batch's one-process steps on the card: the first step's reduced
gradient, every step's loss and norm and the parameters after, within
``MG_LIMITS``, which each planted fault (the data axis's all-reduce
dropped, each rank's local mean for the global denominator, the frontend
summed over the model axis under PP) must break; rank 0's ms a step and
each rank's launches of rows 3-7 a step; a fused DP 4 step (each rank
preprocessing its own rows: one ROI launch a rank, its loss against the
one-process fused step); the DP 2 x TP 2 checkpoint rank 0 wrote,
restored and saved again by one process, byte-equal; and one DP step over
NCCL with a single rank (its collectives counted, its loss equal to the
one-process step's).

Each kernel row's ``launches_by_path`` holds its launches on each of these
paths' runs.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. Float32 matrix products and cuDNN convolutions run in
full float32 (TF32 off).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RELEASE = "transformer_hybrid_universal4"
N_CLIPS = 8
MIN_FRAMES = 64
BUCKET = 32                 # clips are zero-padded to a multiple of this
FIRST_SEED = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
ROI_TOL = 1e-4
PROFILE_ATTEMPTS = 5        # profiles device_ms takes before it fails
ROI_LONG_N = 4096           # the long-clip batch: 4 clips x 1024 frames
L2_FLUSH_BYTES = 128 * 2**20  # written between timed launches (L2: 50 MB)
# the greedy kernel's long-clip shape: B 4 x T 1024, lengths 940..980
GREEDY_LONG = (4, 1024, (940, 980))
# CTC lattice kernels vs their plain versions (the limits of
# tests/test_ctc_pallas.py): nll relative 1e-5 (same terms, same order; expf
# and log1pf differ from the CPU's by ulps over T steps), grads rtol 1e-3 /
# atol 1e-5
CTC_NLL_RTOL = 1e-5
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-3, 1e-5
CTC_B, CTC_T = 8, 128       # the path's batch and longest time bucket
CTC_REPLACES = {"fwd": "lipreading_tpu/ops/ctc_pallas.py:46",
                "bwd": "lipreading_tpu/ops/ctc_pallas.py:79"}
# correctness only: (case, B, T, L, first and last input length, range of
# the others, timed). S 121 and 601 put skip transitions across lane and
# warp boundaries of the kernels' plan; S 1025 and 2049 are the long
# labels a fine-tuning run may reach
CTC_EDGE_CASES = (("S121", 3, 160, 60, (150, 160), (121, 160), False),
                  ("S601", 3, 700, 300, (640, 700), (601, 700), False),
                  ("S1025", 2, 1100, 512, (1100, 1080), (1025, 1100), False),
                  ("S2049", 2, 2100, 1024, (2100, 2060), (2049, 2100), False))
# the chain probe's two step counts (one warp; its time per step is their
# difference in time over their difference in steps)
CHAIN_PROBE_STEPS = (2048, 34816)
TRAIN_CLIPS = 12            # fixture clips of the training corpus
TRAIN_STEPS = 10
STAGE_STEPS = 3             # steps timed stage by stage
FIXED_STEPS = 10            # steps on one fixed batch
TRAIN_DIR = os.path.join(ROOT, "runs", "chip_smoke_train")
# card vs CPU, one bf16 step: the card's reading must stay within each limit
# and a planted fault, the card's step with one clip's frame length one
# short (a masking off-by-one), must break it. Each limit sits between the
# two readings (PERF.md, section 6, PR 5)
PARITY_LIMITS = {
    "loss_rel": 1e-3,       # |loss a - loss b| / |loss b|
    "norm_rel": 1e-3,       # the same for the unclipped gradient norm
    "grad_1_cos": 1e-4,     # 1 - cosine of the two gradients
    "flip_share": 5e-3,     # weights whose first Adam step (lr sign g) differs
}

# flash attention (universal4's encoder: tf_dim 256, 4 heads, Dh 64)
FLASH_ON = {"model.flash_attention": 1}
FLASH_H, FLASH_DH = 4, 64
# (case, B, T, H, Dh, lengths, timed): the path's shape, ragged with a 0; a
# long one; and, for correctness only, a ragged one whose head dim takes
# the wrapper's padded copy (200-byte rows) and whose T ends mid-tile, with
# samples of length 1 and 0
FLASH_CASES = (("path", 4, 1024, FLASH_H, FLASH_DH, (1024, 1000, 517, 0), True),
               ("long", 2, 8192, FLASH_H, FLASH_DH, (8192, 6001), True),
               ("ragged", 3, 200, 2, 100, (200, 1, 0), False))
FLASH_AUTO_T = (64, 128, 256, 512, 1024, 2048, 8192)
# kernel vs plain, max|kernel - plain| / max|plain| of each output. Each
# limit sits between the card's readings and a planted fault's (each key
# mask one short): PERF.md section 6, flash attention
FLASH_LIMITS = {"float32": 2e-5, "bfloat16": 1e-2}
FLASH_REPLACES = {
    "fwd": "lipreading_tpu/ops/flash_attention.py:74",
    "fused": "lipreading_tpu/ops/flash_attention.py:326",
    "dq": "lipreading_tpu/ops/flash_attention.py:228",
    "dkv": "lipreading_tpu/ops/flash_attention.py:274",
}
FLASH_ROW = {"fwd": "flash_fwd", "fused": "flash_bwd_fused",
             "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
# [conv-dgrad]: the stride-1 convolutions' data gradients at the training
# cells' shapes (name, B, T, H = W, kernel, Cin, Cout): at B 64 x T 96 the
# conv3d stem's conv1 and conv2 and the patchify stem's convA and convB; at
# B 32 x T 256 (train.autoavsr_vsr's longest batch) the ResNet-18 trunk's
# 3x3 convolutions of each stage, 4 + 3 + 3 + 3 a step
DGRAD_T = 96
DGRAD_SHAPES = (("conv1", 64, 96, 24, (3, 5, 5), 32, 64),
                ("conv2", 64, 96, 12, (3, 3, 3), 64, 96),
                ("convA", 64, 96, 6, (3, 3, 3), 256, 256),
                ("convB", 64, 96, 3, (3, 3, 3), 256, 256),
                ("layer1", 32, 256, 22, (1, 3, 3), 64, 64),
                ("layer2", 32, 256, 11, (1, 3, 3), 128, 128),
                ("layer3", 32, 256, 6, (1, 3, 3), 256, 256),
                ("layer4", 32, 256, 3, (1, 3, 3), 512, 512))
# correctness only, (B, T, H, W, kernel, Cin, Cout): ragged last blocks,
# channels padded to 8 by the wrapper, every N tile, a chunk of Cout cut
# short, kernels without spatial or time taps
DGRAD_ODD = ((1, 5, 7, 9, (3, 5, 5), 8, 16), (2, 3, 5, 5, (3, 3, 3), 24, 40),
             (1, 4, 6, 6, (1, 1, 1), 300, 72), (3, 2, 4, 3, (3, 1, 3), 96, 200),
             (1, 1, 1, 1, (3, 3, 3), 12, 20), (2, 3, 5, 4, (1, 3, 3), 128, 8),
             (1, 7, 3, 2, (5, 1, 1), 5, 3))
# largest |kernel - plain| / largest |plain|, plain in float32 from the same
# bf16 operands: the kernel rounds its float32 sums to bf16 once
# (2^-9 of a value); the planted fault (the weight left unflipped) must
# break it at every cell shape
DGRAD_LIMIT = 1e-2
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
# the source of each row's (bf16) kernel
FLASH_SOURCE = dict.fromkeys(
    FLASH_ROW, "lipreading_tpu_torch/csrc/flash_attention_sm90.cu")
# bf16 device times (ms) of the two-pass pair's earlier kernels, float32 FMA
# on the CUDA cores, at the timed cases (chip_smoke.py's [flash] on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6, row 7): printed
# beside the tensor-core kernels' own
CUDA_CORE_PAIR_MS = {("dq", 1024): 0.2777, ("dkv", 1024): 0.4585,
                     ("dq", 8192): 9.3753, ("dkv", 8192): 12.5711}
# the Hopper kernels whose warpgroups trade registers with setmaxnreg, and
# the registers a thread of each must be built for: the producer warpgroup
# gives (168 - 56) x 128 to the two consumer warpgroups, 256 x (224 - 168)
# (csrc/flash_attention_sm90.cu, kBwdRegs)
SM90_SETMAXNREG = ("bwd_kernel", "bwd_dq_kernel")
SM90_BWD_REGS = 168
# one float32 step's gradient under pallas and fused against xla: limits
# between the readings and a planted fault's (PERF.md section 6, flash
# attention)
FLASH_GRAD_LIMITS = {"grad_rel": 3e-5, "grad_1_cos": 1e-9}
FLASH_TRAIN_STEPS = 3       # steps under each backward policy
FLASH_FIXED_STEPS = 5       # steps on the fixed long batch
# long clips: about 4 frames a character, padded to the encoder's 1024 rows
LONG_TEXTS = (
    "the quick brown fox jumps over the lazy dog while seven bright "
    "students read their notes aloud in the quiet hall and the old clock on "
    "the wall keeps ticking slowly as rain falls on the window and a small "
    "bird sings its morning song near the door",
    "we walked along the river after dinner and talked about the long "
    "summer days when the fields were green and the children played near "
    "the water until the sun went down behind the hills and the first stars "
    "came out over the old stone bridge",
    "please bring the blue book from the kitchen table and put it next to "
    "the lamp in my room because i want to finish reading the last chapter "
    "before the train leaves tomorrow morning at half past eight from the "
    "station near the old market",
    "every morning she opens the window to let the fresh air into the house "
    "then she makes a cup of tea and sits by the garden where the roses grow "
    "tall and the bees move from flower to flower in the warm light of the "
    "early sun on a clear day",
)
LONG_SEED = 500
LONG_BUCKET = 1024
LONG_MAX_CHARS = 256        # whole transcripts as targets (sos and eos too)
# the cascade as the JAX server decodes (scripts/serve.py: beam 8, LM 0.4)
CASCADE_KW = {"beam": 8, "lm_weight": 0.4}
# [tracked]: frames of make_clip(61) blanked; limits on max |card - CPU| of
# the tracked face boxes (px), the conv landmarks (px) and the ROIs, each
# between the card's reading (7.6e-5, 3.1e-5, 3.6e-5 on the H100) and a
# planted fault's (the card's frames shifted 1 px: 19.7, 7.9, 3.6)
TRACK_GAP = (4, 5, 6)
TRACK_LIMITS = {"face_boxes": 1e-3, "landmarks": 5e-4, "rois": 5e-4}
# the rest of training: dataviews, the dataview and tracked trainers, remat
DV_DIR = os.path.join(ROOT, "runs", "chip_smoke_dataview")
DV_CPU_CLIPS = 4            # [dataview]'s first clips, also built on the CPU
# [dataview] card vs CPU ROIs: the ERT build within the ROI kernel's limit,
# the tracked conv build within [tracked]'s
DV_ROI_TOL = {"ert": ROI_TOL, "conv": TRACK_LIMITS["rois"]}
HELDOUT_SEED = 1 + 999_983  # the training entry's held-out clips
HELDOUT_CLIPS = 4
HELDOUT_SAMPLES = 8
DV_STEPS = 4                # [train-dataview] fit steps, an eval at the last
TRACKED_STEPS = 3
TRACKED_EVAL_SAMPLES = 4
REMAT_SEED, REMAT_FAULT_SEED = 7, 1234
# [remat] gradient with remat against without, one generator; the planted
# fault (the recompute reseeded) must break each
REMAT_LIMITS = {"grad_rel": 1e-4, "grad_1_cos": 1e-6}
EVAL_CLIPS = 6              # [evaluate]: scripts/evaluate.py's n_clips
DEV = "cuda"                # the device of the training phases' runs
# [serve]: scripts/serve.py's defaults, the fixture clips rendered in the
# ring's workers
SERVE_KW = dict(source="render", n_clips=64, B=16, bucket=96, beam=8,
                lm_weight=0.4, tracked=True, landmarker="conv")
SERVE_CPU_CLIPS = 4         # [serve]'s first clips decoded on the CPU too
RESCORE_BUCKET = 8          # transcribe_cascade's default rescore_bucket

# the bi-GRU family and the conv3d stem ([bigru], [conv3d], [serve-bigru],
# [train-bigru])
BIGRU_RELEASE = "bigru_ctc"
CONV3D_RELEASE = "transformer_hybrid_universal"
BIGRU_BUCKET = 96           # [path]'s clips, as served
CONV3D_BUCKETS = (96, 128)
BIGRU_TRAIN_STEPS = 3
# card vs CPU from the same inputs, rel_err (over the valid frames): the
# card's reading must stay within each limit and a planted fault break it;
# each limit sits between the two readings on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, section 6)
BIGRU_ENC_LIMIT = 1e-1      # bf16 encoder output: card 3.1e-2, fault
                            # (torch.flip) 1.75
CONV3D_STEM_LIMIT = 2e-2    # bf16 stem output: card 3.3e-3, fault (a
                            # symmetric pad) 0.19
BIGRU_LOGITS_LIMIT = 1e-3   # float32 teacher-forced logits: card 3.9e-5,
                            # fault (attention mask off) 0.23
# one bf16 step, [parity]'s readings; the fault is a length one short. The
# bf16 recurrence rounds at every op of 32 steps, so the card reads nearer
# [parity]'s limits than the transformer does: card 1.5e-5 / 9.1e-4 /
# 5.2e-5 / 2.4e-3, fault 3.4e-2 / 4.1e-2 / 1.2e-3 / 3.4e-2
BIGRU_PARITY_LIMITS = {"loss_rel": 1e-3, "norm_rel": 5e-3,
                       "grad_1_cos": 3e-4, "flip_share": 1e-2}

# streaming ([stream]): stream_latency's configs and the pinned styled
# stream of tests/test_streaming.py::test_styled_stream_ladder_pin
STREAM_SEEDS = (33001, 33002, 33003)
STYLED_SEEDS = (33001, 33002)   # at variation 0.6
STREAM_CHUNK, STREAM_WINDOW = 8, 64
STREAM_BEAM, STREAM_LM = 4, 0.4
STREAM_ASSETS = "robust"
# a card stream may part from the CPU's only at an argmax whose top-1 minus
# top-2 log-prob margin is below this on the card or the CPU (bf16 logits
# of magnitude 8-32 are 0.0625-0.125 apart)
NEAR_TIE_NATS = 0.25
# [preproc-train]: fixture clips by their make_clip seeds (make_clips(s, n)
# renders s * 10_000 + i): train_all's corpus at seed 0 and its held-out
# clips, scripts/train_presence.py's, and tests/test_landmarker.py's
PRE_CLIPS = {"det": [10_000 + i for i in range(40)],
             "det_held": [777_001 * 10_000 + i for i in range(6)],
             "presence": [310_000 + i for i in range(24)],
             "presence_held": [777_101 * 10_000 + i for i in range(4)],
             "lmk": [9100 + i for i in range(6)],
             "lmk_held": [9300, 9301]}
PRE_CMP_STEPS = 3           # first steps held card against CPU
PRE_CMP_CLIPS = 2           # the landmarker's comparisons: lmk's first clips
PRE_WEIGHT_LIMIT = 1e-4     # |card - CPU| / |CPU| over all weights
LMK_STEPS, LMK_BATCH, LMK_ERR_PX = 700, 32, 3.0   # the JAX test's run
LMK_ERR_LIMIT = 1e-4        # px, the card-trained weights' error card vs CPU
PRE_ERT = dict(stages=2, trees=96, depth=4, pool=128)
PRE_GATE_CLIPS = 2
PRE_GATE_RELEASE = "transformer_hybrid_universal"
# [multigpu]: 4 ranks (NCCL, one card each, with 4 cards; else all on
# cuda:0 over gloo), the release at full width, dropout and jitter off,
# the labels rolled by one sample
MG_RANKS = 4
MG_STEPS = 3
MG_JOIN_S = 600.0           # s from the ranks' start to their join
MG_BASE = {"model.dropout": 0.0, "train.roi_augment": 0.0,
           "train.warmup_steps": 0}
# layout -> (its overrides, its batch: the training corpus's 8 samples or
# [train-flash]'s long batch of 4 clips at T 1024)
MG_LAYOUTS = {
    "dp4": ({"mesh.data_parallel": 4}, "short"),
    "dp2tp2": ({"mesh.data_parallel": 2, "mesh.model_parallel": 2}, "short"),
    "dp2sp2": ({"mesh.data_parallel": 2, "mesh.model_parallel": 2,
                "mesh.sequence_parallel": True}, "long"),
    "dp2pp2": ({"mesh.data_parallel": 2, "mesh.model_parallel": 2,
                "mesh.pipeline_parallel": True,
                "mesh.pipeline_microbatches": 2,
                "model.flash_attention": True}, "long"),
}
# planted faults -> the layout they run on
MG_FAULTS = {"data all-reduce dropped": "dp4",
             "local mean, not the global denominator": "dp4",
             "frontend summed over the model axis (PP)": "dp2pp2"}
# limits (each between the card's readings and the planted faults'):
# grad_rel / leaf_rel of the first step's reduced gradient, loss_rel and
# norm_rel of every step on every rank, param_rel after MG_STEPS steps
# (card, gloo, first call: grad_rel 2.0e-3-1.2e-2, leaf_rel 3.2e-3-8.5e-2,
# loss_rel <= 2.2e-4, norm_rel <= 3.7e-3, param_rel <= 2.8e-4; the faults
# grad_rel 0.39-2.99, leaf_rel 1.00-3.15)
MG_LIMITS = {"grad_rel": 5e-2, "leaf_rel": 2e-1, "loss_rel": 2e-3,
             "norm_rel": 2e-2, "param_rel": 2e-3}
# [parity-gate] and [oracle]: the reference contracts
PG_FIRST_SEED = 33000       # make_clip(33000 + i), i < PG_CLIPS
PG_CLIPS = 5
PG_RELEASE_SEARCH = 64      # the numpy prefix search on the release's posteriors
PG_SEEDED_SEARCH = 256      # ... on the x64 seeded head's (tests/test_torch_parity_gate.py)
PG_LEGS = (("ctc greedy", "ctc", 100, 1), ("ctc prefix beam", "ctc", 101, 16),
           ("attention greedy", "attention", 102, 1),
           ("attention beam", "attention", 103, 4))
NEAR_TIE_LOGIT = 1e-5       # two best logits closer than this: a near tie
ORACLE_FRAMES = 48          # clip 0's first frames through the card's preprocess
ORACLE_LIMITS = {"face_boxes": 1e-2, "landmarks": 1e-2, "roi": 1e-3}
# a frame whose landmarks part by more than the limit while its face box
# agrees within ORACLE_KNIFE_BOX px is an ERT knife edge (a nearest-pixel
# lookup flips: clip 0 frame 29 parts by 0.111 px in the JAX package's own
# batched preprocess on the CPU); at most ORACLE_KNIFE_EDGES such frames
ORACLE_KNIFE_BOX = 1e-3
ORACLE_KNIFE_EDGES = 2
ORACLE_DIR = os.path.join(ROOT, "runs", "chip_smoke_oracle")
# [measure]: each entry's cut size, the rows or keys it must print (the JAX
# script's, under the port's names), the kernels its run must launch, and
# the kernels that each row naming a kernel must launch
MEASURE_RELEASE = "transformer_hybrid_universal"
MEASURE_ARGS = {
    "microbench": ["frames=96", "reps=3"],
    "roofline_preprocess": ["frames=96", "reps=3"],
    "bench_flash": ["T=1024,4096", "reps=2"],
    "bench_stem": ["B=8", "T=32", "K=3"],
    "profile_train": ["B=8", "T=32", "reps=3"],
    "profile_decode": ["B=4", "T=32", "beam=4", "reps=1"],
    "bench_decode_knee": ["Bs=4", "clips=4", "reps=1"],
    "bench_ingest": ["n=4", "T=32", "workers=1"],
}
MEASURE_ROWS = {
    "microbench": ["grayscale", "detector", "ert_cascade", "roi_kernel",
                   "roi_plain", "preprocess_full", "ctc_fwd_plain",
                   "ctc_fwd_kernel", "ctc_grad_plain", "ctc_grad_kernel",
                   "ctc_decode_plain", "ctc_decode_kernel",
                   *(f"attn_{k}_T{T}" for T in (128, 512, 1024)
                     for k in ("plain", "flash"))],
    "roofline_preprocess": ["grayscale", "detector", "ert", "roi_kernel",
                            "roi_plain", "full_ert", "gather10", "copy"],
    "bench_flash": [f"{T} {b}" for T in (1024, 4096)
                    for b in ("pallas", "fused")],
    "bench_stem": ["conv3d", "patchify"],
    "profile_train": ["full step", "frontend fwd+bwd", "encoder fwd+bwd",
                      "decoder fwd+bwd", "ctc head+loss fwd+bwd",
                      "optimizer (AdamW)", "sum of parts"],
    "profile_decode": ["encode", "greedy+conf", "beam@48", "beam@32",
                       "beam@24", "att-steps x48", "ctc-scores x48",
                       "topk+gather+lm (residual)"],
    "bench_decode_knee": ["flagship 4", "cascade 4", "greedy 4"],
    "bench_ingest": ["host_decode_fps", "pool_decode_fps@1",
                     "null_ipc_fps@1", "shm_decode_fps@1",
                     "shm_decode_view_fps@1", "null_shm_fps@1",
                     "null_shm_view_fps@1"],
}
_CTC = ("ctc_lattice_fwd", "ctc_lattice_bwd")
MEASURE_KERNELS = {
    "microbench": ("roi_sampler", "ctc_greedy", *_CTC, "flash_fwd"),
    "roofline_preprocess": ("roi_sampler",),
    "bench_flash": ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                    "flash_bwd_dkv"),
    "bench_stem": _CTC,
    "profile_train": _CTC,
    "profile_decode": ("ctc_greedy",),
    "bench_decode_knee": ("roi_sampler", "ctc_greedy"),
    "bench_ingest": (),
}
MEASURE_ROW_KERNELS = {
    "roi_kernel": ("roi_sampler",), "preprocess_full": ("roi_sampler",),
    "full_ert": ("roi_sampler",), "ctc_fwd_kernel": ("ctc_lattice_fwd",),
    "ctc_grad_kernel": _CTC, "ctc_decode_kernel": ("ctc_greedy",),
    "attn_flash_T128": ("flash_fwd",), "attn_flash_T512": ("flash_fwd",),
    "attn_flash_T1024": ("flash_fwd",),
    "1024 pallas": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "4096 pallas": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "1024 fused": ("flash_fwd", "flash_bwd_fused"),
    "4096 fused": ("flash_fwd", "flash_bwd_fused"),
    "conv3d": _CTC, "patchify": _CTC, "full step": _CTC,
    "ctc head+loss fwd+bwd": _CTC, "greedy+conf": ("ctc_greedy",),
    "flagship 4": ("roi_sampler",),
    "cascade 4": ("roi_sampler", "ctc_greedy"),
    "greedy 4": ("roi_sampler", "ctc_greedy"),
}


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeError(msg)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs, warmed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, name: str = "") -> tuple[float, dict]:
    """Device milliseconds per call of ``fn()``: the device time of every
    kernel, fill and copy that ``torch.profiler`` records over ``iters``
    warmed calls, summed and divided by ``iters`` -> (ms, {name: ms}).
    A profile that records no device time (or no kernel whose name holds
    ``name``) is taken again after a second's pause, up to
    ``PROFILE_ATTEMPTS`` in all (on the H100 a profile now and then comes
    back empty, once twice in a row); fails if none records it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                split[e.name] = (split.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / iters)
        if sum(split.values()) > 0 and any(name in n for n in split):
            return sum(split.values()), split
        log(f"[profiler] profile {attempt} of {PROFILE_ATTEMPTS} recorded no "
            f"device time{f' for {name}' if name else ''}: taken again")
        time.sleep(1.0)
    check(False, f"torch.profiler recorded no device time"
          f"{f' for {name}' if name else ''} in {PROFILE_ATTEMPTS} profiles")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixture_batch():
    """The first N_CLIPS fixture clips of >= MIN_FRAMES frames, zero-padded
    to a common length -> (frames [B, T, H, W, 3] u8, lengths [B], texts)."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import make_clip

    clips, seed = [], FIRST_SEED
    while len(clips) < N_CLIPS:
        c = make_clip(seed)
        if c.frames.shape[0] >= MIN_FRAMES:
            clips.append(c)
        seed += 1
    T = -(-max(c.frames.shape[0] for c in clips) // BUCKET) * BUCKET
    H, W = clips[0].frames.shape[1:3]
    frames = np.zeros((N_CLIPS, T, H, W, 3), np.uint8)
    lengths = np.zeros((N_CLIPS,), np.int32)
    for b, c in enumerate(clips):
        frames[b, :len(c.frames)] = c.frames
        lengths[b] = len(c.frames)
    return frames, lengths, [c.text for c in clips]


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "UBLKCP")
# sources whose kernels must not spill
NO_SPILL_SOURCES = ("sm90", "ctc_lattice", "roi_sampler", "ctc_greedy",
                    "conv3d_dgrad")


def sass_counts(path: str) -> dict:
    """How many tensor-core (HGMMA), TMA-load (UTMALDG), asynchronous copy
    (LDGSTS) and bulk copy (UBLKCP) instructions ``cuobjdump --dump-sass``
    finds in each kernel of the library -> {kernel name: {op: count}}."""
    import re

    from lipreading_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", path], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts.setdefault(fn, dict.fromkeys(SASS_OPS, 0))
            continue
        if fn is None:
            continue
        for op in SASS_OPS:
            if (line.split()[1:2] == [op] or f" {op}." in line
                    or f" {op} " in line):
                counts[fn][op] += 1
    return counts


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a kernel from its mangled name."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            n = int(mangled[i:m.end()])
            name = mangled[m.end():m.end() + n]
            if name.endswith("_kernel"):
                # template arguments: types by letter, values as L<type>nE
                t = re.match(r"I((?:L[a-z]\d+E|[a-z])+)E",
                             mangled[m.end() + n:])
                if not t:
                    return name
                args = [v or {"f": "float"}.get(c, c) for v, c in
                        re.findall(r"L[a-z](\d+)E|([a-z])", t.group(1))]
                return f"{name}<{','.join(args)}>"
    return mangled


def phase_build():
    """Build, print each kernel's registers and spills as ptxas reports them
    (the Hopper flash and CTC lattice kernels must not spill; those that use
    setmaxnreg must be built for its pool) and the SASS counts."""
    import re

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops.ctc import LATTICE_K

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] nvcc + load: {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc and link {kernels.STATE.build_seconds:.2f} s; 0 = "
        f"cached) -> {kernels.STATE.path}")
    source, entry, spills, regs = "", "", {}, {}
    for line in kernels.STATE.build_log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = f"{source}:{kernel_name(m.group(1))}"
        if "spill" in line or "registers" in line:
            log(f"[build] {entry} {line.strip()}")
        if any(k in source for k in NO_SPILL_SOURCES):
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills[entry] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry.split(":")[-1].split("<")[0] in SM90_SETMAXNREG:
                regs[entry] = int(m.group(1))
    if kernels.STATE.build_seconds:
        check(spills and not any(spills.values()),
              f"Hopper flash, CTC lattice, ROI, greedy or conv3d data-gradient "
              f"kernels spill: "
              f"{spills}")
        # before any launch: a count below this would leave setmaxnreg
        # waiting for registers that no warp frees
        found = {e.split(":")[-1].split("<")[0] for e in regs}
        check(found == set(SM90_SETMAXNREG)
              and all(r == SM90_BWD_REGS for r in regs.values()),
              f"Hopper setmaxnreg kernels built for {regs} registers, want "
              f"{SM90_BWD_REGS} (setmaxnreg's pool) for each of "
              f"{SM90_SETMAXNREG}")
    by_kernel = sass_counts(kernels.STATE.path)
    counts = {op: sum(c[op] for c in by_kernel.values()) for op in SASS_OPS}
    log(f"[build] SASS: {counts['HGMMA']} HGMMA (wgmma) and "
        f"{counts['UTMALDG']} UTMALDG (TMA load) instructions")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          f"no tensor-core or TMA instructions in the library: {counts}")
    # the CTC lattice kernels fetch their emissions ahead of the chain by
    # asynchronous copies: every instance must hold them
    lattice = {k: c for k, c in by_kernel.items()
               if k.startswith(("ctc_fwd_kernel", "ctc_bwd_kernel"))}
    log("[build] SASS of the CTC lattice kernels: " + "; ".join(
        f"{k} {c['LDGSTS']} LDGSTS, {c['UBLKCP']} UBLKCP"
        for k, c in sorted(lattice.items())))
    check(len(lattice) == 2 * len(LATTICE_K)
          and all(c["LDGSTS"] + c["UBLKCP"] > 0 for c in lattice.values()),
          f"CTC lattice kernels without asynchronous copies: {lattice}")
    # every ROI kernel instance and the greedy kernel's staged one copy by
    # cp.async
    staged = {k: c for k, c in by_kernel.items()
              if k == "ctc_greedy_kernel<1>"
              or k.startswith("roi_sample_kernel<")}
    log("[build] SASS of the staged ROI and greedy kernels: " + "; ".join(
        f"{k} {c['LDGSTS']} LDGSTS" for k, c in sorted(staged.items())))
    check(len(staged) == 5 and all(c["LDGSTS"] > 0 for c in staged.values()),
          f"staged ROI or greedy kernels without cp.async: {staged}")
    # every instance of the convolution's data gradient: wgmma and cp.async
    dgrad = {k: c for k, c in by_kernel.items()
             if k.startswith("dgrad_kernel<")}
    log("[build] SASS of the conv3d data gradient: " + "; ".join(
        f"{k} {c['HGMMA']} HGMMA, {c['LDGSTS']} LDGSTS"
        for k, c in sorted(dgrad.items())))
    check(len(dgrad) == 4 and all(c["HGMMA"] > 0 and c["LDGSTS"] > 0
                                  for c in dgrad.values()),
          f"conv3d data-gradient kernels without wgmma or cp.async: {dgrad}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def path_inputs(frames, lengths, dev):
    """The ROI sampler's and the greedy kernel's inputs as the main path
    makes them: gray frames, integer and float mouth boxes, log-probs."""
    import torch

    from lipreading_tpu_torch.ops import detector as det_ops
    from lipreading_tpu_torch.ops import ert as ert_ops
    from lipreading_tpu_torch.ops import preprocess as pre
    from lipreading_tpu_torch.ops.roi import grayscale

    det, ert = dev["det"], dev["ert"]
    B, T, H, W, _ = frames.shape
    with torch.inference_mode():
        gray = grayscale(torch.as_tensor(frames, device="cuda").reshape(
            B * T, H, W, 3))
        lmk = ert_ops.predict_batch(ert, gray, det_ops.detect(det, gray))
        boxes_i = pre.mouth_boxes_from_landmarks(
            lmk, dev["cfg"].preprocess.roi_margin, H, W)
        boxes_f = pre.mouth_boxes_float(lmk, dev["cfg"].preprocess.roi_margin)
    return gray, boxes_i, boxes_f


def roi_bytes_needed(boxes, subpixel: bool, H: int, W: int, R: int) -> int:
    """Bytes of gray that the ROIs depend on: each frame's distinct tap rows
    times distinct tap columns, 4 bytes each (plus the boxes)."""
    import torch

    from lipreading_tpu_torch.ops.roi import _interp_weights_dense

    wy = _interp_weights_dense(boxes[:, 1], boxes[:, 2], H, R, subpixel)
    wx = _interp_weights_dense(boxes[:, 0], boxes[:, 2], W, R, subpixel)
    rows = (wy != 0).any(dim=1).sum(dim=1)        # [N] distinct rows touched
    cols = (wx != 0).any(dim=1).sum(dim=1)
    return int(torch.sum(rows * cols).item()) * 4 + boxes.numel() * 4


def kernel_ms(fn, iters: int, name: str) -> float:
    """Device ms per call of ``fn()`` of the kernels whose name holds
    ``name`` (``device_ms``'s split)."""
    split = device_ms(fn, iters, name)[1]
    return sum(t for n, t in split.items() if name in n)


def launch_floor_ms() -> float:
    """Device ms of an empty kernel of one block (``noop_kernel``) by
    torch.profiler: the least any launch takes on this card."""
    from lipreading_tpu_torch import kernels

    lib = kernels.lib()
    st = kernels.stream_ptr("cuda")
    kernels.check(lib.noop_kernel(st), "noop_kernel")
    return kernel_ms(lambda: lib.noop_kernel(st), 200, "empty_kernel")


def same_bytes(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def roi_grid(boxes, N: int, H: int, W: int, R: int):
    """``F.grid_sample``'s grid for the same crops (the yardstick)."""
    import torch

    x0, y0, s = (boxes[:, k].float() for k in range(3))
    j = (torch.arange(R, device="cuda", dtype=torch.float32) + 0.5) / R
    gx = (x0[:, None] + j[None] * s[:, None]) * (2.0 / W) - 1.0
    gy = (y0[:, None] + j[None] * s[:, None]) * (2.0 / H) - 1.0
    return torch.stack([gx[:, None, :].expand(N, R, R),
                        gy[:, :, None].expand(N, R, R)], dim=-1)


def roi_times(name: str, gray, boxes, R: int, kw: dict, flush,
              floor: float) -> dict:
    """The ROI kernel at one shape (integer boxes, or float boxes with
    ``kw["subpixel"]``): the same bytes over two launches, max|kernel - plain|, its own device time
    (torch.profiler, bare C entry) with normalize=1 and 0, after an L2
    flush when ``flush`` is given (a write of that buffer between
    launches), warm beside; the wrapper's time (CUDA events, warm), the
    plain version's, F.grid_sample's device time and the byte bound."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import roi

    N, H, W = gray.shape
    sub = bool(kw.get("subpixel", False))
    got = roi.sample_rois(gray, boxes, R, **kw)
    again = roi.sample_rois(gray, boxes, R, **kw)
    want = roi.sample_rois_reference(gray, boxes, R, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    same = same_bytes(got, again)
    del got, again, want
    lib_k = kernels.lib()
    st = kernels.stream_ptr(gray.device)
    out = torch.empty((N, R, R), dtype=torch.float32, device="cuda")
    p = roi.roi_plan(N, R)

    def bare(norm: int):   # the C entry alone
        return lib_k.roi_sample(
            gray.data_ptr(), boxes.data_ptr(), out.data_ptr(), N, H, W, R,
            kw["mean"], kw["std"], norm, int(sub), p.tpr, p.rpp, p.band,
            p.threads, p.smem, st)

    def flushed(norm: int):
        if flush is not None:
            flush.fill_(1.0)
        return bare(norm)

    kernels.check(bare(1), "bare roi_sample")
    iters = 50 if N <= 1024 else 20
    ms = {norm: kernel_ms(lambda n=norm: flushed(n), iters, "roi_sample")
          for norm in (1, 0)}
    warm = kernel_ms(lambda: bare(1), iters, "roi_sample")
    wrap = time_ms(lambda: roi.sample_rois(gray, boxes, R, **kw), iters)
    plain = time_ms(lambda: roi.sample_rois_reference(gray, boxes, R, **kw),
                    10 if N <= 1024 else 3)
    grid = roi_grid(boxes, N, H, W, R)
    g4 = gray[:, None]
    lib = device_ms(lambda: F.grid_sample(g4, grid, mode="bilinear",
                                          align_corners=False), iters)[0]
    del grid
    nbytes = roi_bytes_needed(boxes, sub, H, W, R) + N * R * R * 4
    b_ms, b_by = bound_ms(nbytes, 10.0 * N * R * R)
    log(f"[roi] {name} N={N} H={H} W={W} R={R}: max |kernel - plain| = "
        f"{err:.3g}; a second launch gives {'the same' if same else 'OTHER'} "
        f"bytes; kernel device {ms[1]:.4f} ms "
        f"({'after an L2 flush, ' if flush is not None else ''}bare C "
        f"entry, torch.profiler; warm {warm:.4f}), normalize=0 {ms[0]:.4f} "
        f"ms (the two divisions: {ms[1] - ms[0]:.4f} ms, "
        f"{(ms[1] - ms[0]) / ms[1]:.1%}), plain {plain:.4f} ms, "
        f"F.grid_sample device {lib:.4f} ms, bound {b_ms * 1e3:.3f} us "
        f"({b_by}, {nbytes} B), the kernel at {b_ms / ms[1]:.1%} of it, "
        f"{ms[1] / floor:.1f}x the launch floor; the wrapper "
        f"(sample_rois, CUDA events, warm) {wrap:.4f} ms; plan {p}")
    check(err <= ROI_TOL, f"ROI {name} disagrees: {err}")
    check(same, f"ROI {name}: two launches give other bytes")
    return dict(err=err, ms=ms[1], ms_raw=ms[0], ms_warm=warm,
                wrapper_ms=wrap, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def greedy_times(name: str, lg, ln, blank: int, floor: float) -> dict:
    """The greedy kernel at one shape: the same bytes over two launches,
    its own device time (torch.profiler, bare C entry), the wrapper's time
    (CUDA events), the plain version's time, the composite yardstick's
    device time and the byte bound."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import decode

    B, T, V = lg.shape
    got = decode.ctc_greedy_ids(lg, ln, blank)
    again = decode.ctc_greedy_ids(lg, ln, blank)
    torch.cuda.synchronize()
    same = all(same_bytes(a, b) for a, b in zip(got, again))
    lib_k = kernels.lib()
    st = kernels.stream_ptr(lg.device)
    ids = torch.empty((B, T), dtype=torch.int32, device="cuda")
    cnt = torch.empty((B,), dtype=torch.int32, device="cuda")
    p = decode.greedy_plan(T, V)

    def bare():                     # the C entry alone
        return lib_k.ctc_greedy(lg.data_ptr(), ln.data_ptr(), ids.data_ptr(),
                                cnt.data_ptr(), B, T, V, blank, p.sV, p.chunk,
                                p.nbuf, p.buf_floats, p.threads, p.smem, st)

    kernels.check(bare(), "bare ctc_greedy")
    ms = kernel_ms(bare, 50, "ctc_greedy")
    wrap = time_ms(lambda: decode.ctc_greedy_ids(lg, ln, blank))
    plain = time_ms(lambda: decode.ctc_greedy_ids_reference(lg, ln, blank))

    def composite():
        raw = lg.argmax(-1)
        prev = F.pad(raw[:, :-1], (1, 0), value=blank)
        t_idx = torch.arange(T, device="cuda")[None]
        keep = (raw != blank) & (raw != prev) & (t_idx < ln[:, None])
        pos = torch.where(keep, torch.cumsum(keep, 1) - 1, T)
        out = torch.full((B, T + 1), blank, dtype=raw.dtype, device="cuda")
        return out.scatter_(1, pos, raw)[:, :T], keep.sum(1)

    comp = device_ms(composite, 50)[0]
    valid = int(torch.clamp(ln, 0, T).sum().item())
    nbytes = valid * V * 4 + B * 4 + B * T * 4 + B * 4
    b_ms, b_by = bound_ms(nbytes, valid * V)
    log(f"[greedy] {name} B={B} T={T} V={V} lengths {ln.tolist()}: a second "
        f"launch gives {'the same' if same else 'OTHER'} bytes; kernel device "
        f"{ms:.4f} ms (bare C entry, torch.profiler), {ms / floor:.2f}x the "
        f"launch floor; wrapper (ctc_greedy_ids, CUDA events) {wrap:.4f} ms; "
        f"plan {p}; plain {plain:.4f} ms, argmax+mask+cumsum+scatter "
        f"device {comp:.4f} ms (a yardstick of several calls: no single "
        f"PyTorch call computes this, so library_ms is null), bound "
        f"{b_ms * 1e3:.4f} us ({b_by}, {nbytes} B), the kernel at "
        f"{b_ms / ms:.2%} of it")
    check(same, f"CTC greedy {name}: two launches give other bytes")
    return dict(ms=ms, wrapper_ms=wrap, plain_ms=plain, composite_ms=comp,
                bound_ms=b_ms, bound_by=b_by)


def phase_kernels(frames, lengths, dev) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes: the
    ROI sampler at the serving batch (N 768) and the long-clip batch (N
    4096), the greedy kernel at B 8 x T 96 and B 4 x T 1024, each beside
    the launch floor."""
    import torch

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import decode, roi
    from lipreading_tpu_torch.text import Vocab

    cfg = dev["cfg"]
    pc = cfg.preprocess
    R = pc.roi_size
    gray, boxes_i, boxes_f = path_inputs(frames, lengths, dev)
    N, H, W = gray.shape
    rows = []
    floor = launch_floor_ms()
    log(f"[floor] an empty kernel of one block (noop_kernel): device "
        f"{floor:.4f} ms (torch.profiler, 200 launches)")

    # --- ROI sampler, both box modes (integer is the main path's) ---------
    kw = dict(mean=pc.normalize_mean, std=pc.normalize_std)
    errs = {}
    for name, boxes, sub in (("integer", boxes_i, False),
                             ("subpixel", boxes_f, True)):
        got = roi.sample_rois(gray, boxes, R, subpixel=sub, **kw)
        want = roi.sample_rois_reference(gray, boxes, R, subpixel=sub, **kw)
        torch.cuda.synchronize()
        errs[name] = (got - want).abs().max().item()
        check(torch.isfinite(got).all().item(), f"ROI {name}: non-finite")
        log(f"[roi] {name} boxes: max |kernel - plain| = {errs[name]:.3g} "
            f"(tolerance {ROI_TOL:g}: the kernel sums the two taps in "
            "another order than the dense float32 product)")
        check(errs[name] <= ROI_TOL, f"ROI {name} disagrees: {errs[name]}")

    # the normalisation's / 255 (div255): the bits of __fdiv_rn(x, 255)
    lib_k = kernels.lib()
    differ = torch.zeros(3, dtype=torch.int32, device="cuda")
    kernels.check(lib_k.roi_div255_check(
        differ.data_ptr(), kernels.stream_ptr(differ.device)),
        "roi_div255_check")
    near, far, other = differ.tolist()
    log(f"[roi] div255 against __fdiv_rn(x, 255) on every float: {near} "
        f"differ in [-256, 256], {far} among the other finite floats, "
        f"{other} among the infinities and NaNs")
    check(near == far == other == 0,
          f"div255 differs from __fdiv_rn on {near + far + other} floats")

    # the serving batch after an L2 flush (its output fits in the 50 MB
    # L2), and the long-clip batch: the serving frames tiled to 4 x 1024
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    serve = roi_times("serving", gray, boxes_i, R, kw, flush, floor)
    del flush
    reps = -(-ROI_LONG_N // N)
    gray_l = gray.repeat(reps, 1, 1)[:ROI_LONG_N].contiguous()
    boxes_l = boxes_i.repeat(reps, 1)[:ROI_LONG_N].contiguous()
    long = roi_times("long", gray_l, boxes_l, R, kw, None, floor)
    del gray_l, boxes_l
    torch.cuda.empty_cache()
    rows.append(dict(
        name="roi_sampler", route="cuda",
        source="lipreading_tpu_torch/csrc/roi_sampler.cu",
        replaces="lipreading_tpu/ops/roi.py:107",
        launches=0, max_abs_err=max(*errs.values(), long["err"]),
        ms=serve["ms"], plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
        bound_by=serve["bound_by"], library_ms=serve["library_ms"],
        wrapper_ms=serve["wrapper_ms"], floor_ms=floor,
        ms_raw=serve["ms_raw"], ms_warm=serve["ms_warm"],
        long={k: long[k] for k in ("ms", "ms_raw", "ms_warm", "wrapper_ms",
                                   "plain_ms", "library_ms", "bound_ms")}))

    # --- CTC greedy: path shape plus the edge cases -------------------------
    V, blank = cfg.model.vocab_size, Vocab().blank_id
    B, T = frames.shape[:2]
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    # the path's shape, edge cases, the long clips, then more edge cases
    # (ragged starts at V 7, double-buffered chunks at T 4096, a warp a
    # frame at V 2000)
    for (b, t, v) in ((B, T, V), (B, 1, V), (B, 128, V), (3, 1000, V),
                      (GREEDY_LONG[0], GREEDY_LONG[1], V),
                      (5, 3, 7), (2, 4096, V), (3, 50, 2000)):
        # small integers make ties common: the first maximum must win
        lg = torch.randint(0, 4, (b, t, v), generator=g).float()
        ln = torch.randint(0, t + 1, (b,), generator=g, dtype=torch.int32)
        ln[0] = 0
        ln[-1] = t
        if (b, t) == GREEDY_LONG[:2]:   # the long clips' lengths
            ln = torch.randint(GREEDY_LONG[2][0], GREEDY_LONG[2][1] + 1, (b,),
                               generator=g, dtype=torch.int32)
        cases.append((lg.cuda(), ln.cuda()))
    worst = 0
    for lg, ln in cases:
        ids, cnt = decode.ctc_greedy_ids(lg, ln, blank)
        rids, rcnt = decode.ctc_greedy_ids_reference(lg, ln, blank)
        torch.cuda.synchronize()
        bad = int((ids != rids).sum().item() + (cnt != rcnt).sum().item())
        log(f"[greedy] B={lg.shape[0]} T={lg.shape[1]} V={lg.shape[2]}: "
            f"{bad} ids or counts differ from the plain version")
        check(bad == 0, "CTC greedy disagrees with its plain version")
        worst = max(worst, bad)
    serve = greedy_times("serving", *cases[0], blank, floor)
    long = greedy_times("long", *cases[4], blank, floor)
    rows.append(dict(
        name="ctc_greedy", route="cuda",
        source="lipreading_tpu_torch/csrc/ctc_greedy.cu",
        replaces="lipreading_tpu/ops/decode_pallas.py:22",
        launches=0, max_abs_err=float(worst), ms=serve["ms"],
        plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
        bound_by=serve["bound_by"], library_ms=None,
        wrapper_ms=serve["wrapper_ms"], floor_ms=floor,
        composite_ms=serve["composite_ms"],
        long={k: long[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                   "composite_ms", "bound_ms")}))
    return rows


def load_port(device: str, overrides: dict | None = None,
              release: str = RELEASE):
    from lipreading_tpu_torch.io import load_assets, load_release_model
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch

    model, cfg = load_release_model(release, device=device,
                                    overrides=overrides)
    det_np, ert_np = load_assets()
    return {"model": model, "cfg": cfg,
            "det": params_to_torch(det_np, device),
            "ert": model_to_torch(ert_np, device)}


def run_path(frames, lengths, port):
    from lipreading_tpu_torch.infer import transcribe_greedy

    return transcribe_greedy(port["model"], port["cfg"], port["det"],
                             port["ert"], frames, lengths)


def phase_path(frames, lengths, texts, gpu, rows):
    import torch

    from lipreading_tpu_torch.infer import greedy_conf
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.ops.roi import sample_rois

    wrappers = {"roi_sampler": sample_rois, "ctc_greedy": ctc_greedy_ids}
    B, T = frames.shape[:2]
    log(f"[path] {B} clips x {T} frames at {frames.shape[2]}x"
        f"{frames.shape[3]}, lengths {lengths.tolist()}, release {RELEASE}")
    run_path(frames, lengths, gpu)                  # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    hyps, flags = run_path(frames, lengths, gpu)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    path_rows = [r for r in rows if r["name"] in wrappers]
    for row in path_rows:
        row["launches"] = wrappers[row["name"]].launches
    log(f"[path] frames -> transcripts: {dt * 1e3:.1f} ms host clock "
        f"({B * T / dt:.0f} padded frames/s), launches "
        + ", ".join(f"{r['name']}={r['launches']}" for r in path_rows))
    for r in path_rows:
        check(r["launches"] > 0, f"{r['name']} never launched on the path")

    # outputs: finite, of the expected shape; and the time of each stage
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clips_t = torch.as_tensor(frames, device="cuda")
        lens_t = torch.as_tensor(lengths, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rois = preprocess_clips(gpu["det"], gpu["ert"], clips_t,
                                gpu["cfg"].preprocess)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ids, cnt, conf, enc = greedy_conf(gpu["model"], gpu["cfg"], rois,
                                          lens_t)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    log(f"[path] stages (host clock, synchronised): frames to card "
        f"{(t1 - t0) * 1e3:.2f} ms, preprocess_clips {(t2 - t1) * 1e3:.2f} "
        f"ms, greedy_conf {(t3 - t2) * 1e3:.2f} ms")
    R = gpu["cfg"].preprocess.roi_size
    check(tuple(rois.shape) == (B, T, R, R), f"rois {tuple(rois.shape)}")
    check(tuple(ids.shape) == (B, T), f"ids {tuple(ids.shape)}")
    check(tuple(enc.shape) == (B, T, gpu["cfg"].model.tf_dim),
          f"enc {tuple(enc.shape)}")
    for name, x in (("rois", rois), ("conf", conf), ("enc", enc)):
        check(torch.isfinite(x.float()).all().item(), f"{name} not finite")

    cer = corpus_cer(hyps, texts)
    for h, t, f in zip(hyps, texts, flags):
        log(f"[path]   {h!r:32} ref {t!r:32} margin flag {bool(f)}")
    log(f"[path] corpus CER {cer:.4f}; {int(flags.sum())} of {B} clips below "
        "the cascade's margin (the joint beam's leg runs in [cascade])")

    # the same run on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu_hyps, cpu_flags = run_path(frames, lengths, load_port("cpu"))
    log(f"[path] CPU run ({time.perf_counter() - t0:.1f} s): transcripts "
        f"{'equal' if cpu_hyps == hyps else 'DIFFER'}, margin flags "
        f"{'equal' if (cpu_flags == flags).all() else 'differ'}")
    check(cpu_hyps == hyps, f"GPU transcripts {hyps} != CPU {cpu_hyps}")


def ctc_case(V: int, L: int, B: int, T: int, seed: int, ends,
             inl_range=None):
    """CTC lattice inputs from random log-probs: S = 2 L + 1; labels drawn
    from 1..V-1 with a repeat at the start (no skip there); label lengths
    mixed, the first 0 and the last L; input lengths drawn from
    ``inl_range`` (default T/2..T), at least 2 len + 2 and at most T, the
    first and the last set to ``ends``."""
    import numpy as np
    import torch

    from lipreading_tpu_torch.ops import ctc

    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(0, 2, (B, T, V)).astype(np.float32))
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[:, 1] = labels[:, 0]
    lab = rng.integers(1, L + 1, B).astype(np.int32)
    lab[0], lab[-1] = 0, L
    lo, hi = inl_range or (T // 2, T)
    inl = np.minimum(np.maximum(2 * lab + 2, rng.integers(lo, hi + 1, B)),
                     T).astype(np.int32)
    inl[0], inl[-1] = ends
    labels_t = torch.from_numpy(labels)
    lp_ext, skip = ctc._lattice_inputs(logits, labels_t, 0)
    return {"logits": logits.cuda(), "labels": labels_t.cuda(),
            "lp_ext": lp_ext.cuda(), "skip": skip.cuda(),
            "inl": torch.from_numpy(inl).cuda(),
            "lab": torch.from_numpy(lab).cuda()}


def ctc_readings(nll, grad, nll_w, grad_w) -> tuple[float, float]:
    """(max relative nll error, max grad excess over the rtol / atol limit)
    of lattice results against the plain version's."""
    nll_rel = ((nll - nll_w).abs() / nll_w.abs().clamp(min=1.0)).max().item()
    excess = ((grad - grad_w).abs()
              - (CTC_GRAD_ATOL + CTC_GRAD_RTOL * grad_w.abs())).max().item()
    return nll_rel, excess


def ctc_check(name: str, c: dict, g) -> dict:
    """One CTC case: both wrappers against their plain versions (nll
    relative CTC_NLL_RTOL, grads CTC_GRAD_RTOL / ATOL), finite, grads exactly
    0 past each input length, and a second launch of each kernel giving the
    same bytes."""
    import torch

    from lipreading_tpu_torch.ops import ctc

    lp, skip, inl, lab = c["lp_ext"], c["skip"], c["inl"], c["lab"]
    B, T, S = lp.shape
    nll, alpha = ctc.ctc_lattice_fwd(lp, skip, inl, lab)
    grad = ctc.ctc_lattice_bwd(lp, skip, inl, lab, alpha, nll, g)
    nll2, alpha2 = ctc.ctc_lattice_fwd(lp, skip, inl, lab)
    grad2 = ctc.ctc_lattice_bwd(lp, skip, inl, lab, alpha, nll, g)
    nll_w, alpha_w = ctc.ctc_lattice_fwd_reference(lp, skip, inl, lab)
    grad_w = ctc.ctc_lattice_bwd_reference(lp, skip, inl, lab, alpha_w,
                                           nll_w, g)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(nll).all() and torch.isfinite(grad).all()),
          f"CTC lattice {name}: non-finite nll or grad")
    nll_rel, g_excess = ctc_readings(nll, grad, nll_w, grad_w)
    same = all(same_bytes(a, b)
               for a, b in ((nll, nll2), (alpha, alpha2), (grad, grad2)))
    t_idx = torch.arange(T, device="cuda")[None, :, None]
    past = (grad.abs() * (t_idx >= inl[:, None, None])).sum().item()
    # skip transitions s - 2 -> s whose two states lie in other lanes, and
    # in other warps, of the kernels' plan
    W, K = ctc.lattice_plan(S)
    s_idx = torch.arange(S, device="cuda")
    cross_lane = int((skip & ((s_idx - 2).clamp(min=0) // K
                              != s_idx // K)).sum().item())
    cross_warp = int((skip & ((s_idx - 2).clamp(min=0) // (32 * K)
                              != s_idx // (32 * K))).sum().item())
    log(f"[ctc] {name}: plan {W} warp(s) of K {K} states a lane; skip "
        f"transitions across lanes {cross_lane}, across warps {cross_warp}")
    check(cross_lane > 0 and (W == 1 or cross_warp > 0),
          f"CTC lattice {name}: no skip transition crosses a boundary")
    r = {"nll_rel": nll_rel, "g_excess": g_excess,
         "nll_err": (nll - nll_w).abs().max().item(),
         "g_err": (grad - grad_w).abs().max().item()}
    log(f"[ctc] {name} B={B} T={T} S={S} lengths {inl.tolist()} labels "
        f"{lab.tolist()}: nll max |kernel - plain| = {r['nll_err']:.3g} "
        f"(relative {nll_rel:.3g}, limit {CTC_NLL_RTOL:g}); grad max "
        f"|kernel - plain| = {r['g_err']:.3g} (limit rtol {CTC_GRAD_RTOL:g} "
        f"/ atol {CTC_GRAD_ATOL:g}, excess {g_excess:.3g}); grad past the "
        f"input lengths sums to {past}; a second launch of each kernel "
        f"gives {'the same' if same else 'OTHER'} bytes")
    check(nll_rel <= CTC_NLL_RTOL, f"CTC lattice {name} nll: {nll_rel}")
    check(g_excess <= 0.0, f"CTC lattice {name} grad: {r['g_err']}")
    check(past == 0.0, f"CTC lattice {name}: grad not 0 past the length")
    check(same, f"CTC lattice {name}: two launches give other bytes")
    return dict(r, nll=nll, alpha=alpha, grad=grad, nll_w=nll_w,
                grad_w=grad_w)


def ctc_fault(name: str, c: dict, g, got: dict):
    """Planted fault: the plain versions with one skip flag cleared (a
    label of the longest sample may no longer follow the label before it
    without a blank between); read against the plain version as the kernel
    is, it must break both limits that the kernel meets."""
    from lipreading_tpu_torch.ops import ctc

    lp, skip, inl, lab = c["lp_ext"], c["skip"], c["inl"], c["lab"]
    b = int(lab.argmax())
    s = int(lab[b]) | 1                       # a label state in the middle
    if not bool(skip[b, s]):
        s += 2
    check(bool(skip[b, s]), f"CTC fault {name}: no skip flag to clear")
    bad = skip.clone()
    bad[b, s] = False
    nll_f, alpha_f = ctc.ctc_lattice_fwd_reference(lp, bad, inl, lab)
    grad_f = ctc.ctc_lattice_bwd_reference(lp, bad, inl, lab, alpha_f,
                                           nll_f, g)
    f_rel, f_excess = ctc_readings(nll_f, grad_f, got["nll_w"],
                                   got["grad_w"])
    log(f"[ctc] {name} planted fault (sample {b}'s skip flag at state {s} "
        f"cleared, plain versions): nll relative {f_rel:.3g} (kernel "
        f"{got['nll_rel']:.3g}, limit {CTC_NLL_RTOL:g}), grad excess "
        f"{f_excess:.3g} (kernel {got['g_excess']:.3g}, limit 0)")
    check(f_rel > CTC_NLL_RTOL and f_excess > 0.0,
          f"CTC fault {name} is within the limits: {f_rel}, {f_excess}")


def ctc_bare(c: dict, alpha, nll, g, plan=None) -> dict:
    """Each CTC lattice kernel's C entry as a bare ctypes launch on
    preallocated outputs (no checks, no conversion, no allocation), under
    ``plan`` (W, K), by default ``lattice_plan``'s."""
    import torch

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import ctc

    lib = kernels.lib()
    lp, inl, lab = c["lp_ext"], c["inl"], c["lab"]
    B, T, S = lp.shape
    sk = c["skip"].view(torch.uint8)
    a_out, n_out, g_out = (torch.empty_like(x) for x in (alpha, nll, lp))
    ins = [x.data_ptr() for x in (lp, sk, inl, lab)]
    geo = (B, T, S, *(plan or ctc.lattice_plan(S)),
           kernels.stream_ptr(lp.device))
    return {
        "fwd": lambda: lib.ctc_lattice_fwd(*ins, a_out.data_ptr(),
                                           n_out.data_ptr(), *geo),
        "bwd": lambda: lib.ctc_lattice_bwd(*ins, alpha.data_ptr(),
                                           nll.data_ptr(), g.data_ptr(),
                                           g_out.data_ptr(), *geo),
        "_keep": (a_out, n_out, g_out, sk),
    }


def chain_step_ms() -> dict:
    """Device ms of one step of each recursion's critical path, one warp
    (``ctc_chain_probe``): two step counts timed, their difference in time
    over their difference in steps (the launch cancels out)."""
    import torch

    from lipreading_tpu_torch import kernels

    lib = kernels.lib()
    out = torch.empty(32, device="cuda")
    st = kernels.stream_ptr(out.device)
    n1, n2 = CHAIN_PROBE_STEPS
    res = {}
    for name, bwd in (("fwd", 0), ("bwd", 1)):
        kernels.check(lib.ctc_chain_probe(out.data_ptr(), n1, bwd, st),
                      "ctc_chain_probe")
        t1, t2 = (time_ms(lambda n=n: lib.ctc_chain_probe(
            out.data_ptr(), n, bwd, st), 10) for n in (n1, n2))
        res[name] = (t2 - t1) / (n2 - n1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "chain probe: non-finite")
    return res


def ctc_work(c: dict) -> dict:
    """What this run's data needs of each kernel: (bytes, operations,
    dependent steps). Rows t < input length of lp_ext (and of alpha, for
    the backward) are read, every row of alpha and of the gradient is
    written; one logaddexp is 6 operations (max, sub, abs, exp, log1p,
    add); the longest sample takes max(n) - 1 dependent steps."""
    import torch

    lp, skip, inl = c["lp_ext"], c["skip"], c["inl"]
    B, T, S = lp.shape
    n = torch.clamp(inl, 0, T)
    rows_f = int(torch.clamp(n, min=1).sum().item())
    rows_b = int(n.sum().item())
    steps = int(torch.clamp(n - 1, min=0).sum().item())
    skip_steps = int((torch.clamp(n - 1, min=0) * skip.sum(1)).sum().item())
    small = B * S + 2 * B * 4                   # skip flags and lengths
    chain = max(int(n.max().item()) - 1, 0)
    return {
        "fwd": (rows_f * S * 4 + small + B * T * S * 4 + B * 4,
                steps * S * 7 + skip_steps * 6, chain),
        "bwd": (steps * S * 4 + rows_b * S * 4 + small + 2 * B * 4
                + B * T * S * 4, rows_b * S * (3 + 12 + 5), chain),
    }


def ctc_times(name: str, c: dict, g, got: dict, chain: dict,
              iters: int, plain_iters: int) -> dict:
    """Device ms of each kernel (CUDA events around its bare C entry) and
    of F.ctc_loss (torch.profiler's device time), the wrappers' and the
    plain versions' ms, and the bounds: bytes, operations and the chain of
    dependent steps, the largest named."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import ctc

    lp, skip, inl, lab = c["lp_ext"], c["skip"], c["inl"], c["lab"]
    alpha, nll = got["alpha"], got["nll"]
    bare = ctc_bare(c, alpha, nll, g)
    dev, prof = {}, {}
    for k in ("fwd", "bwd"):
        kernels.check(bare[k](), f"bare ctc_lattice_{k}")
        dev[k] = time_ms(bare[k], iters)
        prof[k] = device_ms(bare[k], iters)[0]
    wrap = {"fwd": time_ms(lambda: ctc.ctc_lattice_fwd(lp, skip, inl, lab),
                           iters),
            "bwd": time_ms(lambda: ctc.ctc_lattice_bwd(
                lp, skip, inl, lab, alpha, nll, g), iters)}
    plain = {"fwd": time_ms(lambda: ctc.ctc_lattice_fwd_reference(
                 lp, skip, inl, lab), plain_iters),
             "bwd": time_ms(lambda: ctc.ctc_lattice_bwd_reference(
                 lp, skip, inl, lab, alpha, nll, g), plain_iters)}

    # yardstick: F.ctc_loss on the same log-probs (its own alpha and beta)
    logp = torch.log_softmax(c["logits"], dim=-1).transpose(0, 1).contiguous()
    logp_g = logp.clone().requires_grad_()
    targets, inl64, lab64 = c["labels"].long(), inl.long(), lab.long()

    def lib_fwd():
        with torch.no_grad():
            F.ctc_loss(logp, targets, inl64, lab64, reduction="none")

    def lib_fwd_bwd():
        logp_g.grad = None
        F.ctc_loss(logp_g, targets, inl64, lab64,
                   reduction="none").sum().backward()

    lib_nll = F.ctc_loss(logp, targets, inl64, lab64, reduction="none")
    lib = {"fwd": device_ms(lib_fwd, iters)[0],
           "bwd": device_ms(lib_fwd_bwd, iters)[0]}
    log(f"[ctc] {name} F.ctc_loss vs kernel nll: max |diff| "
        f"{(lib_nll - nll).abs().max().item():.3g} (a yardstick only)")
    out = {}
    for k, (nbytes, ops, steps) in ctc_work(c).items():
        b_ms, b_by = bound_ms(nbytes, ops)
        chain_ms = steps * chain[k]
        top, top_by = max((b_ms, b_by), (chain_ms, "chain"))
        log(f"[ctc] {name} {'forward' if k == 'fwd' else 'backward'}: "
            f"kernel device {dev[k]:.4f} ms (CUDA events around the bare C "
            f"entry; torch.profiler {prof[k]:.4f}, wrapper {wrap[k]:.4f}), "
            f"plain {plain[k]:.4f} ms, F.ctc_loss "
            f"{'forward' if k == 'fwd' else 'forward+backward'} device "
            f"{lib[k]:.4f} ms; bounds: bytes {nbytes / HBM_BYTES_PER_S * 1e6:.4f}"
            f" us ({nbytes} B), operations {ops / FP32_OPS_PER_S * 1e6:.4f} "
            f"us ({ops}), chain {chain_ms:.4f} ms ({steps} steps x "
            f"{chain[k] * 1e3:.4f} us) -> {top_by} bound {top:.4f} ms, the "
            f"kernel at {top / dev[k]:.1%} of it")
        out[k] = dict(ms=dev[k], wrapper_ms=wrap[k], plain_ms=plain[k],
                      library_ms=lib[k], bound_ms=b_ms, bound_by=b_by,
                      chain_bound_ms=chain_ms, profiler_ms=prof[k])
    del bare
    return out


def ctc_plan_sweep(name: str, c: dict, g, got: dict, iters: int) -> None:
    """Each kernel's device time (``torch.profiler``, bare C entry: CUDA
    events would time the host's launches while worker processes render
    clips) under every K the kernels are built for, with as few warps as
    cover S: what ``lattice_plan``'s choice rests on. Every plan must give
    the default plan's bytes."""
    import torch

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import ctc

    S = c["lp_ext"].shape[2]
    chosen = ctc.lattice_plan(S)
    for K in ctc.LATTICE_K:
        plan = (-(-S // (32 * K)), K)
        bare = ctc_bare(c, got["alpha"], got["nll"], g, plan)
        for k in ("fwd", "bwd"):
            kernels.check(bare[k](), f"bare ctc_lattice_{k} plan {plan}")
        a_out, n_out, g_out, _ = bare["_keep"]
        torch.cuda.synchronize()
        same = all(same_bytes(a, b)
                   for a, b in ((a_out, got["alpha"]), (n_out, got["nll"]),
                                (g_out, got["grad"])))
        t = {k: device_ms(bare[k], iters)[0] for k in ("fwd", "bwd")}
        log(f"[ctc] {name} plan {plan[0]} warp(s) of K {K}"
            f"{' (lattice_plan)' if plan == chosen else ''}: forward "
            f"{t['fwd']:.4f} ms, backward {t['bwd']:.4f} ms (device, bare C "
            f"entry, torch.profiler); {'the same' if same else 'OTHER'} bytes "
            "as the default plan")
        check(same, f"CTC lattice {name}: plan {plan} gives other bytes")


def phase_ctc_kernels(cfg) -> list[dict]:
    """Both CTC lattice kernels against their plain versions at the
    training path's shape, the long-clip fine-tuning shape and S values
    whose skip transitions cross lane and warp boundaries; a planted fault;
    two launches' bytes; device times against the bounds (bytes,
    operations, chain) and F.ctc_loss's device time."""
    import torch

    from lipreading_tpu_torch.ops import ctc

    V, L = cfg.model.vocab_size, cfg.data.max_chars
    # the kernels' branch-free log1p: the bits of log1pf on all of [0, 1]
    from lipreading_tpu_torch import kernels

    differ = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.check(kernels.lib().ctc_log1p_check(
        differ.data_ptr(), kernels.stream_ptr(differ.device)),
        "ctc_log1p_check")
    n_differ = int(differ.item())
    log(f"[ctc] log1p01 against log1pf on every float in [0, 1]: {n_differ} "
        f"of {0x3f800001} differ in any bit")
    check(n_differ == 0, f"log1p01 differs from log1pf on {n_differ} floats")
    chain = chain_step_ms()
    log(f"[ctc] chain probe (one warp, {CHAIN_PROBE_STEPS} steps): forward "
        f"step {chain['fwd'] * 1e6:.2f} ns, backward step "
        f"{chain['bwd'] * 1e6:.2f} ns")
    rows = {}
    for name, B, T, Lc, ends, rng_, timed in (
            ("path", CTC_B, CTC_T, L, (CTC_T // 3, CTC_T), None, True),
            ("long", 4, LONG_BUCKET, LONG_MAX_CHARS, (940, 980), (940, 980),
             True),
            *CTC_EDGE_CASES):
        c = ctc_case(V, Lc, B, T, 5 if name == "path" else T + Lc, ends,
                     rng_)
        g = 1.0 / torch.clamp(c["lab"].float(), min=1.0) / B  # mean(nll/len)
        got = ctc_check(name, c, g)
        if name in ("path", "long"):
            ctc_fault(name, c, g, got)
        if name == "path":
            # an input length above T counts as T, in the kernel and in its
            # plain version alike (ROADMAP F2)
            lp, skip, lab = c["lp_ext"], c["skip"], c["lab"]
            inl_over = c["inl"].clone()
            inl_over[1] = T + 7
            nll_o, alpha_o = ctc.ctc_lattice_fwd(lp, skip, inl_over, lab)
            grad_o = ctc.ctc_lattice_bwd(lp, skip, inl_over, lab, alpha_o,
                                         nll_o, g)
            nll_ow, alpha_ow = ctc.ctc_lattice_fwd_reference(lp, skip,
                                                             inl_over, lab)
            grad_ow = ctc.ctc_lattice_bwd_reference(lp, skip, inl_over, lab,
                                                    alpha_ow, nll_ow, g)
            torch.cuda.synchronize()
            o_excess = ctc_readings(nll_o, grad_o, nll_ow, grad_ow)[1]
            o_live = grad_ow[1].abs().sum().item()
            log(f"[ctc] input length {T + 7} > T = {T} on sample 1: grad "
                f"max |kernel - plain| = "
                f"{(grad_o - grad_ow).abs().max().item():.3g} (excess "
                f"{o_excess:.3g}), plain grad of that sample sums to "
                f"{o_live:.3g} in absolute value (0 would be the unclamped "
                "rule)")
            check(o_excess <= 0.0, f"CTC grad with a length above T: "
                  f"{o_excess}")
            check(o_live > 0.0, "the plain backward zeroes a length above T")
        if timed:
            long = name == "long"
            t = ctc_times(name, c, g, got, chain, 10 if long else 50,
                          2 if long else 5)
            ctc_plan_sweep(name, c, g, got, 10 if long else 50)
            if name == "path":
                for k, row in t.items():
                    rows[k] = dict(
                        name=f"ctc_lattice_{k}", route="cuda",
                        source="lipreading_tpu_torch/csrc/ctc_lattice.cu",
                        replaces=CTC_REPLACES[k], launches=0,
                        max_abs_err=got["nll_err" if k == "fwd" else "g_err"],
                        **row)
        del c, got
    return [rows["fwd"], rows["bwd"]]


def flash_inputs(seed: int, B: int, T: int, lengths, dtype,
                 H: int = FLASH_H, Dh: int = FLASH_DH):
    """q, k, v, dO [B, T, H, Dh] ~ N(0, 1) from a seed, cast to ``dtype``,
    and int32 lengths, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (B, T, H, Dh)
    xs = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
          .to("cuda", dtype) for _ in range(4)]
    return (*xs, torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (float64)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def lse_err(got, want, lengths) -> float:
    """rel_err over the rows of samples with a key; the rows of a sample of
    length 0 must be equal (-1e30 on both sides)."""
    import torch

    live = lengths > 0
    if not torch.equal(got[~live], want[~live]):
        return float("inf")
    return rel_err(got[live], want[live])


def flash_all(q, k, v, ln, g, bwd_in=None):
    """Every flash kernel once -> {name: outputs}; the backwards take
    ``bwd_in`` (g gated, delta, lse) when given, else the forward's."""
    from lipreading_tpu_torch.ops import flash_attention as fa

    out = fa.flash_fwd(q, k, v, ln)
    out_l, lse_f = fa.flash_fwd(q, k, v, ln, return_lse=True)
    gg, delta, lse = bwd_in or (*fa.bwd_inputs(out_l, g, ln), lse_f)
    return {"fwd": (out,), "fwd_lse": (out_l, lse_f),
            "fused": fa.flash_bwd_fused(q, k, v, ln, gg, delta, lse),
            "dq": (fa.flash_bwd_dq(q, k, v, ln, gg, delta, lse),),
            "dkv": fa.flash_bwd_dkv(q, k, v, ln, gg, delta, lse),
            "_bwd_in": (gg, delta, lse)}


def flash_errors(got: dict, q, k, v, ln) -> dict:
    """Each kernel's output against its plain version on the same inputs:
    {kernel: (relative error, max abs error)}."""
    from lipreading_tpu_torch.ops import flash_attention as fa

    want, lse_w = fa.flash_fwd_reference(q, k, v, ln, return_lse=True)
    gg, delta, lse = got["_bwd_in"]
    dq_w, dk_w, dv_w = fa.flash_bwd_fused_reference(q, k, v, ln, gg, delta,
                                                    lse)
    pairs = {"fwd": [(got["fwd"][0], want)],
             "fwd_lse": [(got["fwd_lse"][0], want)],
             "fused": list(zip(got["fused"], (dq_w, dk_w, dv_w))),
             "dq": [(got["dq"][0], dq_w)],
             "dkv": list(zip(got["dkv"], (dk_w, dv_w)))}
    errs = {}
    for name, ps in pairs.items():
        errs[name] = (max(rel_err(a, b) for a, b in ps),
                      max(float((a.double() - b.double()).abs().max())
                          for a, b in ps))
    errs["fwd_lse"] = (max(errs["fwd_lse"][0],
                           lse_err(got["fwd_lse"][1], lse_w, ln)),
                       errs["fwd_lse"][1])
    return errs


def flash_work(name: str, B: int, T: int, lengths, elt: int):
    """(FLOPs, bytes) of a flash kernel at the path's H and Dh. The FLOPs
    are units x H Dh T sum(lengths) (queries all T rows, keys the valid
    ones: the kernels skip key tiles past the length), in units of B H T^2
    Dh: 4 forward, 10 fused backward, 6 dq and 8 dk/dv (14 two-pass); the
    bytes read each input once and write each output once."""
    units = {"fwd": 4, "fused": 10, "dq": 6, "dkv": 8}[name]
    flops = units * FLASH_H * FLASH_DH * T * float(sum(lengths))
    x = B * T * FLASH_H * FLASH_DH * elt        # one [B, T, H, Dh] tensor
    rows = B * FLASH_H * T * 4                   # one float32 row vector
    nbytes = {"fwd": 4 * x, "fused": 7 * x + 2 * rows, "dq": 5 * x + 2 * rows,
              "dkv": 6 * x + 2 * rows}[name] + B * 4
    return flops, nbytes


def flash_bound(name: str, B: int, T: int, lengths, elt: int):
    """(ms, bound_by) of a flash kernel at these shapes: its FLOPs over the
    card's dense bf16 peak against its bytes over 3.35 TB/s."""
    from lipreading_tpu_torch.flops import device_peak_flops

    flops, nbytes = flash_work(name, B, T, lengths, elt)
    t_ops = flops / device_peak_flops("bfloat16") * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bare(q, k, v, ln, gg, delta, lse) -> dict:
    """Each flash kernel's C entry as a bare ctypes launch on preallocated
    outputs (no checks, no allocation, no Python wrapper): what the card
    spends on the kernel itself. The fused entry's dq workspace is zeroed
    once, not before each launch: its values do not change the work."""
    import math

    import torch

    from lipreading_tpu_torch import kernels

    lib = kernels.lib()
    B, T, H, Dh = q.shape
    geo = (B, T, H, Dh, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(Dh),
           kernels.stream_ptr(q.device))
    out = torch.empty_like(q)
    ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ins = [x.data_ptr() for x in (q, k, v, ln, gg, delta, lse)]
    o, w, gq, gk, gv = (x.data_ptr() for x in (out, ws, dq, dk, dv))
    return {
        "fwd": lambda: lib.flash_fwd(*ins[:4], o, None, *geo),
        "fused": lambda: lib.flash_bwd_fused(*ins, w, gq, gk, gv, *geo),
        "dq": lambda: lib.flash_bwd_dq(*ins, gq, *geo),
        "dkv": lambda: lib.flash_bwd_dkv(*ins, gk, gv, *geo),
        "_keep": (out, ws, dq, dk, dv),   # the outputs live while timed
    }


def sdpa_device_ms(q, k, v, g, ln, iters: int) -> dict:
    """SDPA with the boolean key mask on the same inputs, by device time
    (``device_ms``): the forward alone (no grad), and the training forward
    + backward with the backward's kernels apart (those the forward with
    grad does not launch, or launches for less time) -> {"fwd", "fwd_bwd",
    "bwd": ms, "bwd_kernels": {name: ms}}."""
    import torch
    import torch.nn.functional as F

    T = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, T, Dh]
    mask = (torch.arange(T, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    gt = g.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def fwd_grad():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask)

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(gt)

    f = device_ms(fwd, iters)[0]
    fg, split_f = device_ms(fwd_grad, iters)
    fb, split_fb = device_ms(fwd_bwd, iters)
    bwd = {n: t - split_f.get(n, 0.0) for n, t in split_fb.items()
           if t - split_f.get(n, 0.0) > 1e-4}
    return {"fwd": f, "fwd_bwd": fb, "bwd": fb - fg, "bwd_kernels": bwd}


def phase_flash_kernels() -> list[dict]:
    """The four flash kernels against their plain versions at the path's
    shape and at a long one, in bf16 and float32, each limit checked against
    the card's reading and a planted fault (the key mask one short), the
    two-pass pair's bytes equal over two launches; device times, bounds and
    SDPA's device time as the yardstick; the auto policy's readings (xla,
    fused and pallas, forward plus backward)."""
    import torch

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import flash_attention as fa

    rows = {}
    for case, B, T, H, Dh, lengths, timed in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            q, k, v, g, ln = flash_inputs(T + B, B, T, lengths, dtype, H, Dh)
            got = flash_all(q, k, v, ln, g)
            torch.cuda.synchronize()
            errs = flash_errors(got, q, k, v, ln)
            # planted fault: each sample's last valid key masked off
            bad = flash_all(q, k, v, torch.clamp(ln - 1, min=0), g,
                            got["_bwd_in"])
            bad_errs = flash_errors(bad, q, k, v, ln)
            lim = FLASH_LIMITS[dname]
            zero = [b for b, n in enumerate(lengths) if n == 0]
            for name, (e, e_abs) in errs.items():
                log(f"[flash] {case} B={B} T={T} H={H} Dh={Dh} "
                    f"{dname} lengths {list(lengths)}: {name} max|kernel - "
                    f"plain| / max|plain| = {e:.3g} (abs {e_abs:.3g}), limit "
                    f"{lim:g}, planted fault {bad_errs[name][0]:.3g}")
            for name, (e, e_abs) in errs.items():
                check(e <= lim, f"flash {name} {case} {dname}: {e} > {lim}")
                check(bad_errs[name][0] > lim,
                      f"flash {name} {case} {dname}: the planted fault's "
                      f"{bad_errs[name][0]} is within the limit {lim}")
            outs = [x for key, xs in got.items() if key != "_bwd_in"
                    for x in xs[:1 if key == "fwd_lse" else None]]
            for x in outs:
                check(bool(torch.isfinite(x.float()).all()),
                      f"flash {case} {dname}: non-finite output")
                for b in zero:
                    check(x[b].abs().max().item() == 0.0,
                          f"flash {case} {dname}: length 0 is not 0")
            # the two-pass pair writes without atomics: the same bytes again
            again = (fa.flash_bwd_dq(q, k, v, ln, *got["_bwd_in"]),
                     *fa.flash_bwd_dkv(q, k, v, ln, *got["_bwd_in"]))
            same = all(same_bytes(a, b)
                       for a, b in zip((*got["dq"], *got["dkv"]), again))
            log(f"[flash] {case} {dname}: dq, dk, dv of a second launch of "
                f"the two-pass pair {'equal' if same else 'DIFFER from'} the "
                "first, byte for byte")
            check(same, f"flash two-pass {case} {dname}: not reproducible")
            del again
            if dtype != torch.bfloat16 or not timed:
                continue
            iters = 20 if T <= 1024 else 3
            gg, delta, lse = got["_bwd_in"]
            bare = flash_bare(q, k, v, ln, gg, delta, lse)
            dev_ms = {}
            for n in ("fwd", "fused", "dq", "dkv"):
                kernels.check(bare[n](), f"bare {n}")
                dev_ms[n] = time_ms(bare[n], 50 if T <= 1024 else 10)
            ms = {
                "fwd": time_ms(lambda: fa.flash_fwd(q, k, v, ln), iters),
                "fused": time_ms(lambda: fa.flash_bwd_fused(
                    q, k, v, ln, gg, delta, lse), iters),
                "dq": time_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, ln, gg, delta, lse), iters),
                "dkv": time_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, ln, gg, delta, lse), iters),
            }
            plain_fwd = time_ms(lambda: fa.flash_fwd_reference(q, k, v, ln),
                                max(2, iters // 5))
            plain_bwd = time_ms(lambda: fa.flash_bwd_fused_reference(
                q, k, v, ln, gg, delta, lse), max(2, iters // 5))
            # SDPA with the boolean key mask, by device time
            sd = sdpa_device_ms(q, k, v, g, ln, iters)
            log(f"[flash] {case} bf16 SDPA device time (torch.profiler): "
                f"forward {sd['fwd']:.4f} ms, forward+backward "
                f"{sd['fwd_bwd']:.4f} ms, of which backward {sd['bwd']:.4f} "
                "ms in " + "; ".join(f"{n[:80]} {t:.4f}" for n, t in
                                     sd["bwd_kernels"].items()))
            elt = q.element_size()
            for name in ("fwd", "fused", "dq", "dkv"):
                b_ms, b_by = flash_bound(name, B, T, lengths, elt)
                flops = flash_work(name, B, T, lengths, elt)[0]
                plain = plain_fwd if name == "fwd" else plain_bwd
                lib = sd["fwd"] if name == "fwd" else sd["fwd_bwd"]
                old = CUDA_CORE_PAIR_MS.get((name, T))
                log(f"[flash] {case} bf16 {name}: kernel device "
                    f"{dev_ms[name]:.4f} ms ({flops / dev_ms[name] / 1e9:.1f} "
                    f"TFLOP/s, {b_ms / dev_ms[name]:.1%} of the bound"
                    + (f"; CUDA-core version {old:.4f} ms, "
                       f"{old / dev_ms[name]:.1f}x" if old else "")
                    + f"), wrapper {ms[name]:.4f} ms, plain {plain:.4f} ms, "
                    f"SDPA {'forward' if name == 'fwd' else 'forward+backward'}"
                    f" device {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
                if case == "path":
                    err = max(errs[name][1], errs["fwd_lse"][1]) \
                        if name == "fwd" else errs[name][1]
                    rows[name] = dict(
                        name=FLASH_ROW[name], route="cuda",
                        source=FLASH_SOURCE[name],
                        replaces=FLASH_REPLACES[name], launches=0,
                        max_abs_err=err, ms=dev_ms[name], plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        wrapper_ms=ms[name])
            del bare
            del q, k, v, g, got, bad
            torch.cuda.empty_cache()

    # the auto policy: forward + backward under xla, fused and pallas
    line = []
    for T in FLASH_AUTO_T:
        q, k, v, g, ln = flash_inputs(T, 2, T, (T, 3 * T // 4), torch.bfloat16)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        t = {}
        for bwd in ("xla", "fused", "pallas"):
            def step():
                for x in leaves:
                    x.grad = None
                fa.flash_attention(*leaves, ln, bwd=bwd).backward(g)
            t[bwd] = time_ms(step, 10 if T <= 2048 else 3)
        line.append(f"T={T} xla {t['xla']:.4f} fused {t['fused']:.4f} "
                    f"pallas {t['pallas']:.4f}")
        del q, k, v, g, leaves
        torch.cuda.empty_cache()
    log(f"[flash] auto policy, B=2 H={FLASH_H} Dh={FLASH_DH} bf16, lengths "
        f"(T, 3T/4), forward+backward ms: " + "; ".join(line)
        + f" (auto takes fused from T={fa.AUTO_FUSED_MIN_T})")
    return [rows[n] for n in ("fwd", "fused", "dq", "dkv")]


def dgrad_inputs(B, T, H, W, kernel, cin, cout, seed: int):
    """bf16 dY [B, T, H, W, Cout] and w [*kernel, Cin, Cout] (He-scaled) on
    the card, from a seed."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    dy = torch.randn((B, T, H, W, cout), generator=g)
    fan = kernel[0] * kernel[1] * kernel[2] * cin
    w = torch.randn((*kernel, cin, cout), generator=g) * (2.0 / fan) ** 0.5
    return (dy.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).cuda())


def dgrad_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def conv_dgrad_function(name, H, kernel, cin, cout) -> dict:
    """nn.conv3d on a bf16 input that needs a gradient (the kernel's path)
    against autograd through the same cuDNN convolution (the old path):
    forward and weight gradient the same bytes; the input gradients, each
    against the plain version, and the routing counter."""
    import torch

    from lipreading_tpu_torch import profiling
    from lipreading_tpu_torch.models import nn as lnn

    B, T = 8, DGRAD_T
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn((B, T, H, H, cin), generator=g).to(torch.bfloat16).cuda()
    w = (torch.randn((*kernel, cin, cout), generator=g) * 0.05).cuda()
    b = (torch.randn((cout,), generator=g) * 0.1).cuda()
    gy = torch.randn((B, T, H, H, cout), generator=g).to(
        torch.bfloat16).cuda()
    out = {}
    for path in ("old", "new"):
        xr = x.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        before = profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
        launches = lnn.conv3d_dgrad.launches
        with profiling.unit("smoke.conv", "cuda"):
            if path == "old":
                y = lnn._conv(xr, wr.to(torch.bfloat16), (1, 1, 1))[0] + b.to(
                    torch.bfloat16)
            else:
                y = lnn.conv3d(xr, wr, b, (1, 1, 1), torch.bfloat16)
        dx, dw = torch.autograd.grad(y, (xr, wr), gy)
        torch.cuda.synchronize()
        counted = (profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
                   - before)
        out[path] = (y, dx, dw, counted, lnn.conv3d_dgrad.launches - launches)
    plain = lnn.conv3d_dgrad_plain(gy, w.to(torch.bfloat16))
    same_y = torch.equal(out["old"][0], out["new"][0])
    same_dw = torch.equal(out["old"][2], out["new"][2])
    e_new, e_old = dgrad_err(out["new"][1], plain), dgrad_err(out["old"][1],
                                                              plain)
    log(f"[conv-dgrad] {name} nn.conv3d (B {B}): forward the same bytes "
        f"{same_y}, weight gradient the same bytes {same_dw}; input gradient "
        f"vs plain {e_new:.3g} (kernel) and {e_old:.3g} (cuDNN, the old "
        f"path); counter conv3d.dgrad {out['new'][3]} / {out['old'][3]} "
        f"(new / old), launches {out['new'][4]} / {out['old'][4]}")
    check(same_y and same_dw, f"[conv-dgrad] {name}: the forward or the "
          "weight gradient differs from the old path's")
    check(e_new <= DGRAD_LIMIT, f"[conv-dgrad] {name}: input gradient "
          f"{e_new} > {DGRAD_LIMIT}")
    check(out["new"][3:] == (1, 1) and out["old"][3:] == (0, 0),
          f"[conv-dgrad] {name}: counted / launched {out['new'][3:]} new, "
          f"{out['old'][3:]} old; want (1, 1) and (0, 0)")
    # no gradient, stride 2, float32: the old path, nothing counted
    before = profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
    launches = lnn.conv3d_dgrad.launches
    with profiling.unit("smoke.conv", "cuda"):
        xr = x.clone().requires_grad_()
        with torch.no_grad():
            lnn.conv3d(xr, w, b, (1, 1, 1), torch.bfloat16)
        lnn.conv3d(xr, w, b, (1, 2, 2), torch.bfloat16).float().sum().backward()
        lnn.conv3d(xr.float().detach().requires_grad_(), w, b,
                   (1, 1, 1)).sum().backward()
    torch.cuda.synchronize()
    other = (profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
             - before, lnn.conv3d_dgrad.launches - launches)
    check(other == (0, 0), f"[conv-dgrad] {name}: no-grad, stride-2 or "
          f"float32 calls counted / launched {other}")
    return {"same_forward": same_y, "same_wgrad": same_dw,
            "err_kernel": e_new, "err_cudnn": e_old}


def dgrad_library_forms(dy, w, xc, plain) -> dict:
    """cuDNN's data gradient in the forms the old path did not hand it:
    ``forward``, a forward convolution of dY (pads (k - 1) / 2, the stems'
    odd kernels) with the weight flipped over its taps and transposed, all
    in channels_last_3d; ``backward_cl`` and ``backward_ncdhw``,
    ``aten.convolution_backward`` with [True, False, False] on dY, the
    padded input and the weight all made contiguous in channels_last_3d or
    in NCDHW -> {form: (ms a call with the layout copies inside, CUDA
    events over 20 calls; |form - plain| as ``dgrad_err``; its top 3
    device operations, torch.profiler's)}."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch.models import nn as lnn

    cl = torch.channels_last_3d
    k = tuple(w.shape[:3])
    T, H, W = dy.shape[1:4]
    dyc = dy.permute(0, 4, 1, 2, 3)
    wp = w.permute(4, 3, 0, 1, 2)
    pad = tuple((kk - 1) // 2 for kk in k)
    pads = [p for n, kk in zip((W, H, T), k[::-1])
            for p in lnn._same_pads(n, kk, 1)]

    def forward():
        wf = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous(
            memory_format=cl)
        return F.conv3d(dyc.contiguous(memory_format=cl), wf, padding=pad)

    def backward(fmt):
        def run():
            return torch.ops.aten.convolution_backward(
                dyc.contiguous(memory_format=fmt),
                xc.contiguous(memory_format=fmt),
                wp.contiguous(memory_format=fmt), None, [1, 1, 1], [0, 0, 0],
                [1, 1, 1], False, [0, 0, 0], 1, [True, False, False])[0]
        return run

    def crop(dxc):
        return dxc[:, :, pads[4]:pads[4] + T, pads[2]:pads[2] + H,
                   pads[0]:pads[0] + W]

    forms = {"forward": (forward, lambda d: d),
             "backward_cl": (backward(cl), crop),
             "backward_ncdhw": (backward(torch.contiguous_format), crop)}
    out = {}
    for form, (fn, view) in forms.items():
        err = dgrad_err(view(fn()).permute(0, 2, 3, 4, 1), plain)
        # as for ``library`` in phase_conv_dgrad; once for cuDNN's grouped
        # fallback (~2 s a call)
        _, split = device_ms(fn, 2)
        f_ms = time_ms(fn, 1 if max(split.values()) > 100 else 20)
        top = sorted(split.items(), key=lambda kv: -kv[1])[:3]
        out[form] = (f_ms, err, top)
    return out


def phase_conv_dgrad() -> list[dict]:
    """[conv-dgrad]: ``models/nn.conv3d_dgrad`` (the Hopper kernel) against
    its plain version at odd shapes and at the stem and trunk shapes of
    the training cells (``DGRAD_SHAPES``), a planted fault (the weight left
    unflipped) at each, two launches byte for byte; its device time (CUDA events around the
    bare C entry), the wrapper's, the plain version's and cuDNN's dgrad
    (``aten.convolution_backward`` with [True, False, False] on the
    layouts the old path handed it: CUDA events, torch.profiler naming
    cuDNN's kernel) and cuDNN's other forms (``dgrad_library_forms``)
    beside the bf16 FLOP bound; the nn.conv3d path
    (``conv_dgrad_function``)."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.models import nn as lnn

    t_phase = time.perf_counter()
    for i, (B, T, H, W, k, cin, cout) in enumerate(DGRAD_ODD):
        dy, w = dgrad_inputs(B, T, H, W, k, cin, cout, 100 + i)
        err = dgrad_err(lnn.conv3d_dgrad(dy, w), lnn.conv3d_dgrad_plain(dy, w))
        torch.cuda.synchronize()
        log(f"[conv-dgrad] B {B} T {T} H {H} W {W} kernel {k} {cin} <- "
            f"{cout}: kernel vs plain {err:.3g} (limit {DGRAD_LIMIT})")
        check(err <= DGRAD_LIMIT, f"[conv-dgrad] odd shape {i}: {err}")
    out = {}
    for j, (name, B, T, H, k, cin, cout) in enumerate(DGRAD_SHAPES):
        dy, w = dgrad_inputs(B, T, H, H, k, cin, cout, 200 + j)
        before = lnn.conv3d_dgrad.launches
        got = lnn.conv3d_dgrad(dy, w)
        launches = lnn.conv3d_dgrad.launches - before
        again = lnn.conv3d_dgrad(dy, w)
        plain = lnn.conv3d_dgrad_plain(dy, w)
        fault = lnn.conv3d_dgrad(dy, w.flip(0, 1, 2))
        torch.cuda.synchronize()
        err, err_fault = dgrad_err(got, plain), dgrad_err(fault, plain)
        same = torch.equal(got, again)
        del again, fault
        # the bare C entry, as the wrapper calls it
        wt, q = lnn._dgrad_operands(w, (T, H, H))
        wt = wt.contiguous()
        dx = torch.empty_like(got)
        stream = kernels.stream_ptr(dy.device)
        lib = kernels.lib()

        def bare():
            return lib.conv3d_dgrad(dy.data_ptr(), wt.data_ptr(),
                                    dx.data_ptr(), B, T, H, H, cin, cout,
                                    *k, *q, stream)

        kernels.check(bare(), "conv3d_dgrad")
        ms = time_ms(bare, 20)
        wrapper_ms = time_ms(lambda: lnn.conv3d_dgrad(dy, w), 20)
        plain_ms = time_ms(lambda: lnn.conv3d_dgrad_plain(dy, w), 2)
        # cuDNN's dgrad on the old path's layouts (the padded NCDHW input
        # that F.pad leaves, dY and w as permuted views)
        pads = []
        for axis, kk in zip((H, H, T), k[::-1]):
            pads.extend(lnn._same_pads(axis, kk, 1))
        xc = F.pad(torch.zeros((B, T, H, H, cin), dtype=torch.bfloat16,
                               device="cuda").permute(0, 4, 1, 2, 3), pads)
        dyc, wp = dy.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)

        def library():
            return torch.ops.aten.convolution_backward(
                dyc, xc, wp, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, [True, False, False])[0]

        lib_dx = library()[:, :, pads[4]:pads[4] + T, pads[2]:pads[2] + H,
                           pads[0]:pads[0] + H].permute(0, 2, 3, 4, 1)
        err_lib = dgrad_err(lib_dx, plain)
        del lib_dx
        # the profile names cuDNN's kernels, CUDA events time them (a
        # profile can lose the first call's kernels and read half)
        _, split = device_ms(library, 2)
        library_ms = time_ms(library, 1 if max(split.values()) > 100 else 20)
        alt = dgrad_library_forms(dy, w, xc, plain)
        del xc, plain
        taps = k[0] * k[1] * k[2]
        M = B * T * H * H
        ops = 2.0 * M * cin * taps * cout
        nbytes = 2.0 * (M * cout + M * cin + taps * cin * cout)
        t_ops, t_bytes = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound, by = max((t_ops, "operations"), (t_bytes, "bytes"))
        top = sorted(split.items(), key=lambda kv: -kv[1])[:3]
        log(f"[conv-dgrad] {name} (B {B} T {T} {H}x{H}, kernel {k}, {cin} <- "
            f"{cout}): kernel vs plain {err:.3g}, planted fault (weight "
            f"unflipped) {err_fault:.3g}, limit {DGRAD_LIMIT}; cuDNN vs "
            f"plain {err_lib:.3g}; two launches the same bytes {same}; "
            f"{launches} launch a call")
        log(f"[conv-dgrad] {name}: kernel device {ms:.4f} ms (CUDA events "
            f"around the bare C entry; wrapper {wrapper_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, cuDNN dgrad {library_ms:.4f} ms (events) "
            f"({'; '.join(f'{n[:72]} {v:.4f}' for n, v in top)}); bound "
            f"{bound:.4f} ms ({by}: {ops / 1e12:.4f} TFLOP at 989 TFLOP/s, "
            f"{nbytes / 1e9:.4f} GB at 3.35 TB/s) -> the kernel at "
            f"{bound / ms:.1%} of it, {ops / ms / 1e9:.1f} TFLOP/s, "
            f"{library_ms / ms:.2f}x cuDNN's speed")
        check(err <= DGRAD_LIMIT < err_fault, f"[conv-dgrad] {name}: kernel "
              f"{err}, fault {err_fault}, limit {DGRAD_LIMIT}")
        check(same and launches == 1, f"[conv-dgrad] {name}: same bytes "
              f"{same}, launches {launches}")
        for form, (a_ms, a_err, a_top) in alt.items():
            log(f"[conv-dgrad] {name}: cuDNN {form} {a_ms:.4f} ms (CUDA "
                f"events; {a_ms / ms:.2f}x the kernel's time; vs plain "
                f"{a_err:.3g}; "
                f"{'; '.join(f'{n[:72]} {v:.4f}' for n, v in a_top)})")
        out[name] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound, bound_by=by,
                         err=err, err_fault=err_fault, err_cudnn=err_lib,
                         cudnn_kernels=[n for n, _ in top],
                         library_forms={f: v[0] for f, v in alt.items()})
        del dy, w, got, dx, wt
        torch.cuda.empty_cache()
    fn = {name: conv_dgrad_function(name, H, k, cin, cout)
          for name, _, _, H, k, cin, cout in DGRAD_SHAPES}
    log(f"[conv-dgrad] phase {time.perf_counter() - t_phase:.1f} s")
    return [dict(name="conv3d_dgrad", route="cuda",
                 source="lipreading_tpu_torch/csrc/conv3d_dgrad.cu",
                 replaces=None, launches=None,     # [train]'s, a step's 2
                 max_abs_err=max(v["err"] for v in out.values()),
                 ms=out["conv1"]["ms"], plain_ms=out["conv1"]["plain_ms"],
                 bound_ms=out["conv1"]["bound_ms"],
                 bound_by=out["conv1"]["bound_by"],
                 library_ms=out["conv1"]["library_ms"],
                 wrapper_ms=out["conv1"]["wrapper_ms"], shapes=out,
                 function=fn)]


def render_long(i: int):
    """Long fixture clip ``i`` (LONG_TEXTS[i], about 4 frames a character)
    -> (frames [T, H, W, 3] uint8, text). Runs in a worker process."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from lipreading_tpu_torch.fixtures import make_clip

    c = make_clip(LONG_SEED + i, text=LONG_TEXTS[i])
    return c.frames, c.text


def start_long_clips():
    """Render the long clips in worker processes while the card works."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(len(LONG_TEXTS),
                                  mp_context=mp.get_context("spawn"))
    return pool, [pool.submit(render_long, i) for i in range(len(LONG_TEXTS))]


def long_clips(futures):
    """The rendered long clips, zero-padded to LONG_BUCKET -> (frames
    [B, T, H, W, 3] u8, lengths [B], texts)."""
    import numpy as np

    res = [f.result(timeout=600) for f in futures]
    H, W = res[0][0].shape[1:3]
    frames = np.zeros((len(res), LONG_BUCKET, H, W, 3), np.uint8)
    lengths = np.zeros((len(res),), np.int32)
    for b, (f, _) in enumerate(res):
        check(len(f) <= LONG_BUCKET, f"long clip {b}: {len(f)} frames")
        frames[b, :len(f)] = f
        lengths[b] = len(f)
    return frames, lengths, [t for _, t in res]


def reset(wrappers):
    for w in wrappers:
        w.launches = 0


def phase_path_flash(frames, lengths, gpu, long):
    """Serving with model.flash_attention=1: the short clips of [path] and
    the long clips, on the card and on the CPU, one forward kernel launch
    per encoder layer per forward; flash off beside it."""
    import torch

    from lipreading_tpu_torch.infer import greedy_conf
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.ops import flash_attention as fa
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.text import Vocab

    on = load_port("cuda", FLASH_ON)
    cpu_on = load_port("cpu", FLASH_ON)
    layers = on["cfg"].model.tf_layers
    run_path(frames, lengths, on)                   # warm-up
    torch.cuda.synchronize()
    reset(fa.WRAPPERS)
    hyps, _ = run_path(frames, lengths, on)
    n = fa.flash_fwd.launches
    cpu_hyps, _ = run_path(frames, lengths, cpu_on)
    off_hyps, _ = run_path(frames, lengths, gpu)
    log(f"[path-flash] {len(hyps)} short clips x {frames.shape[1]} frames, "
        f"flash on: {n} forward kernel launches ({layers} layers); card vs "
        f"CPU transcripts {'equal' if hyps == cpu_hyps else 'DIFFER'}; flash "
        f"off on the card {'equal' if hyps == off_hyps else 'differs'} "
        f"(reported, not gated: at bf16 the two are different functions)")
    check(n == layers, f"flash_fwd: {n} launches in one forward, want {layers}")
    check(hyps == cpu_hyps, f"flash card {hyps} != CPU {cpu_hyps}")

    lf, ll, lt = long
    vocab = Vocab()

    def texts(ids, cnt):
        ids, cnt = ids.cpu().numpy(), cnt.cpu().numpy()
        return [vocab.decode(ids[b, :cnt[b]]) for b in range(len(cnt))]

    with torch.inference_mode():
        rois = preprocess_clips(gpu["det"], gpu["ert"],
                                torch.as_tensor(lf, device="cuda"),
                                gpu["cfg"].preprocess)
        lens = torch.as_tensor(ll, device="cuda")
        out = {}
        for name, port in (("on", on), ("off", gpu)):
            greedy_conf(port["model"], port["cfg"], rois, lens)   # warm-up
            torch.cuda.synchronize()
            reset(fa.WRAPPERS)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ids, cnt, conf, enc = greedy_conf(port["model"], port["cfg"],
                                              rois, lens)
            torch.cuda.synchronize()
            out[name] = dict(
                texts=texts(ids, cnt), ms=(time.perf_counter() - t0) * 1e3,
                launches=fa.flash_fwd.launches,
                peak=torch.cuda.max_memory_allocated() - base)
            check(bool(torch.isfinite(enc.float()).all()),
                  f"long clips, flash {name}: non-finite encoder states")
        t0 = time.perf_counter()
        cids, ccnt, _, _ = greedy_conf(cpu_on["model"], cpu_on["cfg"],
                                       rois.cpu(), lens.cpu())
        cpu_s = time.perf_counter() - t0
    cpu_texts = texts(cids, ccnt)
    on_t, off_t = out["on"]["texts"], out["off"]["texts"]
    for h, o, t in zip(on_t, off_t, lt):
        log(f"[path-flash]   long: {h[:60]!r}... (flash off "
            f"{'same' if h == o else 'differs'}) ref {t[:40]!r}...")
    log(f"[path-flash] {len(lt)} long clips, lengths {ll.tolist()} padded to "
        f"{LONG_BUCKET}, ROIs from the card: greedy_conf flash on "
        f"{out['on']['ms']:.1f} ms, peak {out['on']['peak'] / 2**20:.1f} MiB "
        f"above the resident state, {out['on']['launches']} forward kernel "
        f"launches; flash off {out['off']['ms']:.1f} ms, peak "
        f"{out['off']['peak'] / 2**20:.1f} MiB (host clock, synchronised); "
        f"CER flash on {corpus_cer(on_t, lt):.4f}, off "
        f"{corpus_cer(off_t, lt):.4f}; card vs CPU ({cpu_s:.1f} s) "
        f"transcripts {'equal' if on_t == cpu_texts else 'DIFFER'}")
    check(out["on"]["launches"] == layers,
          f"long clips: {out['on']['launches']} forward launches")
    check(out["off"]["launches"] == 0, "flash off launched the flash kernel")
    check(on_t == cpu_texts, f"long clips: card {on_t} != CPU {cpu_texts}")
    return {"on": on, "cpu_on": cpu_on, "rois": rois, "lens": lens}


def score_gaps(rows: int) -> list[float]:
    """Best minus second-best selection score of the last beam's first
    ``rows`` samples (``backtrack_best.last_scores``)."""
    import torch

    from lipreading_tpu_torch.ops.decode import backtrack_best

    top2 = torch.topk(backtrack_best.last_scores[:rows], 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def beam_profile(fn) -> dict:
    """One warmed call of ``fn()`` (a beam; it returns its step count) under
    ``torch.profiler`` -> its steps, host ms (perturbed by the profiler),
    device busy ms (every kernel, copy and fill on the one stream), device
    ops, and the host ms spent in the per-step reads of ``finished``
    (``aten::_local_scalar_dense``: the copy to the host and the wait for
    the device). An empty profile is taken again, as in ``device_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if dev:
            return {"steps": steps, "host_ms": host, "ops": len(dev),
                    "device_ms": sum(e.time_range.elapsed_us()
                                     for e in dev) / 1e3,
                    "sync_ms": sum(e.cpu_time_total for e in events
                                   if e.name == "aten::_local_scalar_dense")
                    / 1e3}
        log(f"[profiler] beam profile {attempt} of {PROFILE_ATTEMPTS} "
            "recorded no device time: taken again")
        time.sleep(1.0)
    check(False, f"torch.profiler recorded no device time in "
          f"{PROFILE_ATTEMPTS} beam profiles")


def phase_cascade(frames, lengths, gpu, flash):
    """Cascade decoding on the card: the short clips of [path] through
    preprocess_clips and transcribe_cascade (default margins and
    margin=inf), transcribe with and without the lexicon, each against the
    same calls on the CPU; the cascade against the full beam; the long
    clips of [path-flash] (flash on, T 1024) through the joint beam at
    margin=inf against the CPU from the card's ROIs. Launch counts around
    every call; the legs' times, the beam's steps and score gaps."""
    import torch

    from lipreading_tpu_torch import infer
    from lipreading_tpu_torch.ops import flash_attention as fa
    from lipreading_tpu_torch.ops.ctc import ctc_lattice_bwd, ctc_lattice_fwd
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids, early_exit_scan
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.ops.roi import sample_rois
    from lipreading_tpu_torch.text import Vocab

    t_phase = time.perf_counter()
    lattice = (ctc_lattice_fwd, ctc_lattice_bwd)
    counted = (sample_rois, ctc_greedy_ids) + lattice + tuple(fa.WRAPPERS)
    cpu = load_port("cpu")
    dev = next(gpu["model"].parameters()).device
    B, T = frames.shape[:2]

    def rois_of(port):
        dev = next(port["model"].parameters()).device
        with torch.inference_mode():
            reset(counted)
            rois = preprocess_clips(port["det"], port["ert"],
                                    torch.as_tensor(frames, device=dev),
                                    port["cfg"].preprocess)
        if dev.type == "cuda":
            check(sample_rois.launches == 1,
                  f"preprocess_clips: {sample_rois.launches} ROI launches")
        return rois

    def run(port, rois, lens, call, **kw):
        """One decode call with the counts set to 0 just before it and read
        just after -> (texts, flags or None, seconds, beam steps)."""
        on_card = rois.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        reset(counted)
        steps0 = early_exit_scan.steps
        t0 = time.perf_counter()
        if call == "cascade":
            texts, flags = infer.transcribe_cascade(
                port["model"], port["cfg"], rois, lens, return_flags=True,
                **CASCADE_KW, **kw)
        else:
            texts, flags = infer.transcribe(port["model"], port["cfg"], rois,
                                            lens, **CASCADE_KW, **kw), None
        if on_card:
            torch.cuda.synchronize()
            want = 1 if call == "cascade" else 0
            check(ctc_greedy_ids.launches == want,
                  f"{call} {kw}: {ctc_greedy_ids.launches} greedy launches, "
                  f"want {want}")
            check(all(w.launches == 0 for w in lattice),
                  f"{call} {kw}: a CTC lattice kernel launched")
        return (texts, flags, time.perf_counter() - t0,
                early_exit_scan.steps - steps0)

    rois = rois_of(gpu)
    lens = torch.as_tensor(lengths, device=dev)
    run(gpu, rois, lens, "cascade", margin=float("inf"))     # warm-up
    calls = (("cascade", {}), ("cascade", {"margin": float("inf")}),
             ("transcribe", {}), ("transcribe", {"use_lexicon": True}))
    card = {}
    for call, kw in calls:
        texts, flags, dt, steps = run(gpu, rois, lens, call, **kw)
        card[call, str(kw)] = (texts, flags)
        if kw.get("margin") == float("inf"):
            gaps = score_gaps(B)
        log(f"[cascade] {call} {kw or 'default margins'}: {dt * 1e3:.1f} ms "
            f"host clock ({B * T / dt:.0f} padded frames/s), {steps} beam "
            f"steps" + ("" if flags is None else
                        f", {int(flags.sum())} of {B} clips rescored"))
    full = card["transcribe", "{}"][0]
    for (call, kw), (texts, flags) in card.items():
        if call == "cascade":
            check(texts == full, f"cascade {kw} {texts} != full beam {full}")
    for h, g, t in zip(full, gaps, card["cascade", "{}"][1]):
        log(f"[cascade]   {h!r:32} best - second score {g:.4f}, flagged "
            f"{bool(t)}")

    # the legs, apart: the greedy leg on every clip, the joint beam on the
    # flagged rows of the default run from the greedy leg's encoder output
    flagged = torch.as_tensor(card["cascade", "{}"][1].nonzero()[0],
                              device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, enc = infer.greedy_conf(gpu["model"], gpu["cfg"], rois,
                                         lens.to(torch.int32))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps0 = early_exit_scan.steps
        if len(flagged):
            infer.decode_ids_from_enc(gpu["model"], gpu["cfg"], enc[flagged],
                                      lens[flagged], **CASCADE_KW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    steps = early_exit_scan.steps - steps0
    log(f"[cascade] legs (host clock, synchronised): greedy "
        f"{(t1 - t0) * 1e3:.2f} ms on {B} clips, rescore "
        f"{(t2 - t1) * 1e3:.2f} ms on {len(flagged)} clips, {steps} steps "
        f"before the early exit, "
        + (f"{(t2 - t1) * 1e3 / steps:.2f} ms a step" if steps else
           "no step"))

    def beam_all():
        s0 = early_exit_scan.steps
        infer.decode_ids_from_enc(gpu["model"], gpu["cfg"], enc, lens,
                                  **CASCADE_KW)
        return early_exit_scan.steps - s0

    if dev.type == "cuda":
        with torch.inference_mode():
            pr = beam_profile(beam_all)
        n = max(pr["steps"], 1)
        log(f"[cascade] profile of the joint beam on all {B} clips: "
            f"{pr['steps']} steps, host {pr['host_ms']:.1f} ms under the "
            f"profiler, device busy {pr['device_ms']:.2f} ms (idle "
            f"{100 * (1 - pr['device_ms'] / pr['host_ms']):.1f} %), "
            f"{pr['ops'] / n:.0f} device ops a step, "
            f"{pr['sync_ms']:.2f} ms ({pr['sync_ms'] / n:.3f} a step) in "
            "the per-step reads of finished")

    # the same calls on the CPU, from the frames (plain versions there)
    t0 = time.perf_counter()
    cpu_rois = rois_of(cpu)
    cpu_lens = torch.as_tensor(lengths)
    for call, kw in calls:
        texts, flags, _, _ = run(cpu, cpu_rois, cpu_lens, call, **kw)
        want, want_flags = card[call, str(kw)]
        check(texts == want, f"{call} {kw}: card {want} != CPU {texts}")
        if flags is not None and not kw:
            check((flags == want_flags).all(),
                  f"cascade flags: card {want_flags} != CPU {flags}")
    log(f"[cascade] CPU runs ({time.perf_counter() - t0:.1f} s): transcripts "
        "and flags equal the card's; the cascade equals the full beam")

    # the long clips: flash on, T 1024, every clip through the joint beam
    on, cpu_on = flash["on"], flash["cpu_on"]
    rois_l, lens_l = flash["rois"], flash["lens"]
    Bl, Tl = rois_l.shape[:2]
    layers = on["cfg"].model.tf_layers
    texts, _, dt, steps = run(on, rois_l, lens_l, "cascade",
                              margin=float("inf"))
    check(fa.flash_fwd.launches == layers or rois_l.device.type != "cuda",
          f"long cascade: {fa.flash_fwd.launches} flash forward launches, "
          f"want {layers} (the rescore leg must not encode again)")
    gaps = score_gaps(Bl)
    log(f"[cascade] {Bl} long clips x {Tl} frames, flash on, margin=inf: "
        f"{dt * 1e3:.1f} ms host clock ({Bl * Tl / dt:.0f} padded frames/s), "
        f"{steps} beam steps ({dt * 1e3 / max(steps, 1):.2f} ms a step, the "
        "greedy leg included)")
    # the beam alone on both devices, from one encoder output (the card's),
    # in the rows the cascade decodes (padded to its bucket with the last)
    take = torch.as_tensor(list(range(Bl)) + [Bl - 1] * (-Bl % RESCORE_BUCKET))
    vocab = Vocab()
    with torch.inference_mode():
        enc = infer.greedy_conf(on["model"], on["cfg"], rois_l, lens_l)[3]
        same = {}
        for port in (on, cpu_on):
            d = next(port["model"].parameters()).device
            ids, n = infer.decode_ids_from_enc(
                port["model"], port["cfg"], enc[take.to(enc.device)].to(d),
                lens_l.cpu()[take].to(d), **CASCADE_KW)
            ids, n = ids.cpu().numpy(), n.cpu().numpy()
            same[d.type] = ([vocab.decode(ids[b, :n[b]]) for b in range(Bl)],
                            score_gaps(Bl))
    check(same["cpu"][0] == same[dev.type][0],
          f"long clips, one encoder output: card {same[dev.type][0]} != CPU "
          f"{same['cpu'][0]}")
    # end to end: the CPU's own encoder from the card's ROIs. Card and CPU
    # encoders differ in bf16 rounding (ROADMAP F4), so a clip whose two
    # best hypotheses are a near tie may resolve either way: reported
    t0 = time.perf_counter()
    cpu_texts, _, _, _ = run(cpu_on, rois_l.cpu(), lens_l.cpu(), "cascade",
                             margin=float("inf"))
    cpu_s = time.perf_counter() - t0
    cpu_gaps = score_gaps(Bl)
    for b in range(Bl):
        log(f"[cascade]   long {b}: {texts[b]!r} best - second score "
            f"{gaps[b]:.4f} (CPU from the card's encoder "
            f"{same['cpu'][1][b]:.4f}); CPU end to end "
            + ("equal" if cpu_texts[b] == texts[b] else
               f"DIFFERS: {cpu_texts[b]!r}")
            + f", best - second {cpu_gaps[b]:.4f}")
    n_eq = sum(a == b for a, b in zip(texts, cpu_texts))
    log(f"[cascade] long clips: the beam from the card's encoder output gives "
        f"the same transcripts on the card and the CPU; the card's cascade "
        f"{'equals' if same[dev.type][0] == texts else 'DIFFERS from'} that "
        f"beam; end to end (CPU {cpu_s:.1f} s, its encoder from the card's "
        f"ROIs) {n_eq} of {Bl} clips equal (reported, not gated); phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def tracked_batch(frames, lengths):
    """[tracked]'s input: the serving clips plus make_clip(61) with frames
    4-6 blanked and make_clip(62) with a second face, zero-padded to the
    serving clips' length -> (frames [10, T, H, W, 3] u8, lengths [10])."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import (
        blank_out_frames,
        make_clip,
        paste_second_face,
    )

    extra = [blank_out_frames(make_clip(61), TRACK_GAP, seed=2),
             paste_second_face(make_clip(62), donor_seed=901)]
    B, T = frames.shape[:2]
    out = np.zeros((B + len(extra),) + frames.shape[1:], np.uint8)
    out[:B] = frames
    for k, f in enumerate(extra):
        out[B + k, :len(f)] = f[:T]
    lens = np.concatenate([lengths, [min(len(f), T) for f in extra]])
    return out, lens.astype(np.int32)


def track_readings(card: dict, cpu: dict) -> dict:
    """Max |card - CPU| of the tracked face boxes (px), the landmarks (px)
    and the ROIs (normalised), over every frame."""
    return {k: (card[k].float().cpu() - cpu[k].float()).abs().max().item()
            for k in TRACK_LIMITS}


def tracked_run(srv, frames, mark=None) -> dict:
    """preprocess_clips_tracked (conv landmarker) on the server's device ->
    {rois, valid, face_boxes, landmarks}."""
    import torch

    from lipreading_tpu_torch.ops.preprocess import preprocess_clips_tracked

    with torch.inference_mode():
        rois, valid, aux = preprocess_clips_tracked(
            srv["det"], srv["presence"], srv["lmk"],
            torch.as_tensor(frames, device=srv["device"]),
            srv["cfg"].preprocess, return_aux=True, mark=mark)
    return {"rois": rois, "valid": valid, "face_boxes": aux["face_boxes"],
            "landmarks": aux["landmarks"]}


def phase_tracked(frames, lengths, rows):
    """[tracked]: the serving clips plus the cutaway and second-face clips
    through preprocess_clips_tracked with the conv landmarker, card against
    CPU, the JAX tests' tracking properties on the card, kernel 1 at the
    face-crop shape against its plain version and timed, launch counts and
    the host ms of each stage."""
    import numpy as np
    import torch

    from lipreading_tpu_torch import infer
    from lipreading_tpu_torch.ops import roi
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.landmarker import CROP, round_face_boxes
    from lipreading_tpu_torch.ops.tracking import track_boxes
    from lipreading_tpu_torch.serve import StageClock, load_server

    t_phase = time.perf_counter()
    frames, lens = tracked_batch(frames, lengths)
    B, T, H, W, _ = frames.shape
    gpu, cpu = load_server(device="cuda"), load_server(device="cpu")
    tracked_run(gpu, frames)                                  # warm-up
    torch.cuda.synchronize()
    reset((roi.sample_rois,))
    card = tracked_run(gpu, frames)
    torch.cuda.synchronize()
    check(roi.sample_rois.launches == 2,
          f"tracked call: {roi.sample_rois.launches} ROI launches, want 2")
    t0 = time.perf_counter()
    ref = tracked_run(cpu, frames)
    cpu_s = time.perf_counter() - t0
    valid = card["valid"].cpu()
    check(torch.equal(valid, ref["valid"]),
          f"valid: card {valid.sum().item()} valid frames, CPU "
          f"{ref['valid'].sum().item()}, at other frames")
    read = track_readings(card, ref)

    # the planted fault: the card's frames shifted one pixel to the right
    fault = tracked_run(gpu, np.roll(frames, 1, axis=3))
    read_fault = track_readings(fault, ref)
    for k, lim in TRACK_LIMITS.items():
        log(f"[tracked] {k}: card vs CPU max |diff| {read[k]:.4g}, limit "
            f"{lim:g}, planted fault (frames shifted 1 px) {read_fault[k]:.4g}")
        check(read[k] <= lim, f"tracked {k}: card vs CPU {read[k]} > {lim}")
        check(read_fault[k] > lim, f"tracked {k}: the planted fault's "
              f"{read_fault[k]} is within the limit {lim}")
    n_inv = [int((~valid[b, :lens[b]]).sum()) for b in range(B)]
    log(f"[tracked] {B} clips x {T} frames at {H}x{W}: invalid frames "
        f"inside each clip's length {n_inv} (card equal to CPU, CPU run "
        f"{cpu_s:.1f} s)")

    # the JAX robustness tests' properties, on the card
    gap_row, face_row = B - 2, B - 1
    check(valid[gap_row, :12].tolist() == [t not in TRACK_GAP
                                           for t in range(12)],
          f"cutaway clip: valid {valid[gap_row, :12].tolist()}")
    fb = card["face_boxes"].cpu().numpy()
    for t in TRACK_GAP:
        check(np.array_equal(fb[gap_row, t], fb[gap_row, TRACK_GAP[0] - 1]),
              f"cutaway frame {t}: box {fb[gap_row, t]} is not frame "
              f"{TRACK_GAP[0] - 1}'s {fb[gap_row, TRACK_GAP[0] - 1]}")
    from lipreading_tpu_torch.fixtures import make_clip

    truth = make_clip(62).boxes
    worst = 0.0
    for t in range(12):
        x0, y0, w, h = truth[t]
        d = np.hypot(fb[face_row, t, 0] + fb[face_row, t, 2] / 2 - x0 - w / 2,
                     fb[face_row, t, 1] + fb[face_row, t, 2] / 2 - y0 - h / 2)
        worst = max(worst, d / max(w, h))
        check(d < max(w, h) * 0.5, f"second face took the track at {t}")
    log(f"[tracked] cutaway frames {list(TRACK_GAP)} invalid with frame "
        f"{TRACK_GAP[0] - 1}'s box; the second face never takes the track "
        f"(worst centre distance {worst:.3f} of the face size, limit 0.5)")

    # kernel 1 at the face-crop shape (the tracked path's own inputs)
    from lipreading_tpu_torch.ops.roi import grayscale

    with torch.inference_mode():
        gray = grayscale(torch.as_tensor(frames, device="cuda").reshape(
            B * T, H, W, 3))
        ibox = round_face_boxes(card["face_boxes"].reshape(B * T, 3), H, W)
    pc = gpu["cfg"].preprocess
    kw = dict(mean=pc.normalize_mean, std=pc.normalize_std, normalize=False)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    floor = launch_floor_ms()
    crop = roi_times("face crop", gray, ibox, CROP, kw, flush, floor)
    del flush
    row = next(r for r in rows if r["name"] == "roi_sampler")
    row["crop"] = dict(N=B * T, R=CROP, normalize=0, ms=crop["ms_raw"],
                       ms_normalize1=crop["ms"], max_abs_err=crop["err"],
                       plain_ms=crop["plain_ms"],
                       library_ms=crop["library_ms"],
                       bound_ms=crop["bound_ms"], bound_by=crop["bound_by"],
                       wrapper_ms=crop["wrapper_ms"], launches_per_call=2)
    row["max_abs_err"] = max(row["max_abs_err"], crop["err"])

    # the stages' host ms (synchronised after each), the tracking loop's
    # launches, and one cascade call's greedy launch
    clock = StageClock(gpu["device"])
    tracked_run(gpu, frames, mark=clock.mark)
    log("[tracked] stages (host clock, synchronised): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in clock.ms.items()))
    cand = card["face_boxes"][:, :, None].expand(B, T, 4, 3).contiguous()
    conf = torch.rand((B, T, 4), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    with torch.inference_mode():
        pr = beam_profile(lambda: (track_boxes(cand, conf, 0.5), 0)[1])
    log(f"[tracked] track_boxes over {T} frames: {pr['ops']} device ops "
        f"({pr['ops'] / T:.1f} a frame), host {pr['host_ms']:.2f} ms under "
        f"the profiler, device busy {pr['device_ms']:.3f} ms")
    reset((ctc_greedy_ids,))
    with torch.inference_mode():
        texts, flags = infer.transcribe_cascade(
            gpu["model"], gpu["cfg"], card["rois"],
            torch.as_tensor(lens, device="cuda"), return_flags=True,
            **CASCADE_KW)
    torch.cuda.synchronize()
    check(ctc_greedy_ids.launches == 1,
          f"cascade: {ctc_greedy_ids.launches} greedy launches, want 1")
    log(f"[tracked] cascade on the tracked ROIs: 1 greedy launch, "
        f"{int(flags.sum())} of {B} clips rescored; transcripts {texts}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return gpu, cpu


def segmented_videos():
    """[segmented]'s two videos: a cutaway (make_clip(5501), 40 faceless
    frames, make_clip(5502)) and a hard cut (6601 and 6602 back to back)."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import make_clip, render_faceless_frames

    a, b = make_clip(5501), make_clip(5502)
    c, d = make_clip(6601), make_clip(6602)
    return {"cutaway": (np.concatenate(
                [a.frames, render_faceless_frames(7, 40), b.frames]), False),
            "hard cut": (np.concatenate([c.frames, d.frames]), True)}


def phase_segmented(gpu, cpu):
    """[segmented]: each video through preprocess_padded_tracked and
    transcribe_segmented(cascade=True) (the hard cut with its frame
    signatures) on the card and on the CPU: 2 segments each, spans and
    transcripts equal."""
    from lipreading_tpu_torch import infer
    from lipreading_tpu_torch.ops.preprocess import preprocess_padded_tracked

    t_phase = time.perf_counter()
    for name, (frames, cut) in segmented_videos().items():
        sig = infer.frame_signature(frames) if cut else None
        out = {}
        for srv in (gpu, cpu):
            t0 = time.perf_counter()
            rois, valid = preprocess_padded_tracked(
                srv["det"], srv["presence"], srv["lmk"], frames,
                srv["cfg"].preprocess)
            text, segs = infer.transcribe_segmented(
                srv["model"], srv["cfg"], rois, valid, cascade=True, sig=sig,
                **CASCADE_KW)
            out[srv["device"].type] = (text, segs, valid,
                                       time.perf_counter() - t0)
        text, segs, valid, dt = out["cuda"]
        check(len(segs) == 2, f"{name}: {len(segs)} segments, want 2")
        check((valid == out["cpu"][2]).all(), f"{name}: valid differs")
        check(segs == out["cpu"][1],
              f"{name}: card {segs} != CPU {out['cpu'][1]}")
        log(f"[segmented] {name}, {len(frames)} frames ({int(valid.sum())} "
            f"valid): {segs} -> {text!r}; card {dt * 1e3:.1f} ms, CPU "
            f"{out['cpu'][3] * 1e3:.1f} ms; spans and transcripts equal")
    log(f"[segmented] phase {time.perf_counter() - t_phase:.1f} s")


def tracked_roi_kernels(srv, fr, rows, tag: str):
    """Kernel 1 at a tracked call's own shapes (B clips x T frames on the
    device, N = B * T) against its plain version: the conv landmarker's face
    crop (R 64, integer boxes, normalize=0) and the sub-pixel mouth ROIs
    (R 96, float boxes); each timed (``roi_times``) and recorded on row 1
    under ``tag`` -> the call's ROIs."""
    import torch

    from lipreading_tpu_torch.ops import roi
    from lipreading_tpu_torch.ops.landmarker import CROP, round_face_boxes
    from lipreading_tpu_torch.ops.preprocess import (
        mouth_boxes_float,
        preprocess_clips_tracked,
    )

    B, T, H, W, _ = fr.shape
    pc = srv["cfg"].preprocess
    with torch.inference_mode():
        rois, _, aux = preprocess_clips_tracked(
            srv["det"], srv["presence"], srv["lmk"], fr, pc, return_aux=True)
        gray = roi.grayscale(fr.reshape(B * T, H, W, 3))
        ibox = round_face_boxes(aux["face_boxes"].reshape(B * T, 3), H, W)
        mbox = mouth_boxes_float(aux["landmarks"], pc.roi_margin)
    norm = dict(mean=pc.normalize_mean, std=pc.normalize_std)
    floor = launch_floor_ms()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    crop = roi_times(f"{tag} face crop", gray, ibox, CROP,
                     dict(norm, normalize=False), flush, floor)
    mouth = roi_times(f"{tag} mouth (subpixel)", gray, mbox, pc.roi_size,
                      dict(norm, subpixel=True), flush, floor)
    del flush
    keys = ("ms", "ms_raw", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "wrapper_ms")
    row = next(r for r in rows if r["name"] == "roi_sampler")
    row[tag] = {
        "crop": dict(N=B * T, R=CROP, normalize=0, max_abs_err=crop["err"],
                     **{k: crop[k] for k in keys}),
        "mouth": dict(N=B * T, R=pc.roi_size, subpixel=1,
                      max_abs_err=mouth["err"],
                      **{k: mouth[k] for k in keys})}
    row["max_abs_err"] = max(row["max_abs_err"], crop["err"], mouth["err"])
    return rois


def serve_shape_kernels(srv, fr, ln, rows) -> None:
    """Kernels 1-2 at [serve]'s own shapes, on one steady batch (B clips x
    bucket frames, N = B * bucket) against their plain versions: kernel 1 by
    ``tracked_roi_kernels``, and the greedy kernel on the batch's CTC
    log-probabilities, timed (``greedy_times``) and recorded on row 2."""
    import torch

    from lipreading_tpu_torch import infer
    from lipreading_tpu_torch.ops import decode
    from lipreading_tpu_torch.text import Vocab

    B, T = fr.shape[:2]
    rois = tracked_roi_kernels(srv, fr, rows, "serve")
    with torch.inference_mode():
        logp = infer.ctc_log_probs(srv["model"], srv["cfg"], rois,
                                   ln).contiguous()
    floor = launch_floor_ms()

    blank = Vocab().blank_id
    ln32 = ln.to(torch.int32)
    ids, cnt = decode.ctc_greedy_ids(logp, ln32, blank)
    rids, rcnt = decode.ctc_greedy_ids_reference(logp, ln32, blank)
    torch.cuda.synchronize()
    bad = int((ids != rids).sum().item() + (cnt != rcnt).sum().item())
    log(f"[greedy] serve B={B} T={T} V={logp.shape[-1]} (the batch's CTC "
        f"log-probabilities): {bad} ids or counts differ from the plain "
        "version")
    check(bad == 0, "CTC greedy disagrees with its plain version at the "
          "[serve] shape")
    greedy = greedy_times("serve", logp, ln32, blank, floor)
    row = next(r for r in rows if r["name"] == "ctc_greedy")
    row["serve"] = dict(B=B, T=T, V=int(logp.shape[-1]), mismatches=bad,
                        **{k: greedy[k] for k in ("ms", "wrapper_ms",
                                                  "plain_ms", "composite_ms",
                                                  "bound_ms", "bound_by")})
    row["max_abs_err"] = max(row["max_abs_err"], float(bad))


def phase_serve(gpu, cpu, rows):
    """[serve]: the serving loop of ``python -m lipreading_tpu_torch.serve``
    (render source, 64 clips, B 16, bucket 96, beam 8, LM 0.4, tracked,
    conv landmarker) with the launch counts set to 0 just before and read
    just after; its report and stage split; kernels 1-2 at its shapes
    (``serve_shape_kernels``); a profile of one steady batch; the first
    clips' transcripts against the CPU's; the ring closed."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from lipreading_tpu_torch.data.pipeline import (
        ShmVideoDecodePool,
        _render_frames,
    )
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.roi import sample_rois
    from lipreading_tpu_torch.serve import iter_batches, serve, serve_batch

    t_phase = time.perf_counter()
    wrappers = {"roi_sampler": sample_rois, "ctc_greedy": ctc_greedy_ids}
    others = set(mp.active_children())     # the long-clip renderers
    reset(wrappers.values())
    report = serve(device="cuda", log=log, **SERVE_KW)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    texts = report.pop("transcripts")
    log(f"[serve] report {json.dumps(report)}")
    log(f"[serve] launches {launches}")
    for r in rows:
        if r["name"] in launches:
            r["serve_launches"] = launches[r["name"]]
    check(all(v > 0 for v in launches.values()),
          f"[serve] a kernel of the path never launched: {launches}")
    check(len(texts) == SERVE_KW["n_clips"] and all(t is not None
                                                   for t in texts),
          "[serve] results missing")
    check(0.0 <= report["rescored_frac"] <= 1.0,
          f"rescored_frac {report['rescored_frac']}")
    check(report["latency_p50_ms"] is not None, "no steady batch")
    left = set(mp.active_children()) - others
    check(not left, f"[serve] the ring left processes {left}")

    # one steady batch (the first 16 clips, rendered by the ring) under the
    # profiler, and the first clips on the CPU
    B, bucket = SERVE_KW["B"], SERVE_KW["bucket"]
    with ShmVideoDecodePool(workers=max(1, (os.cpu_count() or 2) - 1),
                            slot_frames=bucket, frame_hw=(160, 160),
                            work_fn=_render_frames) as pool:
        frames, lens, _ = next(iter_batches(
            pool.imap_jobs([(100 + i, bucket) for i in range(B)]), B, B,
            bucket, (160, 160)))
    fr, ln = torch.as_tensor(frames, device="cuda"), torch.as_tensor(
        lens, device="cuda")
    serve_shape_kernels(gpu, fr, ln, rows)
    kw = {k: SERVE_KW[k] for k in ("beam", "lm_weight")}
    with torch.inference_mode():
        pr = beam_profile(lambda: (serve_batch(gpu, fr, ln, **kw), 0)[1])
    idle = 1 - pr["device_ms"] / pr["host_ms"]
    log(f"[serve] profile of one steady batch ({B} clips): host "
        f"{pr['host_ms']:.1f} ms under the profiler, device busy "
        f"{pr['device_ms']:.2f} ms (idle {100 * idle:.1f} %), "
        f"{pr['ops']} device ops, {pr['sync_ms']:.2f} ms in reads of device "
        "values")
    check(pr["device_ms"] > 0, "the profile saw no device time")
    n = SERVE_CPU_CLIPS
    t0 = time.perf_counter()
    cpu_texts, _, _ = serve_batch(cpu, torch.as_tensor(frames[:n]),
                                  torch.as_tensor(lens[:n]), **kw)
    log(f"[serve] first {n} clips on the CPU ({time.perf_counter() - t0:.1f}"
        f" s): {'equal' if cpu_texts == texts[:n] else 'DIFFER'}")
    check(cpu_texts == texts[:n],
          f"[serve] card {texts[:n]} != CPU {cpu_texts}")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return report, idle


def long_batch(long, cfg):
    """The long clips as one training batch at LONG_BUCKET frames."""
    from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset

    lf, ll, lt = long
    ds = FixtureVideoDataset(0, seed=0, cfg=cfg.data)
    ds.samples = [(lf[b, :ll[b]], lt[b]) for b in range(len(lt))]
    return ds.batch(list(range(len(lt))), LONG_BUCKET)


def flat_grads(tr, batch) -> tuple[float, "torch.Tensor"]:
    """One step's loss and flat gradient (float64, host) without dropout
    or jitter, no update."""
    import torch

    from lipreading_tpu_torch.data.pipeline import video_batch_to_device
    from lipreading_tpu_torch.models.lipreader import compute_loss

    mb = tr.model_batch(video_batch_to_device(batch, tr.device))
    tr.model.zero_grad(set_to_none=True)
    loss, _ = compute_loss(tr.model, tr.cfg, mb, train=True, gen=None)
    loss.backward()
    return loss.item(), torch.cat([p.grad.detach().double().cpu().reshape(-1)
                                   for p in tr.model.parameters()])


def grad_readings(a, b) -> dict:
    """How far gradient ``a`` is from ``b``: ||a - b|| / ||b|| and
    1 - cosine."""
    import torch

    return {"grad_rel": float((a - b).norm() / b.norm()),
            "grad_1_cos": 1.0 - float(torch.nn.functional.cosine_similarity(
                a, b, dim=0))}


def phase_train_flash(gpu, long, rows):
    """Fine-tuning with model.flash_attention=1 on the long clips: each
    backward policy for a few steps with launch counts, one step's gradient
    of pallas and fused against xla (float32) with a planted fault, a fixed
    batch whose loss falls, peak memory with flash on and off."""
    import torch

    from lipreading_tpu_torch.ops import ctc
    from lipreading_tpu_torch.ops import flash_attention as fa

    over = {"model.flash_attention": 1, "data.max_chars": LONG_MAX_CHARS}
    tree, base = release_train_cfg(**over)
    batch = long_batch(long, base)
    layers = base.model.tf_layers
    log(f"[train-flash] batch {tuple(batch.frames.shape[:2])}, lengths "
        f"{batch.frame_lengths.tolist()}, labels {batch.ctc_lengths.tolist()}"
        f" chars; release {RELEASE} warm start, dropout "
        f"{base.model.dropout}, roi_augment {base.train.roi_augment}, "
        f"{base.model.dtype}")
    counted = (*fa.WRAPPERS, ctc.ctc_lattice_fwd, ctc.ctc_lattice_bwd)
    totals = dict.fromkeys((w.__name__ for w in fa.WRAPPERS), 0)
    for pol in ("xla", "pallas", "fused"):
        cfg = base.override(**{"model.flash_bwd": pol})
        tr = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
        tr.train_step(batch)                     # warm-up
        torch.cuda.synchronize()
        reset(counted)
        ms, losses = [], []
        for _ in range(FLASH_TRAIN_STEPS):
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        got = {w.__name__: w.launches for w in counted}
        want = {"flash_fwd": layers,
                "flash_bwd_fused": layers if pol == "fused" else 0,
                "flash_bwd_dq": layers if pol == "pallas" else 0,
                "flash_bwd_dkv": layers if pol == "pallas" else 0,
                "ctc_lattice_fwd": 1, "ctc_lattice_bwd": 1}
        log(f"[train-flash] flash_bwd={pol}: {FLASH_TRAIN_STEPS} steps, "
            f"losses {[round(x['loss'], 4) for x in losses]}, ms per step "
            f"{[round(x, 1) for x in ms]} (host clock, synchronised), "
            f"launches {got}")
        for m in losses:
            check(all(v == v and abs(v) != float("inf") for v in m.values()),
                  f"flash_bwd={pol}: non-finite step metrics {m}")
        for k, v in want.items():
            check(got[k] == v * FLASH_TRAIN_STEPS,
                  f"flash_bwd={pol}: {k} launched {got[k]} times in "
                  f"{FLASH_TRAIN_STEPS} steps, want {v} per step")
            if k in totals:
                totals[k] += got[k]
        del tr
    for r in rows:
        if r["name"] in totals:
            r["launches"] = totals[r["name"]]

    # one step's gradient, float32 (where flash and the einsum attention
    # are the same function): pallas and fused against xla, and a planted
    # fault (the fused backward with each key mask one short)
    f32 = {"model.dropout": 0.0, "train.roi_augment": 0.0,
           "model.dtype": "float32"}
    grads = {}
    real_fused = fa.flash_bwd_fused

    def short_mask(q, k, v, lengths, *rest):
        return real_fused(q, k, v, torch.clamp(lengths - 1, min=0), *rest)

    short_mask.launches = 0     # the wrapper counts under its module name

    for name, pol in (("xla", "xla"), ("pallas", "pallas"),
                      ("fused", "fused"), ("fault", "fused")):
        cfg = base.override(**dict(f32, **{"model.flash_bwd": pol}))
        tr = make_trainer(cfg, None, gpu, "cuda", TRAIN_DIR)
        fa.flash_bwd_fused = short_mask if name == "fault" else real_fused
        try:
            grads[name] = flat_grads(tr, batch)
        finally:
            fa.flash_bwd_fused = real_fused
        del tr
    ref = grads["xla"][1]
    read = {n: grad_readings(grads[n][1], ref)
            for n in ("pallas", "fused", "fault")}
    log(f"[train-flash] float32 step from the seeded initialisation, loss "
        f"{grads['xla'][0]:.6f} (xla) {grads['pallas'][0]:.6f} (pallas) "
        f"{grads['fused'][0]:.6f} (fused)")
    for k, lim in FLASH_GRAD_LIMITS.items():
        log(f"[train-flash]   {k} against xla: pallas {read['pallas'][k]:.4g}"
            f", fused {read['fused'][k]:.4g}, limit {lim:g}, planted fault "
            f"{read['fault'][k]:.4g}")
    for k, lim in FLASH_GRAD_LIMITS.items():
        for n in ("pallas", "fused"):
            check(read[n][k] <= lim, f"flash_bwd={n} grads vs xla: {k} "
                  f"{read[n][k]} > {lim}")
        check(read["fault"][k] > lim, f"the planted fault's {k} "
              f"{read['fault'][k]} is within the limit {lim}")

    # a fixed batch from the seeded initialisation: its loss must fall
    cfg = base.override(**{"model.flash_bwd": "fused",
                           "train.warmup_steps": 0})
    tr = make_trainer(cfg, None, gpu, "cuda", TRAIN_DIR)
    before = det_loss(tr, batch)
    seen = [float(tr.train_step(batch)["loss"])
            for _ in range(FLASH_FIXED_STEPS)]
    after = det_loss(tr, batch)
    log(f"[train-flash] fixed batch, flash_bwd=fused, seeded "
        f"initialisation: loss without dropout {before:.4f} -> {after:.4f} "
        f"after {FLASH_FIXED_STEPS} steps; step losses "
        + " ".join(f"{v:.4f}" for v in seen))
    check(after < before, f"flash fixed-batch loss did not fall: {before} -> "
          f"{after}")
    del tr

    # peak device memory of one step, flash on (fused) and off
    peak = {}
    for name, o in (("on", {"model.flash_bwd": "fused"}),
                    ("off", {"model.flash_attention": 0})):
        tr = make_trainer(base.override(**o), tree, gpu, "cuda", TRAIN_DIR)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        tr.train_step(batch)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        del tr
    log(f"[train-flash] peak device memory of one step above the resident "
        f"state: flash on {peak['on']:.1f} MiB, off {peak['off']:.1f} MiB")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def release_train_cfg(**overrides):
    """The release's config (dropout 0.1, roi_augment 0.15), with
    overrides."""
    from lipreading_tpu_torch.io import load_release

    tree, cfg = load_release(RELEASE)
    return tree, (cfg.override(**overrides) if overrides else cfg)


def make_trainer(cfg, tree, dev, device, workdir, tracked=False):
    """A FusedTrainer warm-started from ``tree``, or initialised from the
    config's seed when ``tree`` is None; ``dev`` is ``load_port``'s (the
    ERT) or ``load_server``'s (the conv landmarker and the presence head,
    which ``tracked`` takes)."""
    from lipreading_tpu_torch.train.loop import FusedTrainer

    tr = FusedTrainer(cfg, workdir, dev["det"], dev.get("lmk", dev.get("ert")),
                      device=device, presence=dev.get("presence"),
                      tracked=tracked)
    tr.logger.echo = False
    if tree is not None:
        tr.warm_start(tree)
    return tr


def det_loss(tr, batch) -> float:
    """The batch's loss without dropout or jitter (``rng=None``)."""
    import torch

    from lipreading_tpu_torch.data.pipeline import video_batch_to_device
    from lipreading_tpu_torch.models.lipreader import compute_loss

    with torch.no_grad():
        mb = tr.model_batch(video_batch_to_device(batch, tr.device))
        loss, _ = compute_loss(tr.model, tr.cfg, mb, train=True, gen=None)
    return float(loss)


def phase_train(gpu, rows):
    """FusedTrainer on the card: steps with launch counts, stage times, a
    fixed batch whose loss falls, a checkpoint round trip."""
    import torch

    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
    )
    from lipreading_tpu_torch.models.nn import conv3d_dgrad
    from lipreading_tpu_torch.ops.ctc import ctc_lattice_bwd, ctc_lattice_fwd
    from lipreading_tpu_torch.ops.roi import sample_rois

    tree, cfg = release_train_cfg()
    t0 = time.perf_counter()
    ds = FixtureVideoDataset(TRAIN_CLIPS, seed=1, cfg=cfg.data)
    it = VideoBatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed)
    log(f"[train] corpus: {TRAIN_CLIPS} fixture clips -> {len(ds)} samples "
        f"({time.perf_counter() - t0:.1f} s to render); release {RELEASE}, "
        f"full width and depth, dropout {cfg.model.dropout}, roi_augment "
        f"{cfg.train.roi_augment}, batch {cfg.data.batch_size}, "
        f"{cfg.model.dtype}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    tr = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
    tr.train_step(next(it))                    # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    wrappers = {"roi_sampler": sample_rois, "ctc_lattice_fwd": ctc_lattice_fwd,
                "ctc_lattice_bwd": ctc_lattice_bwd,
                "conv3d_dgrad": conv3d_dgrad}
    # launches a step: the patchify stem's two stride-1 convolutions (convA,
    # convB) take their input gradient from the conv3d_dgrad kernel
    per_step = {"roi_sampler": 1, "ctc_lattice_fwd": 1, "ctc_lattice_bwd": 1,
                "conv3d_dgrad": 2}
    reset(wrappers.values())
    step_ms, frames, losses = [], 0, []
    for _ in range(TRAIN_STEPS):
        batch = next(it)
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        frames += batch.frames.shape[0] * batch.frames.shape[1]
        losses.append({k: float(v) for k, v in m.items()})
    launches = {k: w.launches for k, w in wrappers.items()}
    for r in rows:
        if r["name"] in ("ctc_lattice_fwd", "ctc_lattice_bwd", "conv3d_dgrad"):
            r["launches"] = launches[r["name"]]
    for i, m in enumerate(losses):
        log(f"[train]   step {i + 2}: loss {m['loss']:.4f} ctc "
            f"{m['ctc_loss']:.4f} att {m['att_loss']:.4f} grad_norm "
            f"{m['grad_norm']:.3f} ({step_ms[i]:.1f} ms)")
    total = sum(step_ms)
    log(f"[train] {TRAIN_STEPS} steps: {total / TRAIN_STEPS:.1f} ms per step "
        f"(host clock, synchronised), {frames / total * 1e3:.0f} padded "
        f"frames/s; launches {launches} "
        f"(per step {({k: v / TRAIN_STEPS for k, v in launches.items()})})")
    for m in losses:
        check(all(map(lambda v: v == v and abs(v) != float("inf"),
                      m.values())), f"non-finite step metrics {m}")
    for k, v in launches.items():
        check(v == per_step[k] * TRAIN_STEPS, f"{k}: {v} launches in "
              f"{TRAIN_STEPS} training steps, want {per_step[k]} per step")

    # where a step's time goes: each stage closed by a synchronise
    stages = {}
    shapes = []
    for _ in range(STAGE_STEPS):
        batch = next(it)
        tr.train_step(batch, stage_ms=stages)
        shapes.append(tuple(batch.frames.shape[:2]))
    log(f"[train] stages (mean of {STAGE_STEPS} steps, batches {shapes}, "
        "host clock, synchronised): " + ", ".join(
            f"{k} {v / STAGE_STEPS:.2f} ms" for k, v in stages.items()))
    nbytes = batch.frames.nbytes
    log(f"[train] host copy: uint8 frames of the last batch {nbytes} B "
        f"(pageable host memory)")

    # checkpoint: save, reload into a fresh trainer, parameters equal
    path = tr.save(it)
    tr2 = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
    it_state = tr2.restore(path)
    same = all(torch.equal(a, b) for a, b in
               zip(tr.model.state_dict().values(),
                   tr2.model.state_dict().values()))
    same_opt = all(torch.equal(tr.opt.mu[k], tr2.opt.mu[k])
                   and torch.equal(tr.opt.nu[k], tr2.opt.nu[k])
                   for k in tr.opt.mu) and tr.opt.count == tr2.opt.count
    log(f"[train] checkpoint {os.path.basename(path)} "
        f"({os.path.getsize(path)} B): reloaded step {tr2.step}, params "
        f"{'equal' if same else 'DIFFER'}, optimizer state "
        f"{'equal' if same_opt else 'DIFFERS'}, iterator {it_state}")
    check(same and same_opt and tr2.step == tr.step,
          "checkpoint round trip changed the state")
    del tr, tr2

    # one fixed batch: its loss (no dropout, no jitter) must fall. The
    # release already fits the fixtures (loss ~1e-4), so this starts from
    # the config's seeded initialisation; the release's 200 warm-up steps
    # would keep the rate near 0, so none here
    _, cfg_fix = release_train_cfg(**{"train.warmup_steps": 0})
    tr = make_trainer(cfg_fix, None, gpu, "cuda", TRAIN_DIR)
    batch = ds.batch(list(range(cfg.data.batch_size)),
                     max(cfg.data.time_buckets))
    before = det_loss(tr, batch)
    seen = [float(tr.train_step(batch)["loss"]) for _ in range(FIXED_STEPS)]
    after = det_loss(tr, batch)
    log(f"[train] fixed batch {tuple(batch.frames.shape[:2])}, from the "
        f"seeded initialisation, lr "
        f"{cfg_fix.train.learning_rate}: loss without dropout {before:.4f} "
        f"-> {after:.4f} after {FIXED_STEPS} steps; step losses "
        + " ".join(f"{v:.4f}" for v in seen))
    check(after < before, f"fixed-batch loss did not fall: {before} -> {after}")
    del tr
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def avsr_cfg():
    """The Auto-AVSR visual speech recogniser at its published widths
    (``train.autoavsr_vsr``'s model): the ResNet-18 trunk, 12 Conformer
    blocks at d 768, 12 heads, FFN 3072, 6 decoder layers, 5,002 outputs,
    ESPnet's losses, dropout 0.1, bf16, from the seed."""
    from lipreading_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(
        name="autoavsr-vsr", encoder="conformer", decoder="hybrid",
        loss="espnet",
        model=ModelConfig(frontend="resnet18", tf_dim=768, tf_heads=12,
                          tf_mlp=3072, tf_layers=12, tf_dec_layers=6,
                          vocab_size=5002, dropout=0.1, dtype="bfloat16"),
        train=TrainConfig(ctc_weight=0.1, att_weight=0.9))


def avsr_batch(B: int, T: int, crop: int, V: int, seed: int) -> dict:
    """A seeded batch as ``Trainer.train_step`` takes it: normalised-scale
    ROIs [B, T, crop, crop] on the card, 0 past each clip's length (the
    longest T), one token per 6 frames, targets framed by sos = eos =
    V - 1."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    fl = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    fl[0] = T
    cn = torch.clamp(fl // 6, min=1)
    L = int(cn.max())
    cl = torch.zeros((B, L), dtype=torch.int32)
    tg = torch.zeros((B, L + 2), dtype=torch.int32)
    for k in range(B):
        ids = torch.randint(1, V - 2, (int(cn[k]),), generator=g,
                            dtype=torch.int32)
        cl[k, :len(ids)] = ids
        tg[k, 0], tg[k, len(ids) + 1] = V - 1, V - 1
        tg[k, 1:len(ids) + 1] = ids
    rois = torch.randn((B, T, crop, crop), generator=g)
    rois *= (torch.arange(T)[None] < fl[:, None])[..., None, None]
    host = {"rois": rois, "frame_lengths": fl, "targets": tg,
            "target_lengths": cn + 2, "ctc_labels": cl, "ctc_lengths": cn}
    return {k: v.cuda() for k, v in host.items()}


def phase_train_avsr():
    """[train-avsr]: the Auto-AVSR model (``avsr_cfg``) through
    ``Trainer.train_step`` on the card: finite losses and 13 launches of
    ``conv3d_dgrad`` a step (the ResNet-18 trunk's stride-1 3x3
    convolutions; the count set to 0 just before each step, read just
    after), the step's time and the peak memory."""
    import torch

    from lipreading_tpu_torch.models.nn import conv3d_dgrad
    from lipreading_tpu_torch.train.loop import Trainer

    B, T, crop, steps = 8, 128, 88, 3
    cfg = avsr_cfg()
    wd = TRAIN_DIR + "_avsr"
    shutil.rmtree(wd, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, wd, "cuda")
    n = sum(p.numel() for p in tr.model.parameters())
    batch = avsr_batch(B, T, crop, cfg.model.vocab_size, 5)
    tr.train_step(batch)                           # warm-up
    torch.cuda.synchronize()
    log(f"[train-avsr] Auto-AVSR VSR from the seed, {n / 1e6:.1f} M "
        f"parameters, B {B} x T {T} of {crop}x{crop}, {cfg.model.dtype}: "
        f"built and warmed up in {time.perf_counter() - t0:.1f} s")
    for i in range(steps):
        conv3d_dgrad.launches = 0
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = conv3d_dgrad.launches
        m = {k: float(v) for k, v in m.items()}
        log(f"[train-avsr]   step {i + 2}: loss {m['loss']:.4f} ctc "
            f"{m['ctc_loss']:.4f} att {m['att_loss']:.4f} ({ms:.1f} ms, "
            f"host clock, synchronised); conv3d_dgrad launches {launches}")
        check(all(v == v and abs(v) != float("inf") for v in m.values()),
              f"[train-avsr] non-finite step metrics {m}")
        check(launches == 13, f"[train-avsr] conv3d_dgrad {launches} "
              "launches in a step, want 13 (the trunk's stride-1 3x3 "
              "convolutions)")
    del tr
    shutil.rmtree(wd, ignore_errors=True)
    log(f"[train-avsr] peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()


def parity_readings(a: dict, b: dict, lr: float) -> dict:
    """How far step ``a`` is from step ``b``, in the terms of
    ``PARITY_LIMITS``."""
    import torch

    diffs = torch.cat([(a["params"][k] - b["params"][k]).abs().reshape(-1)
                       for k in a["params"]])
    return {
        "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        "norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
        "grad_1_cos": 1.0 - float(torch.nn.functional.cosine_similarity(
            a["grads"], b["grads"], dim=0)),
        "flip_share": float((diffs > lr).float().mean()),
    }


def step_record(cfg, batch, dev, device, name, tracked=False) -> dict:
    """One step of a FusedTrainer from the config's seeded initialisation:
    its loss, unclipped gradient norm, updated parameters and flat
    gradient (on the host), and the seconds it took."""
    import torch

    t0 = time.perf_counter()
    tr = make_trainer(cfg, None, dev, device, TRAIN_DIR + "_" + name,
                      tracked=tracked)
    m = tr.train_step(batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": {k: p.detach().cpu() for k, p in
                      tr.model.named_parameters()},
           "grads": torch.cat([p.grad.detach().double().cpu().reshape(-1)
                               for p in tr.model.parameters()]),
           "s": time.perf_counter() - t0}
    del tr
    shutil.rmtree(TRAIN_DIR + "_" + name, ignore_errors=True)
    return out


def phase_train_parity(gpu):
    """One step without dropout or jitter on 2 clips, on the card and on the
    CPU (plain versions), from the same seeded initialisation (the release's
    loss, ~1e-4, leaves gradients too small to compare in bfloat16). Two
    controls beside it: a planted fault on the card, which every limit must
    catch, and the CPU in float32, which reads how far bf16 rounding alone
    moves the step (reported, not gated)."""
    import dataclasses

    from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset

    over = {"model.dropout": 0.0, "train.roi_augment": 0.0,
            "train.warmup_steps": 0}
    _, cfg = release_train_cfg(**over)
    _, cfg32 = release_train_cfg(**dict(over, **{"model.dtype": "float32"}))
    ds = FixtureVideoDataset(1, seed=2, cfg=cfg.data)
    batch = ds.batch([0, 1], 32)
    short = batch.frame_lengths.copy()
    short[-1] -= 1
    faulty = dataclasses.replace(batch, frame_lengths=short)
    cpu = load_port("cpu")
    out = {name: step_record(c, b, dev, device, name)
           for name, c, b, dev, device in (
               ("card", cfg, batch, gpu, "cuda"),
               ("card_fault", cfg, faulty, gpu, "cuda"),
               ("cpu", cfg, batch, cpu, "cpu"),
               ("cpu_f32", cfg32, batch, cpu, "cpu"))}
    lr = cfg.train.learning_rate
    read = {name: parity_readings(out[name], out["cpu"], lr)
            for name in ("card", "card_fault", "cpu_f32")}
    log(f"[parity] seeded initialisation, batch "
        f"{tuple(batch.frames.shape[:2])}, lengths "
        f"{batch.frame_lengths.tolist()} (fault {short.tolist()}), lr {lr} "
        "at step 0: " + "; ".join(
            f"{k} loss {v['loss']:.6f} grad_norm {v['grad_norm']:.5f} "
            f"({v['s']:.1f} s)" for k, v in out.items()))
    for k, lim in PARITY_LIMITS.items():
        log(f"[parity]   {k}: card vs cpu {read['card'][k]:.4g}, limit "
            f"{lim:g}, planted fault vs cpu {read['card_fault'][k]:.4g}; cpu "
            f"float32 vs cpu {read['cpu_f32'][k]:.4g}")
    for k, lim in PARITY_LIMITS.items():
        check(read["card"][k] <= lim,
              f"parity: card vs CPU {k} {read['card'][k]} > {lim}")
        check(read["card_fault"][k] > lim,
              f"parity: the planted fault's {k} {read['card_fault'][k]} is "
              f"within the limit {lim}: the limit would pass a faulty step")


# --- the rest of training: dataviews, the dataview trainer, the tracked
# fused trainer, remat and the evaluation entry


def path_launches(rows, path: str, counts: dict) -> None:
    """Record the launches of each kernel row on one path's run."""
    for r in rows:
        if r["name"] in counts:
            r.setdefault("launches_by_path", {})[path] = counts[r["name"]]


def build_view(path, n_clips, seed, cfg, device, **kw):
    """``build_fixture_dataview`` on ``device`` -> (view, each clip's float
    ROIs as ``roi_to_u8`` got them, seconds)."""
    from lipreading_tpu_torch.data import dataview as dv

    seen = []
    real = dv.roi_to_u8

    def keep(r, c):
        seen.append(r.copy())
        return real(r, c)

    shutil.rmtree(path, ignore_errors=True)
    dv.roi_to_u8 = keep
    try:
        t0 = time.perf_counter()
        view = dv.build_fixture_dataview(path, n_clips, seed=seed,
                                         data_cfg=cfg.data,
                                         pre_cfg=cfg.preprocess,
                                         device=device, **kw)
        if device == DEV:
            import torch

            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dv.roi_to_u8 = real
    return view, seen, secs


def byte_rule(card, cpu, tol: float, pre) -> dict:
    """The stored bytes of one build against another's: the float ROIs'
    max |diff|, the bytes that differ, and those of them whose value does
    not sit within ``tol`` x std x 255 (+ 2 float32 ulps of 255) of a .5
    rounding boundary (must be 0), and the largest byte difference."""
    import numpy as np

    from lipreading_tpu_torch.data.dataview import roi_to_u8

    g = (cpu * pre.normalize_std + pre.normalize_mean) * 255.0
    near = (np.abs(g - np.floor(g) - 0.5)
            <= tol * pre.normalize_std * 255.0
            + 2 * np.spacing(np.float32(255)))
    d = roi_to_u8(card, pre).astype(int) - roi_to_u8(cpu, pre)
    return {"roi": float(np.abs(card - cpu).max()),
            "bytes": int((d != 0).sum()), "away": int((d != 0)[~near].sum()),
            "max": int(np.abs(d).max())}


def phase_dataview(rows) -> dict:
    """[dataview]: the fixture dataview of the training corpus built on the
    card twice (untracked with the ERT; tracked with the conv landmarker,
    keeping the faceless frames), with the build seconds and the ROI
    launches per clip; the first clips of each built on the CPU too: the
    index and the masks equal, the bytes by the boundary rule; and the
    held-out view of the dataview trainer -> {name: view}."""
    import numpy as np

    from lipreading_tpu_torch.ops.roi import sample_rois

    _, base = release_train_cfg()
    views = {}
    for name, lm, kw in (("ert", "ert", {}),
                         ("tracked_conv", "conv",
                          dict(tracked=True, keep_invalid=True))):
        cfg = base.override(**{"preprocess.landmarker": lm})
        path = os.path.join(DV_DIR, name)
        reset((sample_rois,))
        view, card, secs = build_view(path, TRAIN_CLIPS, 1, cfg, DEV, **kw)
        n = sample_rois.launches
        want = TRAIN_CLIPS * (2 if lm == "conv" else 1)
        path_launches(rows, f"dataview {name}", {"roi_sampler": n})
        nv = sum(s.get("num_valid", s["num_frames"]) for s in view.samples)
        nf = sum(s["num_frames"] for s in view.samples)
        log(f"[dataview] {name}: {TRAIN_CLIPS} clips -> {len(view)} samples "
            f"({nv} of {nf} frames confident) in {secs:.2f} s on the card; "
            f"ROI launches {n} ({n / TRAIN_CLIPS:g} a clip, want "
            f"{want // TRAIN_CLIPS})")
        check(n == want, f"dataview {name}: {n} ROI launches for "
              f"{TRAIN_CLIPS} clips, want {want}")
        ref, cpu, cpu_s = build_view(path + "_cpu", DV_CPU_CLIPS, 1, cfg,
                                     "cpu", **kw)
        first = [s for s in view.samples if int(s["file"][4:9]) < DV_CPU_CLIPS]
        check(first == ref.samples, f"dataview {name}: the card's index of "
              f"the first {DV_CPU_CLIPS} clips differs from the CPU's")
        for i in range(len(ref)):
            check(np.array_equal(view.frame_valid(i), ref.frame_valid(i)),
                  f"dataview {name}: frame_valid of {ref.samples[i]['file']}"
                  " differs card against CPU")
        tol = DV_ROI_TOL[lm]
        read = [byte_rule(c, r, tol, cfg.preprocess)
                for c, r in zip(card[:DV_CPU_CLIPS], cpu)]
        agg = {k: max(x[k] for x in read) if k in ("roi", "max")
               else sum(x[k] for x in read) for k in read[0]}
        log(f"[dataview] {name} card vs CPU ({DV_CPU_CLIPS} clips, CPU "
            f"{cpu_s:.1f} s): index and frame_valid equal; ROIs max |diff| "
            f"{agg['roi']:.3g} (limit {tol:g}); {agg['bytes']} stored bytes "
            f"differ, by at most {agg['max']}, {agg['away']} of them away "
            f"from a rounding boundary (must be 0)")
        check(agg["roi"] <= tol and agg["away"] == 0 and agg["max"] <= 1,
              f"dataview {name}: card vs CPU bytes break the boundary rule "
              f"{agg}")
        shutil.rmtree(path + "_cpu", ignore_errors=True)
        views[name] = view
    views["heldout"], _, secs = build_view(
        os.path.join(DV_DIR, "heldout"), HELDOUT_CLIPS, HELDOUT_SEED, base,
        DEV)
    log(f"[dataview] held-out view: {HELDOUT_CLIPS} clips (seed "
        f"{HELDOUT_SEED}) -> {len(views['heldout'])} samples in {secs:.2f} s")
    return views


def transcripts(tr, batches, beam: int) -> list[str]:
    """What ``Trainer.evaluate`` decodes: each held-out batch's inputs
    through ``infer.transcribe``."""
    import torch

    from lipreading_tpu_torch.infer import transcribe

    out = []
    for b in batches:
        with torch.inference_mode():
            rois, lengths = tr.eval_inputs(b)
        out += transcribe(tr.model, tr.cfg, rois, lengths, beam=beam)
    return out


def timed_evaluate(tr, ms: list):
    """Make ``tr.evaluate`` append its synchronised host ms to ``ms``."""
    import torch

    real = tr.evaluate

    def evaluate(batches, beam=None):
        t0 = time.perf_counter()
        m = real(batches, beam)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return m

    tr.evaluate = evaluate


def counted_wrappers():
    from lipreading_tpu_torch.ops import ctc, decode, roi

    return {"roi_sampler": roi.sample_rois,
            "ctc_lattice_fwd": ctc.ctc_lattice_fwd,
            "ctc_lattice_bwd": ctc.ctc_lattice_bwd,
            "ctc_greedy": decode.ctc_greedy_ids}


def phase_train_dataview(views, rows):
    """[train-dataview]: ``Trainer`` on the [dataview] corpus, warm-started
    from the release at full width: at step 0 the held-out evaluation (the
    joint beam at beam 8) card against CPU, exact; then ``fit`` with an
    evaluation at its last step, launch counts, losses, the eval's CER,
    WER and ms, and each stage's ms."""
    import torch

    from lipreading_tpu_torch.data.dataset import (
        BatchIterator,
        BucketedDataset,
        batch_to_device,
    )
    from lipreading_tpu_torch.train.loop import Trainer

    # the warm-up is step 1: the fit's last step is the evaluation's
    tree, cfg = release_train_cfg(**{"train.eval_every": DV_STEPS + 1,
                                     "train.log_every": 1,
                                     "train.checkpoint_every": 0})
    ds = BucketedDataset(views["ert"], cfg.data)
    it = BatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed)
    ho = BucketedDataset(views["heldout"], cfg.data)
    held = [ho.make_batch(list(range(min(HELDOUT_SAMPLES, len(ho)))))]
    trainers = {}
    for device in (DEV, "cpu"):
        shutil.rmtree(f"{TRAIN_DIR}_{device}", ignore_errors=True)
        tr = Trainer(cfg, f"{TRAIN_DIR}_{device}", device=device)
        tr.logger.echo = False
        tr.warm_start(tree)
        trainers[device] = tr
    tr = trainers[DEV]

    # batch_to_device: the card's normalised ROIs equal the CPU's exactly;
    # PyTorch's own division by a scalar (a multiply by the reciprocal on
    # the card) is the planted fault
    pre = cfg.preprocess
    norm = (pre.normalize_mean, pre.normalize_std)
    card_rois = batch_to_device(held[0], *norm, DEV)["rois"]
    cpu_rois = batch_to_device(held[0], *norm, "cpu")["rois"]
    u8 = torch.as_tensor(held[0].rois_u8, device=DEV).float()
    fault = ((u8 / 255.0) - norm[0]) / norm[1]
    n_off = int((card_rois.cpu() != cpu_rois).sum())
    n_fault = int((fault.cpu() != cpu_rois).sum())
    log(f"[train-dataview] batch_to_device {tuple(card_rois.shape)}: "
        f"{n_off} normalised values differ card vs CPU (must be 0); the "
        f"planted fault (PyTorch's scalar division) {n_fault}")
    check(n_off == 0 and n_fault > 0, f"batch_to_device: card vs CPU "
          f"{n_off} values differ, planted fault {n_fault}")

    t0 = time.perf_counter()
    card = transcripts(tr, held, cfg.train.beam_width)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = transcripts(trainers.pop("cpu"), held, cfg.train.beam_width)
    cpu_s = time.perf_counter() - t0
    same = sum(a == b for a, b in zip(card, cpu))
    log(f"[train-dataview] step 0 held-out evaluation, {len(card)} samples "
        f"of batch {tuple(held[0].rois_u8.shape[:2])}, joint beam "
        f"{cfg.train.beam_width}: card {card_ms:.1f} ms (first call), CPU "
        f"{cpu_s:.1f} s; {same}/{len(card)} transcripts equal card vs CPU")
    check(card == cpu, f"held-out transcripts differ card vs CPU: {card} vs "
          f"{cpu}")

    tr.train_step(next(it))                     # warm-up
    torch.cuda.synchronize()
    wrappers = counted_wrappers()
    reset(wrappers.values())
    eval_ms = []
    timed_evaluate(tr, eval_ms)
    t0 = time.perf_counter()
    last = tr.fit(it, steps=DV_STEPS, eval_batches=held)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    path_launches(rows, "train-dataview", got)
    with open(tr.logger.path) as f:
        steps = [x for x in map(json.loads, f) if "loss" in x]
    for x in steps:
        log(f"[train-dataview]   step {x['step']}: loss {x['loss']:.4f} ctc "
            f"{x['ctc_loss']:.4f} att {x['att_loss']:.4f} grad_norm "
            f"{x['grad_norm']:.3f}")
    log(f"[train-dataview] fit: {DV_STEPS} steps and one evaluation in "
        f"{fit_s:.2f} s; eval_cer {last['eval_cer']:.4f} eval_wer "
        f"{last['eval_wer']:.4f} in {eval_ms[0]:.1f} ms (host clock, "
        f"synchronised); launches {got}")
    for x in steps:
        check(all(v == v and abs(v) != float("inf") for v in x.values()
                  if isinstance(v, float)), f"non-finite step metrics {x}")
    want = {"roi_sampler": 0, "ctc_lattice_fwd": DV_STEPS,
            "ctc_lattice_bwd": DV_STEPS, "ctc_greedy": 0}
    check(got == want, f"dataview steps launched {got}, want {want} (one of "
          "each CTC kernel a step, no ROI or greedy launch)")
    check(len(eval_ms) == 1, f"{len(eval_ms)} evaluations in fit, want 1")
    stages = {}
    for _ in range(STAGE_STEPS):
        tr.train_step(next(it), stage_ms=stages)
    log(f"[train-dataview] stages (mean of {STAGE_STEPS} steps, host clock, "
        "synchronised): " + ", ".join(
            f"{k} {v / STAGE_STEPS:.2f} ms" for k, v in stages.items()))
    del tr, trainers
    for device in (DEV, "cpu"):
        shutil.rmtree(f"{TRAIN_DIR}_{device}", ignore_errors=True)


def with_faceless(batch, cfg, seed: int):
    """``batch`` with sample 0's frames (up to its length) faceless
    background frames."""
    import dataclasses

    from lipreading_tpu_torch.fixtures import render_faceless_frames

    frames = batch.frames.copy()
    n = int(batch.frame_lengths[0])
    frames[0, :n] = render_faceless_frames(seed, n, cfg.data)
    return dataclasses.replace(batch, frames=frames)


def phase_train_tracked(rows):
    """[train-tracked]: ``FusedTrainer(tracked=True)`` with the conv
    landmarker and the presence head, warm-started from the release, on
    batches whose first sample is faceless: launch counts, losses, stage
    ms; the zero-weight pin; kernel 1 at the step's shapes; one
    dropout-off step card against CPU with a planted fault; the tracked
    evaluation card against CPU."""
    import dataclasses

    import torch

    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
        video_batch_to_device,
    )
    from lipreading_tpu_torch.serve import load_server

    conv = {"preprocess.landmarker": "conv"}
    tree, cfg = release_train_cfg(**conv)
    gpu, cpu = load_server(device=DEV), load_server(device="cpu")
    ds = FixtureVideoDataset(TRAIN_CLIPS, seed=1, cfg=cfg.data)
    it = VideoBatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed)
    tr = make_trainer(cfg, tree, gpu, DEV, TRAIN_DIR, tracked=True)
    tr.train_step(with_faceless(next(it), cfg, 0))            # warm-up
    torch.cuda.synchronize()
    wrappers = counted_wrappers()
    reset(wrappers.values())
    ms, losses, shapes = [], [], []
    for k in range(TRACKED_STEPS):
        batch = with_faceless(next(it), cfg, k + 1)
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
        shapes.append(tuple(batch.frames.shape[:2]))
    got = {k: w.launches for k, w in wrappers.items()}
    path_launches(rows, "train-tracked", got)
    log(f"[train-tracked] {TRACKED_STEPS} steps (batches {shapes}, sample 0 "
        f"faceless): losses {[round(x['loss'], 4) for x in losses]}, ms per "
        f"step {[round(x, 1) for x in ms]} (host clock, synchronised), "
        f"launches {got}")
    for x in losses:
        check(all(v == v and abs(v) != float("inf") for v in x.values()),
              f"tracked step: non-finite metrics {x}")
    want = {"roi_sampler": 2 * TRACKED_STEPS,
            "ctc_lattice_fwd": TRACKED_STEPS,
            "ctc_lattice_bwd": TRACKED_STEPS, "ctc_greedy": 0}
    check(got == want, f"tracked steps launched {got}, want {want}")
    stages = {}
    for k in range(STAGE_STEPS):
        tr.train_step(with_faceless(next(it), cfg, 10 + k), stage_ms=stages)
    log(f"[train-tracked] stages (mean of {STAGE_STEPS} steps, host clock, "
        "synchronised): " + ", ".join(
            f"{k} {v / STAGE_STEPS:.2f} ms" for k, v in stages.items()))

    # kernel 1 at the step's shapes: a full batch at the largest bucket
    big = with_faceless(ds.batch(list(range(cfg.data.batch_size)),
                                 max(cfg.data.time_buckets)), cfg, 20)
    srv = dict(gpu, cfg=cfg)
    tracked_roi_kernels(srv, torch.as_tensor(big.frames, device=DEV),
                        rows, "train-tracked")
    del tr

    # the zero-weight pin: a faceless sample's pixels do not reach the loss
    off = {"model.dropout": 0.0, "train.roi_augment": 0.0}
    _, cfg0 = release_train_cfg(**dict(conv, **off))
    pin = []
    for seed in (9, 10):
        trp = make_trainer(cfg0, tree, gpu, DEV, TRAIN_DIR, tracked=True)
        mb = trp.model_batch(video_batch_to_device(
            with_faceless(big, cfg, seed), DEV))
        sw = mb["sample_weight"].tolist()
        pin.append(float(trp.train_step(with_faceless(big, cfg, seed))
                         ["loss"]))
        del trp
    log(f"[train-tracked] zero-weight pin: sample weights {sw}; losses with "
        f"two faceless backgrounds {pin[0]!r} and {pin[1]!r}")
    check(sw[0] == 0.0 and all(w == 1.0 for w in sw[1:]),
          f"the faceless sample's weight: {sw}")
    check(pin[0] == pin[1], f"the faceless sample's pixels reached the "
          f"loss: {pin}")

    # one dropout-off step from the seeded initialisation, card vs CPU
    _, cfgp = release_train_cfg(**dict(conv, **off,
                                       **{"train.warmup_steps": 0}))
    pb = FixtureVideoDataset(1, seed=2, cfg=cfgp.data).batch([0, 1], 32)
    short = pb.frame_lengths.copy()
    short[-1] -= 1
    out = {name: step_record(cfgp, b, dev, device, name, tracked=True)
           for name, b, dev, device in (
               ("card", pb, gpu, DEV),
               ("card_fault", dataclasses.replace(pb, frame_lengths=short),
                gpu, DEV),
               ("cpu", pb, cpu, "cpu"))}
    lr = cfgp.train.learning_rate
    read = {n: parity_readings(out[n], out["cpu"], lr)
            for n in ("card", "card_fault")}
    log(f"[train-tracked] one step without dropout from the seeded "
        f"initialisation, batch {tuple(pb.frames.shape[:2])}: loss card "
        f"{out['card']['loss']:.6f}, CPU {out['cpu']['loss']:.6f} "
        f"({out['cpu']['s']:.1f} s)")
    for k, lim in PARITY_LIMITS.items():
        log(f"[train-tracked]   {k}: card vs CPU {read['card'][k]:.4g}, "
            f"limit {lim:g}, planted fault (a length one short) "
            f"{read['card_fault'][k]:.4g}")
    for k, lim in PARITY_LIMITS.items():
        check(read["card"][k] <= lim,
              f"tracked step card vs CPU {k} {read['card'][k]} > {lim}")
        check(read["card_fault"][k] > lim, f"tracked step: the planted "
              f"fault's {k} {read['card_fault'][k]} is within {lim}")

    # the tracked evaluation: held-out clips, a cutaway in the first
    held = FixtureVideoDataset(HELDOUT_CLIPS, seed=HELDOUT_SEED,
                               cfg=cfg.data).batch(
        list(range(TRACKED_EVAL_SAMPLES)), max(cfg.data.time_buckets))
    held.frames[0, 3:9] = 0
    hyps = {}
    for name, dev, device in (("card", gpu, DEV), ("cpu", cpu, "cpu")):
        tre = make_trainer(cfg, tree, dev, device, TRAIN_DIR + "_" + name,
                           tracked=True)
        t0 = time.perf_counter()
        hyps[name] = transcripts(tre, [held], cfg.train.beam_width)
        secs = time.perf_counter() - t0
        if device == DEV:
            eval_ms = []
            timed_evaluate(tre, eval_ms)
            m = tre.evaluate([held])
        del tre
        shutil.rmtree(TRAIN_DIR + "_" + name, ignore_errors=True)
        log(f"[train-tracked] tracked evaluation on the {name}: "
            f"{secs:.2f} s (first call)")
    log(f"[train-tracked] tracked evaluate, {TRACKED_EVAL_SAMPLES} held-out "
        f"samples (frames 3-8 of the first blank), beam "
        f"{cfg.train.beam_width}: eval_cer {m['eval_cer']:.4f} eval_wer "
        f"{m['eval_wer']:.4f} in {eval_ms[0]:.1f} ms; transcripts card "
        f"{hyps['card']}, CPU {'equal' if hyps['cpu'] == hyps['card'] else hyps['cpu']}")
    check(hyps["card"] == hyps["cpu"], "tracked evaluation transcripts "
          "differ card against CPU")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def reseeding_remat(model, rois, dtype, gen, rate):
    """The planted fault of [remat]: ``_frontend_remat`` whose recompute
    reseeds the generator instead of replaying it."""
    from torch.utils.checkpoint import checkpoint

    ran = []

    def run(r):
        if ran:
            gen.manual_seed(REMAT_FAULT_SEED)
        ran.append(True)
        return model.frontend(r, dtype, gen, rate)

    return checkpoint(run, rois, use_reentrant=False,
                      preserve_rng_state=False)


def remat_grads(tr, cfg, mb, seed: int):
    """Loss and flat gradient (float64, host) of one training loss with
    dropout and the ROI jitter drawn from a generator seeded ``seed``."""
    import torch

    from lipreading_tpu_torch.models.lipreader import compute_loss

    gen = torch.Generator(device=DEV).manual_seed(seed)
    tr.model.zero_grad(set_to_none=True)
    loss, _ = compute_loss(tr.model, cfg, mb, train=True, gen=gen)
    loss.backward()
    return loss.item(), torch.cat([p.grad.detach().double().cpu().reshape(-1)
                                   for p in tr.model.parameters()])


def phase_remat(gpu, long, rows):
    """[remat]: [train-flash]'s long batch (flash on), the loss and gradient
    of one training step with and without ``train.remat``, dropout on, the
    same generator: within limits that a generator reseeded in the
    recompute breaks; then peak memory and step ms both ways."""
    import torch

    from lipreading_tpu_torch.data.pipeline import video_batch_to_device
    from lipreading_tpu_torch.models import lipreader

    over = {"model.flash_attention": 1, "data.max_chars": LONG_MAX_CHARS,
            "model.flash_bwd": "pallas"}
    tree, base = release_train_cfg(**over)
    remat = base.override(**{"train.remat": 1})
    batch = long_batch(long, base)
    tr = make_trainer(base, tree, gpu, DEV, TRAIN_DIR)
    with torch.no_grad():
        mb = tr.model_batch(video_batch_to_device(batch, DEV))
    wrappers = counted_wrappers()
    got = {}
    real = lipreader._frontend_remat
    runs = (("plain", base), ("plain_again", base), ("remat", remat),
            ("fault", remat))
    for name, cfg in runs:
        if name == "fault":
            lipreader._frontend_remat = reseeding_remat
        try:
            got[name] = remat_grads(tr, cfg, mb, REMAT_SEED)
        finally:
            lipreader._frontend_remat = real
    read = {n: grad_readings(got[n][1], got["plain"][1])
            for n in ("plain_again", "remat", "fault")}
    log(f"[remat] batch {tuple(batch.frames.shape[:2])}, flash on "
        f"(flash_bwd=pallas), dropout {base.model.dropout}, roi_augment "
        f"{base.train.roi_augment}, one generator: loss plain "
        f"{got['plain'][0]!r}, remat {got['remat'][0]!r}")
    for k, lim in REMAT_LIMITS.items():
        log(f"[remat]   {k} against plain: remat {read['remat'][k]:.4g}, "
            f"limit {lim:g}; plain again {read['plain_again'][k]:.4g}; "
            f"planted fault (the recompute reseeded) {read['fault'][k]:.4g}")
    check(got["remat"][0] == got["plain"][0],
          f"remat changed the loss: {got['remat'][0]} vs {got['plain'][0]}")
    for k, lim in REMAT_LIMITS.items():
        check(read["remat"][k] <= lim, f"remat gradient {k} "
              f"{read['remat'][k]} > {lim}")
        check(read["fault"][k] > lim, f"remat: the planted fault's {k} "
              f"{read['fault'][k]} is within {lim}")

    # memory and time of one step, remat off and on: the activations held
    # from the forward to the backward, the step's peak, its ms and launches
    from lipreading_tpu_torch.models.lipreader import compute_loss
    from lipreading_tpu_torch.ops import flash_attention as fa

    wrappers.update({w.__name__: w for w in fa.WRAPPERS})
    held, peak, step_ms, counts = {}, {}, {}, {}
    for name, cfg in (("off", base), ("on", remat)):
        tr.cfg = cfg
        tr.train_step(batch)
        torch.cuda.synchronize()
        tr.model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        gen = torch.Generator(device=DEV).manual_seed(REMAT_SEED)
        loss, _ = compute_loss(tr.model, cfg, mb, train=True, gen=gen)
        held[name] = (torch.cuda.memory_allocated() - m0) / 2**20
        loss.backward()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - m0) / 2**20
        del loss
        reset(wrappers.values())
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3
        counts[name] = {k: w.launches for k, w in wrappers.items()}
    path_launches(rows, "remat", counts["on"])
    log(f"[remat] one step (host clock, synchronised): remat off "
        f"{step_ms['off']:.1f} ms, activations held from the forward to the "
        f"backward {held['off']:.1f} MiB, the loss's peak {peak['off']:.1f} "
        f"MiB; remat on {step_ms['on']:.1f} ms, held {held['on']:.1f} MiB, "
        f"peak {peak['on']:.1f} MiB (above the parameters, gradients and "
        f"optimizer state); launches of a remat step {counts['on']}")
    layers = base.model.tf_layers
    want = {"roi_sampler": 1, "ctc_lattice_fwd": 1, "ctc_lattice_bwd": 1,
            "ctc_greedy": 0, "flash_fwd": layers, "flash_bwd_fused": 0,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    check(counts["on"] == want, f"remat step: launches {counts['on']}, want "
          f"{want} (the recompute is the frontend's alone)")
    del tr
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def phase_evaluate(rows):
    """[evaluate]: ``python -m lipreading_tpu_torch.evaluate`` in-process
    on the JAX script's held-out fixture clips (6 from seed 9090) from the
    release, ``decode=cascade`` (beam 8) and ``decode=ctc`` (beam 1, the
    greedy kernel): CER, launches, and the transcripts card equal to
    CPU."""
    import contextlib
    import io

    import torch

    from lipreading_tpu_torch.evaluate import main as evaluate

    wrappers = counted_wrappers()
    nowhere = os.path.join(DV_DIR, "no_workdir")
    for decode, beam, greedy in (("cascade", 8, 1), ("ctc", 1, EVAL_CLIPS)):
        argv = [f"decode={decode}", f"beam={beam}", f"workdir={nowhere}",
                f"n_clips={EVAL_CLIPS}"]
        out = {}
        for device in (DEV, "cpu"):
            reset(wrappers.values())
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out[device] = evaluate(argv + [f"device={device}"])
            if device == DEV:
                torch.cuda.synchronize()
                card_ms = (time.perf_counter() - t0) * 1e3
                got = {k: w.launches for k, w in wrappers.items()}
                lines = buf.getvalue().splitlines()
        path_launches(rows, f"evaluate {decode}", got)
        log(f"[evaluate] decode={decode} beam={beam}: {lines[-1]}; "
            + "".join(f"{x.strip()}; " for x in lines if "cascade:" in x)
            + f"{card_ms:.1f} ms on the card (with loading); launches {got}; "
            "transcripts card vs CPU "
            + ("equal" if out[DEV]["hyps"] == out["cpu"]["hyps"]
               else "DIFFER"))
        check(out[DEV]["hyps"] == out["cpu"]["hyps"],
              f"evaluate decode={decode}: card {out[DEV]['hyps']} vs CPU "
              f"{out['cpu']['hyps']}")
        want = {"roi_sampler": EVAL_CLIPS, "ctc_lattice_fwd": 0,
                "ctc_lattice_bwd": 0, "ctc_greedy": greedy}
        check(got == want, f"evaluate decode={decode}: launches {got}, want "
              f"{want}")
    shutil.rmtree(DV_DIR, ignore_errors=True)



# --- the bi-GRU family and the conv3d stem: the bigru_ctc and
# transformer_hybrid_universal releases served and trained


@contextlib.contextmanager
def planted(module, name: str, fake):
    """``module.name`` replaced by ``fake`` inside the block (a planted
    fault, or a tap)."""
    real = getattr(module, name)
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


def valid_rel_err(got, want, lengths) -> float:
    """rel_err over the valid frames of [B, T, ...] outputs (on the host)."""
    import torch

    lengths = torch.as_tensor(lengths).cpu()
    mask = torch.arange(got.shape[1])[None, :] < lengths[:, None]
    return rel_err(got.float().cpu()[mask], want.float().cpu()[mask])


def torch_flip(x, lengths):
    """[bigru]'s planted fault: the bi-GRU's backward direction reversed
    over the padded T (``torch.flip``) instead of within each length."""
    import torch

    return torch.flip(x, [1])


def symmetric_conv3d(x, w, b, strides=(1, 1, 1), dtype=None):
    """[conv3d]'s planted fault: ``models.nn.conv3d`` with a symmetric pad
    of k // 2 on every axis, where XLA's SAME pads the 5x5 stride-2
    convolution 1 before and 2 after."""
    import torch.nn.functional as F

    from lipreading_tpu_torch.ops.roi import full_float32

    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    pads = []
    for k in (w.shape[2], w.shape[1], w.shape[0]):
        pads += [k // 2, k // 2]
    xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)
    with full_float32():
        y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=tuple(strides))
    return y.permute(0, 2, 3, 4, 1) + b


def path_wrappers() -> dict:
    from lipreading_tpu_torch.ops.ctc import ctc_lattice_bwd, ctc_lattice_fwd
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.roi import sample_rois

    return {"roi_sampler": sample_rois, "ctc_greedy": ctc_greedy_ids,
            "ctc_lattice_fwd": ctc_lattice_fwd,
            "ctc_lattice_bwd": ctc_lattice_bwd}


def counted_call(wrappers: dict, fn):
    """``fn()`` with the counts set to 0 just before and read just after ->
    (its result, host ms, launches)."""
    import torch

    torch.cuda.synchronize()
    reset(wrappers.values())
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            {k: w.launches for k, w in wrappers.items()})


def port_rois(port, frames):
    """preprocess_clips on the port's device (the ERT)."""
    import torch

    from lipreading_tpu_torch.ops.preprocess import preprocess_clips

    dev = next(port["model"].parameters()).device
    with torch.inference_mode():
        return preprocess_clips(port["det"], port["ert"],
                                torch.as_tensor(frames, device=dev),
                                port["cfg"].preprocess)


def cascade_both(gpu, cpu, frames, lengths, wrappers, tag, **kw):
    """transcribe_cascade (beam 8, LM 0.4) end to end from each device's
    ROIs, counted on the card: transcripts and flags card vs CPU -> (card
    transcripts, host ms)."""
    import torch

    from lipreading_tpu_torch.infer import transcribe_cascade

    rois, cpu_rois = port_rois(gpu, frames), port_rois(cpu, frames)
    lens = torch.as_tensor(lengths, device="cuda")
    (texts, flags), ms, n = counted_call(wrappers, lambda: transcribe_cascade(
        gpu["model"], gpu["cfg"], rois, lens, return_flags=True,
        **CASCADE_KW, **kw))
    check(n["ctc_greedy"] == 1 and n["ctc_lattice_fwd"] == 0
          and n["ctc_lattice_bwd"] == 0,
          f"{tag} cascade {kw}: launches {n}, want 1 greedy and no lattice")
    cpu_texts, cpu_flags = transcribe_cascade(
        cpu["model"], cpu["cfg"], cpu_rois, torch.as_tensor(lengths),
        return_flags=True, **CASCADE_KW, **kw)
    log(f"{tag} cascade {kw or 'default margins'}: {ms:.1f} ms host clock, "
        f"{int(flags.sum())} of {len(texts)} clips rescored, launches {n}; "
        f"CPU transcripts {'equal' if cpu_texts == texts else 'DIFFER'}, "
        f"flags {'equal' if (cpu_flags == flags).all() else 'differ'}")
    check(cpu_texts == texts, f"{tag} cascade {kw}: card {texts} != CPU "
          f"{cpu_texts}")
    return texts, ms


def phase_bigru(frames, lengths, texts, rows):
    """[bigru]: the bigru_ctc release on [path]'s clips (bucket 96, the
    untracked ERT): greedy transcripts and the cascade (default margins and
    margin=inf) card equal to CPU, launches counted; the encoder output
    card against CPU from the same ROIs within a limit a planted fault
    breaks; CER, the stages' host ms, one recurrence's device ops and
    time, peak memory. Returns the card's and the CPU's port."""
    import torch

    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.models import gru
    from lipreading_tpu_torch.models.lipreader import (
        _act_dtype,
        ctc_logits,
        encode,
    )
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.text import Vocab

    t_phase = time.perf_counter()
    wrappers = path_wrappers()
    gpu = load_port("cuda", release=BIGRU_RELEASE)
    cpu = load_port("cpu", release=BIGRU_RELEASE)
    cfg, m = gpu["cfg"], gpu["cfg"].model
    B, T = frames.shape[:2]
    check(T == BIGRU_BUCKET, f"[bigru] clips padded to {T}, want "
          f"{BIGRU_BUCKET}")
    log(f"[bigru] release {BIGRU_RELEASE}: {m.frontend} stem "
        f"{m.frontend_channels}, bi-GRU {m.gru_layers} x H {m.gru_hidden}, "
        f"{cfg.decoder} head, {m.dtype}; {B} clips x {T} frames, lengths "
        f"{lengths.tolist()}")
    run_path(frames, lengths, gpu)                      # warm-up
    (hyps, flags), ms, n = counted_call(
        wrappers, lambda: run_path(frames, lengths, gpu))
    path_launches(rows, "bigru", n)
    log(f"[bigru] frames -> transcripts (transcribe_greedy): {ms:.1f} ms "
        f"host clock ({B * T / ms * 1e3:.0f} padded frames/s), launches {n}")
    check(n == {"roi_sampler": 1, "ctc_greedy": 1, "ctc_lattice_fwd": 0,
                "ctc_lattice_bwd": 0}, f"[bigru] launches {n}, want one ROI "
          "and one greedy launch a call")
    torch.cuda.reset_peak_memory_stats()
    run_path(frames, lengths, gpu)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    cer = corpus_cer(hyps, texts)
    for h, t, f in zip(hyps, texts, flags):
        log(f"[bigru]   {h!r:32} ref {t!r:32} margin flag {bool(f)}")
    t0 = time.perf_counter()
    cpu_hyps, cpu_flags = run_path(frames, lengths, cpu)
    log(f"[bigru] corpus CER {cer:.4f}; peak memory {peak:.1f} MiB; CPU run "
        f"({time.perf_counter() - t0:.1f} s): transcripts "
        f"{'equal' if cpu_hyps == hyps else 'DIFFER'}, margin flags "
        f"{'equal' if (cpu_flags == flags).all() else 'differ'}")
    check(cpu_hyps == hyps, f"[bigru] card {hyps} != CPU {cpu_hyps}")
    for kw in ({}, {"margin": float("inf")}):
        cascade_both(gpu, cpu, frames, lengths, wrappers, "[bigru]", **kw)

    # the encoder output, card vs CPU from the card's ROIs, and the fault
    dtype = _act_dtype(cfg)
    rois = port_rois(gpu, frames)
    lens = torch.as_tensor(lengths, device="cuda")
    with torch.inference_mode():
        enc = encode(gpu["model"], cfg, rois, lens, dtype)
        enc_cpu = encode(cpu["model"], cfg, rois.cpu(),
                         torch.as_tensor(lengths), dtype)
        with planted(gru, "flip_sequences", torch_flip):
            enc_fault = encode(gpu["model"], cfg, rois, lens, dtype)
    card, fault = (valid_rel_err(e, enc_cpu, lengths)
                   for e in (enc, enc_fault))
    log(f"[bigru] encoder output [B, T, {enc.shape[-1]}] {enc.dtype}, card vs "
        f"CPU rel_err over valid frames {card:.4g}, limit "
        f"{BIGRU_ENC_LIMIT:g}, planted fault (backward direction by "
        f"torch.flip) {fault:.4g}")
    check(torch.isfinite(enc.float()).all().item(), "[bigru] enc not finite")
    check(card <= BIGRU_ENC_LIMIT, f"[bigru] encoder card vs CPU {card} > "
          f"{BIGRU_ENC_LIMIT}")
    check(fault > BIGRU_ENC_LIMIT, f"[bigru] the planted fault's {fault} is "
          f"within the limit {BIGRU_ENC_LIMIT}")

    # where a call's time goes: the stem, the recurrence, head + greedy
    model, blank = gpu["model"], Vocab().blank_id
    st = {"stem": 0.0, "recurrence": 0.0, "head_greedy": 0.0}
    with torch.inference_mode():
        for i in range(4):          # the first pass warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = model.frontend(rois, dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc = model.encoder(feats, lens, dtype)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            lp = torch.log_softmax(ctc_logits(model, enc), -1)
            ctc_greedy_ids(lp, lens.to(torch.int32), blank=blank)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if i:
                for k, a, b in (("stem", t0, t1), ("recurrence", t1, t2),
                                ("head_greedy", t2, t3)):
                    st[k] += (b - a) * 1e3 / 3
        pr = beam_profile(lambda: (model.encoder(feats, lens, dtype), 0)[1])
    total = sum(st.values())
    log("[bigru] stages (host clock, synchronised, mean of 3): " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.1f} %)" for k, v in st.items()))
    log(f"[bigru] one recurrence ({m.gru_layers} layers x 2 directions x "
        f"{T} steps, B {B}) under torch.profiler: {pr['ops']} device ops, "
        f"device busy {pr['device_ms']:.2f} ms of {pr['host_ms']:.1f} ms host "
        f"(idle {100 * (1 - pr['device_ms'] / pr['host_ms']):.1f} %)")
    log(f"[bigru] phase {time.perf_counter() - t_phase:.1f} s")
    return gpu, cpu


def phase_conv3d(frames, lengths, texts, gpu_patchify, rows):
    """[conv3d]: the transformer_hybrid_universal release (conv3d stem) on
    [path]'s clips at buckets 96 and 128: greedy and cascade transcripts
    card equal to CPU, launches counted; the stem's output card against CPU
    from the same ROIs within a limit a planted fault (a symmetric pad)
    breaks; the stem's ms beside the patchify stem's."""
    import numpy as np
    import torch

    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.models import nn as lnn
    from lipreading_tpu_torch.models.lipreader import _act_dtype

    t_phase = time.perf_counter()
    wrappers = {**path_wrappers(), "conv3d_dgrad": lnn.conv3d_dgrad}
    gpu = load_port("cuda", release=CONV3D_RELEASE)
    cpu = load_port("cpu", release=CONV3D_RELEASE)
    m = gpu["cfg"].model
    log(f"[conv3d] release {CONV3D_RELEASE}: {m.frontend} stem "
        f"{m.frontend_channels}, framewise_norm {m.framewise_norm}, "
        f"transformer {m.tf_layers} x {m.tf_dim}, {gpu['cfg'].decoder}, "
        f"{m.dtype}")
    B, T = frames.shape[:2]
    for bucket in CONV3D_BUCKETS:
        fr = np.zeros((B, bucket) + frames.shape[2:], np.uint8)
        fr[:, :T] = frames
        run_path(fr, lengths, gpu)                      # warm-up
        (hyps, _), ms, n = counted_call(wrappers,
                                        lambda: run_path(fr, lengths, gpu))
        path_launches(rows, f"conv3d_{bucket}", n)
        cpu_hyps, _ = run_path(fr, lengths, cpu)
        log(f"[conv3d] bucket {bucket}: greedy {ms:.1f} ms host clock, "
            f"launches {n}, CER {corpus_cer(hyps, texts):.4f}, CPU "
            f"transcripts {'equal' if cpu_hyps == hyps else 'DIFFER'}")
        check(n["roi_sampler"] == 1 and n["ctc_greedy"] == 1
              and n["conv3d_dgrad"] == 0,
              f"[conv3d] bucket {bucket}: launches {n}")
        check(cpu_hyps == hyps, f"[conv3d] bucket {bucket}: card {hyps} != "
              f"CPU {cpu_hyps}")
        margins = ({}, {"margin": float("inf")}) if bucket == 96 else ({},)
        for kw in margins:
            casc, _ = cascade_both(gpu, cpu, fr, lengths, wrappers,
                                   f"[conv3d] bucket {bucket}", **kw)
        log(f"[conv3d] bucket {bucket}: cascade CER "
            f"{corpus_cer(casc, texts):.4f}")
        for h, t in zip(hyps, texts):
            log(f"[conv3d]   {h!r:32} ref {t!r}")

    # the stem card vs CPU from the card's ROIs (bucket 96), and the fault
    dtype = _act_dtype(gpu["cfg"])
    rois = port_rois(gpu, frames)
    with torch.inference_mode():
        feats = gpu["model"].frontend(rois, dtype)
        feats_cpu = cpu["model"].frontend(rois.cpu(), dtype)
        with planted(lnn, "conv3d", symmetric_conv3d):
            feats_fault = gpu["model"].frontend(rois, dtype)
        card, fault = (valid_rel_err(f, feats_cpu, lengths)
                       for f in (feats, feats_fault))
        stem_ms = time_ms(lambda: gpu["model"].frontend(rois, dtype), 20)
        patch_ms = time_ms(lambda: gpu_patchify["model"].frontend(rois, dtype),
                           20)
    log(f"[conv3d] stem output [B, T, {feats.shape[-1]}] {feats.dtype}: card "
        f"vs CPU rel_err over valid frames {card:.4g}, limit "
        f"{CONV3D_STEM_LIMIT:g}, planted fault (symmetric pad of the 5x5 "
        f"stride-2 convolution) {fault:.4g}")
    log(f"[conv3d] stem {stem_ms:.3f} ms beside [path]'s patchify stem "
        f"{patch_ms:.3f} ms (CUDA events, B {B} x T {T}, mean of 20)")
    check(card <= CONV3D_STEM_LIMIT, f"[conv3d] stem card vs CPU {card} > "
          f"{CONV3D_STEM_LIMIT}")
    check(fault > CONV3D_STEM_LIMIT, f"[conv3d] the planted fault's {fault} "
          f"is within the limit {CONV3D_STEM_LIMIT}")
    log(f"[conv3d] phase {time.perf_counter() - t_phase:.1f} s")


def phase_serve_bigru(rows):
    """[serve-bigru]: ``serve_batch`` of one steady batch of 16 rendered
    clips (bucket 96, beam 8, LM 0.4) with release=bigru_ctc and the
    default tracked conv preprocessing: every result present, the stage
    split, launches, the first 4 clips equal to the CPU's."""
    import numpy as np
    import torch

    from lipreading_tpu_torch.data.pipeline import _render_frames
    from lipreading_tpu_torch.fixtures import clip_text
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.serve import StageClock, load_server, serve_batch

    t_phase = time.perf_counter()
    wrappers = path_wrappers()
    B, bucket = SERVE_KW["B"], SERVE_KW["bucket"]
    frames = np.zeros((B, bucket, 160, 160, 3), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        f = _render_frames((100 + i, bucket))
        frames[i, :len(f)] = f
        lens[i] = len(f)
    refs = [clip_text(100 + i) for i in range(B)]
    srv = load_server(release=BIGRU_RELEASE, device="cuda")
    fr, ln = (torch.as_tensor(x, device="cuda") for x in (frames, lens))
    kw = {k: SERVE_KW[k] for k in ("beam", "lm_weight")}
    with torch.inference_mode():
        serve_batch(srv, fr, ln, **kw)                  # the first batch
        clock = StageClock(torch.device("cuda"))
        (out, ms, n) = counted_call(wrappers, lambda: serve_batch(
            srv, fr, ln, mark=clock.mark, **kw))
    texts, flags, segmented = out
    path_launches(rows, "serve-bigru", n)
    log(f"[serve-bigru] one steady batch of {B} clips x {bucket} frames, "
        f"release {BIGRU_RELEASE}, tracked conv preprocessing: {ms:.1f} ms "
        f"host clock ({int(lens.sum()) / ms * 1e3:.0f} real frames/s); "
        "stages " + ", ".join(f"{k} {v:.2f} ms" for k, v in clock.ms.items())
        + f"; {int(np.sum(flags))} rescored, {int(np.sum(segmented))} "
        f"segmented; launches {n}; CER {corpus_cer(texts, refs):.4f}")
    check(len(texts) == B and all(isinstance(t, str) for t in texts),
          "[serve-bigru] results missing")
    check(n["roi_sampler"] == 2 and n["ctc_greedy"] >= 1
          and n["ctc_lattice_fwd"] == 0,
          f"[serve-bigru] launches {n}, want 2 ROI launches (face crop and "
          "mouth) and a greedy launch a cascade call")
    k = SERVE_CPU_CLIPS
    cpu_srv = load_server(release=BIGRU_RELEASE, device="cpu")
    t0 = time.perf_counter()
    cpu_texts, _, _ = serve_batch(cpu_srv, torch.as_tensor(frames[:k]),
                                  torch.as_tensor(lens[:k]), **kw)
    log(f"[serve-bigru] first {k} clips on the CPU "
        f"({time.perf_counter() - t0:.1f} s): "
        f"{'equal' if cpu_texts == texts[:k] else 'DIFFER'}")
    check(cpu_texts == texts[:k], f"[serve-bigru] card {texts[:k]} != CPU "
          f"{cpu_texts}")
    log(f"[serve-bigru] phase {time.perf_counter() - t_phase:.1f} s")


def phase_train_bigru(gpu, cpu, rows):
    """[train-bigru]: FusedTrainer from the bigru_ctc release (batch 8,
    buckets 32-128, the release's training config): finite losses, one ROI,
    one launch of each CTC kernel and two of conv3d_dgrad a step, the
    stages; a fixed batch's loss falls from the seeded initialisation; one
    bf16 step card vs CPU within [parity]'s kind of limits that lengths one
    short break; one float32 hybrid step (the Bahdanau decoder) whose
    teacher-forced logits card vs CPU stay within a limit the attention
    mask off breaks; one step at teacher_forcing 0.5."""
    import dataclasses

    import torch

    from lipreading_tpu_torch.config import preset
    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
        video_batch_to_device,
    )
    from lipreading_tpu_torch.io import load_release
    from lipreading_tpu_torch.models import attention
    from lipreading_tpu_torch.models import nn as lnn
    from lipreading_tpu_torch.models.lipreader import (
        attention_logits,
        encode,
    )

    t_phase = time.perf_counter()
    # the conv3d stem's conv1 and conv2 take their input gradient from the
    # conv3d_dgrad kernel: two launches a step
    wrappers = {**path_wrappers(), "conv3d_dgrad": lnn.conv3d_dgrad}
    wd = TRAIN_DIR + "_bigru"
    tree, cfg = load_release(BIGRU_RELEASE)
    cfg = cfg.override(**{"data.batch_size": 8})
    ds = FixtureVideoDataset(TRAIN_CLIPS, seed=1, cfg=cfg.data)
    it = VideoBatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed)
    shutil.rmtree(wd, ignore_errors=True)
    tr = make_trainer(cfg, tree, gpu, "cuda", wd)
    tr.train_step(next(it))                             # warm-up
    losses, step_ms = [], []
    reset(wrappers.values())
    for _ in range(BIGRU_TRAIN_STEPS):
        batch = next(it)
        mtr, ms, _ = counted_call({}, lambda: tr.train_step(batch))
        step_ms.append(ms)
        losses.append({k: float(v) for k, v in mtr.items()})
        log(f"[train-bigru]   batch {tuple(batch.frames.shape[:2])}: loss "
            f"{losses[-1]['loss']:.4f} grad_norm "
            f"{losses[-1]['grad_norm']:.3f} ({ms:.1f} ms)")
    n = {k: w.launches for k, w in wrappers.items()}
    path_launches(rows, "train-bigru", n)
    log(f"[train-bigru] {BIGRU_TRAIN_STEPS} steps from {BIGRU_RELEASE} "
        f"(dropout {cfg.model.dropout}, {cfg.model.dtype}, batch "
        f"{cfg.data.batch_size}): {sum(step_ms) / len(step_ms):.1f} ms per "
        f"step (host clock, synchronised); launches {n}")
    for mt in losses:
        check(all(v == v and abs(v) != float("inf") for v in mt.values()),
              f"[train-bigru] non-finite step metrics {mt}")
    check(n == {"roi_sampler": BIGRU_TRAIN_STEPS, "ctc_greedy": 0,
                "ctc_lattice_fwd": BIGRU_TRAIN_STEPS,
                "ctc_lattice_bwd": BIGRU_TRAIN_STEPS,
                "conv3d_dgrad": 2 * BIGRU_TRAIN_STEPS},
          f"[train-bigru] launches {n}, want one ROI, one of each CTC "
          "kernel and two conv3d_dgrad a step")
    stages = {}
    for _ in range(STAGE_STEPS):
        tr.train_step(next(it), stage_ms=stages)
    log(f"[train-bigru] stages (mean of {STAGE_STEPS} steps, host clock, "
        "synchronised): " + ", ".join(f"{k} {v / STAGE_STEPS:.2f} ms"
                                      for k, v in stages.items()))
    del tr

    # a fixed batch from the seeded initialisation: its loss falls
    cfg_fix = cfg.override(**{"train.warmup_steps": 0})
    tr = make_trainer(cfg_fix, None, gpu, "cuda", wd)
    batch = ds.batch(list(range(cfg.data.batch_size)),
                     max(cfg.data.time_buckets))
    before = det_loss(tr, batch)
    for _ in range(FIXED_STEPS):
        tr.train_step(batch)
    after = det_loss(tr, batch)
    log(f"[train-bigru] fixed batch {tuple(batch.frames.shape[:2])} from the "
        f"seeded initialisation: loss without dropout {before:.4f} -> "
        f"{after:.4f} after {FIXED_STEPS} steps")
    check(after < before, f"[train-bigru] fixed-batch loss did not fall: "
          f"{before} -> {after}")
    del tr

    # one bf16 step card vs CPU, and the planted fault
    over = {"model.dropout": 0.0, "train.roi_augment": 0.0,
            "train.warmup_steps": 0}
    cfg_p = cfg.override(**over)
    pair = FixtureVideoDataset(1, seed=2, cfg=cfg.data).batch([0, 1], 32)
    short = pair.frame_lengths.copy()
    short[-1] -= 1
    faulty = dataclasses.replace(pair, frame_lengths=short)
    out = {name: step_record(cfg_p, b, dev, device, "bigru_" + name)
           for name, b, dev, device in (("card", pair, gpu, "cuda"),
                                        ("card_fault", faulty, gpu, "cuda"),
                                        ("cpu", pair, cpu, "cpu"))}
    lr = cfg_p.train.learning_rate
    read = {k: parity_readings(out[k], out["cpu"], lr)
            for k in ("card", "card_fault")}
    for k, lim in BIGRU_PARITY_LIMITS.items():
        log(f"[train-bigru]   bf16 step {k}: card vs cpu "
            f"{read['card'][k]:.4g}, limit {lim:g}, planted fault (a length "
            f"one short) {read['card_fault'][k]:.4g}")
    for k, lim in BIGRU_PARITY_LIMITS.items():
        check(read["card"][k] <= lim, f"[train-bigru] step card vs CPU {k} "
              f"{read['card'][k]} > {lim}")
        check(read["card_fault"][k] > lim, f"[train-bigru] the planted "
              f"fault's {k} {read['card_fault'][k]} is within {lim}")

    # float32 hybrid (the Bahdanau decoder) from a seeded init: teacher-
    # forced logits card vs CPU from the card's ROIs, then one step
    cfg_h = preset("bigru-ctc").override(**{
        "decoder": "hybrid", "train.ctc_weight": 0.5, "train.att_weight": 0.5,
        "model.dtype": "float32", "model.dropout": 0.0,
        "train.warmup_steps": 0})
    trs = {d: make_trainer(cfg_h, None, port, d, wd + "_" + d)
           for d, port in (("cuda", gpu), ("cpu", cpu))}
    with torch.no_grad():
        mb = trs["cuda"].model_batch(video_batch_to_device(pair, "cuda"))

        def logits(device):
            b = {k: v.to(device) for k, v in mb.items()}
            model = trs[device].model
            enc = encode(model, cfg_h, b["rois"], b["frame_lengths"])
            return attention_logits(model, cfg_h, enc, b["frame_lengths"],
                                    b["targets"])

        card, cpu_l = logits("cuda"), logits("cpu")

        def no_mask(lengths, max_len):
            return torch.ones(lengths.shape[0], max_len, dtype=torch.bool,
                              device=lengths.device)

        with planted(attention, "length_mask", no_mask):
            fault = logits("cuda")
    r_card, r_fault = rel_err(card.cpu(), cpu_l), rel_err(fault.cpu(), cpu_l)
    mh = trs["cuda"].train_step(pair)
    log(f"[train-bigru] float32 bigru-ctc decoder=hybrid from the seeded "
        f"initialisation: teacher-forced logits {tuple(card.shape)} card vs "
        f"CPU rel_err {r_card:.4g}, limit {BIGRU_LOGITS_LIMIT:g}, planted "
        f"fault (attention mask off) {r_fault:.4g}; one step: loss "
        f"{float(mh['loss']):.4f} (ctc {float(mh['ctc_loss']):.4f}, att "
        f"{float(mh['att_loss']):.4f})")
    check(r_card <= BIGRU_LOGITS_LIMIT, f"[train-bigru] logits card vs CPU "
          f"{r_card} > {BIGRU_LOGITS_LIMIT}")
    check(r_fault > BIGRU_LOGITS_LIMIT, f"[train-bigru] the planted fault's "
          f"{r_fault} is within {BIGRU_LOGITS_LIMIT}")
    check(all(float(v) == float(v) for v in mh.values()),
          f"[train-bigru] hybrid step metrics {mh}")
    del trs

    # scheduled sampling: the coins from the step's generator
    cfg_ss = preset("bigru-ctc").override(**{
        "decoder": "hybrid", "train.ctc_weight": 0.5, "train.att_weight": 0.5,
        "train.teacher_forcing": 0.5})
    tr = make_trainer(cfg_ss, None, gpu, "cuda", wd + "_ss")
    mss, ms, _ = counted_call({}, lambda: tr.train_step(pair))
    log(f"[train-bigru] teacher_forcing 0.5 ({cfg_ss.model.dtype}, dropout "
        f"{cfg_ss.model.dropout}): one step, loss {float(mss['loss']):.4f} "
        f"(att {float(mss['att_loss']):.4f}), {ms:.1f} ms")
    check(all(float(v) == float(v) and abs(float(v)) != float("inf")
              for v in mss.values()), f"[train-bigru] step metrics {mss}")
    del tr
    for d in ("", "_cuda", "_cpu", "_ss"):
        shutil.rmtree(wd + d, ignore_errors=True)
    log(f"[train-bigru] phase {time.perf_counter() - t_phase:.1f} s")


# --- streaming and the demo: StreamingTranscriber's greedy and quality
# configs, the pinned styled stream, ctc_viterbi_align, the demo entry


def stream_ports(device: str) -> dict:
    """universal4 and the robust preprocessing (with the presence head) on
    ``device``, as ``python -m lipreading_tpu_torch.stream_latency`` loads
    them."""
    from lipreading_tpu_torch.io import load_preprocessors, load_release_model

    model, cfg = load_release_model(RELEASE, device=device)
    prep = load_preprocessors(cfg.preprocess.landmarker, STREAM_ASSETS,
                              tracked=True, device=device)
    return {"model": model, "cfg": cfg, "prep": prep}


def stream_build(port, kind: str):
    from lipreading_tpu_torch import stream_latency as sl

    return sl.build(kind, port["model"], port["cfg"], port["prep"],
                    STREAM_WINDOW, STREAM_CHUNK, STREAM_BEAM, STREAM_LM)


@contextlib.contextmanager
def tapped_stream(st, taps: list):
    """Inside the block, each window decode of ``st`` appends (the window's
    log-probs [W, V] on the host, its length, ``_ctx``) to ``taps``."""
    from lipreading_tpu_torch import streaming

    real_window, real_lp = st._window, streaming.ctc_log_probs
    ctx = []

    def window(T):
        ctx.append(st._ctx)
        return real_window(T)

    def log_probs(model, cfg, rois, lengths):
        lp = real_lp(model, cfg, rois, lengths)
        taps.append((lp[0].float().cpu(), int(lengths[0]), ctx[-1]))
        return lp

    st._window = window
    try:
        with planted(streaming, "ctc_log_probs", log_probs):
            yield taps
    finally:
        del st._window


def commit_machinery(st, lp, T: int, ctx: int):
    """What a window decode of ``st`` does after the encoder, from one
    window's log-probs [W, V], on the transcriber's device: the argmax
    path, the prefix beam's ids over the rolled live suffix and the
    Viterbi path of its stripped labels, rolled back -> host tensors."""
    import torch

    with torch.inference_mode():
        lp = lp.to(st.device)[None]
        length = torch.tensor([T], dtype=torch.int32, device=st.device)
        rolled, ids, n = st._beam(lp, length, ctx)
        vit = st._force(rolled, ids, n, length, ctx)
        return [x.cpu() for x in (torch.argmax(lp, dim=-1), ids, n, vit)]


def first_argmax_flip(card_taps, cpu_taps):
    """The first window decode whose argmax paths part over the valid
    frames -> (decode index, frame, the card's and the CPU's top-1 minus
    top-2 margin there), or None."""
    import torch

    for i, ((a, T, _), (b, _, _)) in enumerate(zip(card_taps, cpu_taps)):
        pa, pb = torch.argmax(a[:T], -1), torch.argmax(b[:T], -1)
        diff = torch.nonzero(pa != pb).flatten()
        if diff.numel():
            f = int(diff[0])
            margin = [float(x[f].topk(2).values[0] - x[f].topk(2).values[1])
                      for x in (a, b)]
            return i, f, margin[0], margin[1]
    return None


def stream_profile(port, kind: str, frames, target: int) -> dict:
    """Chunk ``target`` of a fresh stream under ``torch.profiler``, the
    chunks before it fed outside the profile -> host ms, device busy ms
    and device ops. An empty profile is taken again on a replayed stream,
    as in ``device_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    C = STREAM_CHUNK
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        st = stream_build(port, kind)
        for k in range(target):
            st.feed(frames[k * C:(k + 1) * C])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st.feed(frames[target * C:(target + 1) * C])
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return {"host_ms": host, "ops": len(dev),
                    "device_ms": sum(e.time_range.elapsed_us()
                                     for e in dev) / 1e3}
        log(f"[profiler] stream profile {attempt} of {PROFILE_ATTEMPTS} "
            "recorded no device time: taken again")
        time.sleep(1.0)
    check(False, f"torch.profiler recorded no device time in "
          f"{PROFILE_ATTEMPTS} stream profiles")


def stream_stages(port, kind: str, frames) -> list[dict]:
    """A fresh stream with its stages timed chunk by chunk (host clock,
    the card synchronised around each): the tracked preprocessing and its
    tracking loop, the untracked preprocessing, the window's encoder, the
    prefix beam, the Viterbi alignment and the segment's joint beam ->
    [{stage: ms, "chunk": ms}] a chunk."""
    import torch

    from lipreading_tpu_torch import streaming

    split: dict = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = (split.get(name, 0.0)
                           + (time.perf_counter() - t0) * 1e3)
            return out
        return run

    names = {"ctc_log_probs": "encoder", "ctc_prefix_beam_device":
             "prefix beam", "ctc_viterbi_align": "viterbi",
             "decode_ids": "segment joint beam", "track_boxes": "tracking",
             "preprocess_frames": "preprocess"}
    st = stream_build(port, kind)
    st._pre_tracked = timed("tracked preprocess", st._pre_tracked)
    out = []
    with contextlib.ExitStack() as stack:
        for attr, name in names.items():
            stack.enter_context(planted(streaming, attr, timed(
                name, getattr(streaming, attr))))
        for lo in range(0, frames.shape[0], STREAM_CHUNK):
            split.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.feed(frames[lo:lo + STREAM_CHUNK])
            torch.cuda.synchronize()
            out.append(dict(split, chunk=(time.perf_counter() - t0) * 1e3))
    return out


def stream_config(kind: str, gpu, cpu, frames, truth, rows) -> None:
    """One config of ``stream_latency`` on the card (warm, then timed and
    counted) and on the CPU: every feed's transcript and the final one
    equal, or a near tie shown; the commit machinery card == CPU from the
    card's log-probs; the readings; one decode-bearing chunk profiled."""
    import torch

    from lipreading_tpu_torch import stream_latency as sl

    wrappers = counted_wrappers()
    C = STREAM_CHUNK
    dur_s = frames.shape[0] / sl.FPS
    sl.run_stream(stream_build(gpu, kind), frames, C,
                  torch.cuda.synchronize)                      # warm-up
    st = stream_build(gpu, kind)
    torch.cuda.synchronize()
    reset(wrappers.values())
    text, times, finish_ms, hyps = sl.run_stream(st, frames, C,
                                                 torch.cuda.synchronize)
    n = {k: w.launches for k, w in wrappers.items()}
    path_launches(rows, f"stream {kind}", n)
    rep = sl.report(kind, text, truth, times, finish_ms, C, dur_s)
    chunks = rep["chunks"]
    per_call = 2 if gpu["cfg"].preprocess.landmarker == "conv" else 1
    want_roi = per_call * (chunks + (st.cut_events if kind == "quality"
                                     else 0))
    log(f"[stream] {kind}: {json.dumps(rep)}")
    log(f"[stream] {kind}: counts {st.counts}, cut events {st.cut_events}; "
        f"launches {n} over {chunks} chunks ({n['roi_sampler'] / chunks:.3f}"
        f" ROI launches a chunk, want {want_roi})")
    check(n["roi_sampler"] == want_roi and n["ctc_greedy"] == 0
          and n["ctc_lattice_fwd"] == 0,
          f"[stream] {kind}: launches {n}, want {want_roi} ROI launches (one "
          "a chunk, one more a re-acquire) and no other")
    if kind == "quality":
        check(st.counts["tail_beam"] > 0 and st.counts["segment"] > 0,
              f"[stream] quality: counts {st.counts}")

    card_taps, cpu_taps = [], []
    st = stream_build(gpu, kind)
    with tapped_stream(st, card_taps):
        card = sl.run_stream(st, frames, C, torch.cuda.synchronize)
    check(card[0] == text and card[3] == hyps,
          f"[stream] {kind}: two card runs differ")
    t0 = time.perf_counter()
    st = stream_build(cpu, kind)
    with tapped_stream(st, cpu_taps):
        cpu_text, _, _, cpu_hyps = sl.run_stream(st, frames, C)
    same = cpu_hyps == hyps and cpu_text == text
    log(f"[stream] {kind}: CPU run ({time.perf_counter() - t0:.1f} s): "
        f"every feed's transcript and the final one "
        f"{'equal' if same else 'DIFFER'}; {len(card_taps)} window decodes")
    if not same:
        k = next((i for i, (a, b) in enumerate(zip(hyps, cpu_hyps))
                  if a != b), len(hyps))
        flip = first_argmax_flip(card_taps, cpu_taps)
        log(f"[stream] {kind}: the streams part at chunk {k} (card "
            f"{hyps[k] if k < len(hyps) else text!r}, CPU "
            f"{cpu_hyps[k] if k < len(cpu_hyps) else cpu_text!r}); first "
            f"argmax flip (decode, frame, card margin, CPU margin): {flip}")
        check(flip is not None and min(flip[2], flip[3]) < NEAR_TIE_NATS,
              f"[stream] {kind}: card {text!r} != CPU {cpu_text!r} with no "
              f"near tie (< {NEAR_TIE_NATS} nats) shown")
    # the commit machinery from the same (the card's) log-probs, with the
    # quality config's beam and LM
    machinery = (stream_build(gpu, "quality"), stream_build(cpu, "quality"))
    for i, (lp, T, ctx) in enumerate(card_taps):
        if i % 3 and i != len(card_taps) - 1:
            continue
        a, b = (commit_machinery(m, lp, T, ctx) for m in machinery)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"[stream] {kind}: decode {i} (T {T}, ctx {ctx}): the argmax, "
              "beam or Viterbi path from the same log-probs differs card vs "
              "CPU")
    log(f"[stream] {kind}: argmax, prefix beam and Viterbi card == CPU from "
        f"the card's log-probs at every third window decode")

    # the stages of each chunk; the two slowest (the p95 of 19) apart
    stages = stream_stages(gpu, kind, frames)
    total = {}
    for d in stages:
        for k, v in d.items():
            total[k] = total.get(k, 0.0) + v
    log(f"[stream] {kind}: stages over the stream (host ms, synchronised; "
        "tracking inside tracked preprocess, encoder = the window decodes', "
        "the segment decode's own encoder inside its joint beam): "
        + ", ".join(f"{k} {v:.2f}" for k, v in total.items()))
    for d in sorted(stages, key=lambda d: -d["chunk"])[:2]:
        log(f"[stream] {kind}: a slowest chunk: "
            + ", ".join(f"{k} {v:.2f}" for k, v in d.items()))

    # one decode-bearing chunk (a window decode in it) under the profiler
    st = stream_build(gpu, kind)
    target, taps = None, []
    for k in range(chunks):
        before = len(taps)
        with tapped_stream(st, taps):
            st.feed(frames[k * C:(k + 1) * C])
        if k >= 6 and len(taps) > before:
            target = k
            break
    check(target is not None, f"[stream] {kind}: no decode-bearing chunk")
    pr = stream_profile(gpu, kind, frames, target)
    log(f"[stream] {kind}: chunk {target} (a window decode) under the "
        f"profiler: host {pr['host_ms']:.1f} ms, device busy "
        f"{pr['device_ms']:.2f} ms (idle "
        f"{100 * (1 - pr['device_ms'] / pr['host_ms']):.1f} %), {pr['ops']} "
        "device ops")


def viterbi_case(seed: int):
    """A seeded batch: log-probs [6, 64, 31], labels with repeats, ragged
    input and label lengths (each feasible)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    B, T, V, L = 6, 64, 31, 20
    lp = torch.log_softmax(2 * torch.randn(B, T, V, generator=g), -1)
    labels = torch.randint(3, V, (B, L), generator=g, dtype=torch.int32)
    labels[:, 1] = labels[:, 0]                     # a repeat in every row
    in_len = torch.tensor([64, 50, 33, 20, 64, 5], dtype=torch.int32)
    lab_len = torch.tensor([20, 11, 15, 0, 9, 2], dtype=torch.int32)
    return lp, labels, in_len, lab_len


def viterbi_gate(lp, labels, in_len, lab_len):
    """ctc_viterbi_align on the card against the CPU -> (equal, every row
    collapses to its labels)."""
    import torch

    from lipreading_tpu_torch.ops.ctc import ctc_viterbi_align

    args = (lp, labels, in_len, lab_len)
    got = ctc_viterbi_align(*(x.cuda() for x in args)).cpu()
    want = ctc_viterbi_align(*args)
    collapses = True
    for b in range(lp.shape[0]):
        row = got[b, :int(in_len[b])].tolist()
        col = [c for i, c in enumerate(row) if i == 0 or c != row[i - 1]]
        collapses &= [c for c in col if c != 0] == \
            labels[b, :int(lab_len[b])].tolist()
    return torch.equal(got, want), collapses


def phase_stream_viterbi(window_lp) -> None:
    """ctc_viterbi_align card vs CPU at the stream's shape (a window's log-
    probs, its greedy labels) and on a seeded ragged batch; a planted fault
    (the skip allowed between repeated labels) must break the gate."""
    import torch

    from lipreading_tpu_torch.ops import ctc

    lp, T, _ = window_lp
    path = torch.argmax(lp[:T], -1).tolist()
    lab = [c for i, c in enumerate(path) if (i == 0 or c != path[i - 1])
           and c != 0]
    labels = torch.zeros((1, max(len(lab), 1)), dtype=torch.int32)
    labels[0, :len(lab)] = torch.tensor(lab, dtype=torch.int32)
    cases = {"stream window": (lp[None], labels, torch.tensor([T]),
                               torch.tensor([len(lab)])),
             "seeded batch": viterbi_case(0)}
    for name, case in cases.items():
        eq, col = viterbi_gate(*case)
        log(f"[stream] viterbi {name} ({tuple(case[0].shape)}): card "
            f"{'==' if eq else '!='} CPU, collapses to the labels: {col}")
        check(eq and col, f"[stream] viterbi {name}: equal {eq}, collapses "
              f"{col}")
    # the fault: blank almost impossible, so with the skip allowed a
    # repeated label takes it and the path collapses short
    lp = torch.full((1, 8, 31), -30.0)
    lp[0, :5, 5] = 0.0
    lp[0, 5:, 7] = 0.0
    case = (torch.log_softmax(lp, -1), torch.tensor([[5, 5, 7]],
                                                    dtype=torch.int32),
            torch.tensor([8]), torch.tensor([3]))
    check(all(viterbi_gate(*case)), "[stream] viterbi fault case fails "
          "without the fault")
    with planted(ctc, "_skip_ok", lambda ext, blank: ext != blank):
        got = ctc.ctc_viterbi_align(*(x.cuda() for x in case)).cpu()
    eq = torch.equal(got, ctc.ctc_viterbi_align(*case))
    log(f"[stream] viterbi planted fault (the skip between repeated "
        f"labels): card path {got[0].tolist()}, card == CPU {eq}")
    check(not eq, "[stream] the planted Viterbi fault passed the gate")


def phase_stream(rows) -> None:
    """[stream]: the greedy and quality configs of ``python -m
    lipreading_tpu_torch.stream_latency`` over make_clip(33001..33003) on
    the card and the CPU; the pinned styled stream (CER 0, a cut event);
    ctc_viterbi_align card vs CPU with a planted fault."""
    import numpy as np
    import torch

    from lipreading_tpu_torch import stream_latency as sl
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.metrics import cer

    t_phase = time.perf_counter()
    gpu, cpu = stream_ports("cuda"), stream_ports("cpu")
    clips = [make_clip(s, gpu["cfg"].data) for s in STREAM_SEEDS]
    frames = np.concatenate([c.frames for c in clips])
    truth = " ".join(c.text for c in clips)
    log(f"[stream] {frames.shape[0]} frames of make_clip{STREAM_SEEDS} in "
        f"chunks of {STREAM_CHUNK}, window {STREAM_WINDOW}, release "
        f"{RELEASE}, {STREAM_ASSETS} assets")
    for kind in ("greedy", "quality"):
        stream_config(kind, gpu, cpu, frames, truth, rows)

    # the pinned styled stream of test_styled_stream_ladder_pin
    wrappers = counted_wrappers()
    styled = [make_clip(s, gpu["cfg"].data, variation=0.6)
              for s in STYLED_SEEDS]
    sf = np.concatenate([c.frames for c in styled])
    struth = " ".join(c.text for c in styled)
    st = stream_build(gpu, "quality")
    taps = []
    with tapped_stream(st, taps):
        (hyp, _, _, _), ms, n = counted_call(wrappers, lambda: sl.run_stream(
            st, sf, STREAM_CHUNK, torch.cuda.synchronize))
    path_launches(rows, "stream styled", n)
    e = cer(hyp, struth)
    log(f"[stream] styled {STYLED_SEEDS} at variation 0.6: {hyp!r} (truth "
        f"{struth!r}), CER {e:.4f}, cut events {st.cut_events}, counts "
        f"{st.counts}, {ms:.1f} ms host clock, launches {n}")
    check(e == 0.0 and st.cut_events >= 1,
          f"[stream] styled stream: CER {e}, cut events {st.cut_events}")
    phase_stream_viterbi(taps[-1])
    log(f"[stream] phase {time.perf_counter() - t_phase:.1f} s")


def phase_demo(rows) -> None:
    """[demo]: ``python -m lipreading_tpu_torch.demo`` in-process on fixture
    clip 3 (bigru_ctc, beam 8), the untracked batch mode and ``stream=16``,
    on the card and the CPU: the printed transcripts equal. The stream
    outgrows its window, so its commits force the beam onto the frames
    (``ctc_viterbi_align``, counted)."""
    import io

    from lipreading_tpu_torch import streaming
    from lipreading_tpu_torch.demo import main as demo

    wrappers = counted_wrappers()
    nowhere = os.path.join(ROOT, "runs", "chip_smoke_demo_none")
    real_align = streaming.ctc_viterbi_align
    aligned = []

    def align(*a, **k):
        aligned.append(a[0].device.type)
        return real_align(*a, **k)

    for mode in ([], ["stream=16"]):
        name = "demo " + (mode[0] if mode else "batch")
        argv = [f"workdir={nowhere}", "fixture_seed=3"] + mode
        lines = {}
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if device == "cuda":
                    demo(argv + ["device=cuda"])        # loads, warms up
                    buf.truncate(0)
                    buf.seek(0)
                    aligned.clear()
                    with planted(streaming, "ctc_viterbi_align", align):
                        _, ms, n = counted_call(
                            wrappers, lambda: demo(argv + ["device=cuda"]))
                else:
                    demo(argv + ["device=cpu"])
            lines[device] = [x for x in buf.getvalue().splitlines()
                             if x.startswith(("transcript:", "reference :",
                                              "  t="))]
        path_launches(rows, name, n)
        log(f"[demo] {name}: {ms:.1f} ms with loading; launches {n}; "
            f"{len(aligned)} Viterbi alignments on the card; "
            + "; ".join(lines["cuda"]) + "; CPU "
            + ("equal" if lines["cpu"] == lines["cuda"] else "DIFFERS"))
        check(lines["cpu"] == lines["cuda"] and lines["cuda"],
              f"[demo] {name}: card {lines['cuda']} != CPU {lines['cpu']}")
        check(n["roi_sampler"] > 0, f"[demo] {name}: launches {n}")
        if mode:
            check(aligned and set(aligned) == {"cuda"},
                  f"[demo] {name}: Viterbi alignments on {aligned}")

def render_fixture(seed: int):
    """make_clip(seed) in a worker process."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from lipreading_tpu_torch.fixtures import make_clip

    return make_clip(seed)


def start_preproc_clips(pool) -> dict:
    """Render [preproc-train]'s clips in the worker processes meanwhile."""
    return {k: [pool.submit(render_fixture, s) for s in seeds]
            for k, seeds in PRE_CLIPS.items()}


def weight_readings(card: dict, cpu: dict, start: dict) -> dict:
    """Numpy weight dicts -> |card - CPU| over all weights relative to |CPU|
    (``rel``, the gate) and to |CPU - start| (``rel_update``), and the
    largest |card - CPU|."""
    import numpy as np

    sq = lambda d: sum(float((v.astype(np.float64) ** 2).sum())  # noqa: E731
                       for v in d.values())
    diff = {k: card[k] - cpu[k] for k in cpu}
    return {"rel": (sq(diff) / sq(cpu)) ** 0.5,
            "rel_update": (sq(diff) / sq({k: cpu[k] - start[k]
                                          for k in cpu})) ** 0.5,
            "max_abs": max(float(np.abs(v).max()) for v in diff.values())}


def trainer_times(name: str, run, steps=(10, 40)) -> dict:
    """``run(k)`` trains k steps on the card: ms a step from ``time_ms``
    (CUDA events, synchronised: the difference of ``steps[1]`` and
    ``steps[0]`` steps, so set-up cancels), and the device share of one
    ``steps[1]``-step run (``device_ms``'s busy ms over its host ms)."""
    import torch

    a = time_ms(lambda: run(steps[0]), iters=2)
    b = time_ms(lambda: run(steps[1]), iters=2)
    step = (b - a) / (steps[1] - steps[0])
    dev = device_ms(lambda: run(steps[1]), iters=1)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps[1])
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    log(f"[preproc-train] {name}: {step:.3f} ms a step (time_ms, "
        f"{steps[1]} minus {steps[0]} steps); a {steps[1]}-step run "
        f"{host:.1f} ms host clock, {dev:.2f} ms of device work "
        f"(torch.profiler), device share {dev / host:.1%}")
    return {"ms_step": step, "device_ms": dev, "host_ms": host,
            "share": dev / host}


def preproc_compare(name: str, run, start: dict, fault=None) -> dict:
    """``run(device)`` -> numpy weights after the first steps; card against
    CPU within PRE_WEIGHT_LIMIT, and ``fault()``'s card weights (a planted
    fault) past it."""
    card, cpu = run(DEV), run("cpu")
    r = weight_readings(card, cpu, start)
    msg = (f"[preproc-train] {name}, {PRE_CMP_STEPS} steps card vs CPU: "
           f"|card - CPU| / |CPU| = {r['rel']:.3g} (limit "
           f"{PRE_WEIGHT_LIMIT:g}), / |update| = {r['rel_update']:.3g}, "
           f"max {r['max_abs']:.3g}")
    if fault is not None:
        f = weight_readings(fault(), cpu, start)
        msg += (f"; planted fault {f['rel']:.3g} (/ |update| "
                f"{f['rel_update']:.3g})")
        r["fault"] = f["rel"]
    log(msg)
    check(r["rel"] <= PRE_WEIGHT_LIMIT, f"{name}: card vs CPU {r['rel']}")
    check(fault is None or r["fault"] > PRE_WEIGHT_LIMIT,
          f"{name}: the planted fault passes ({r.get('fault')})")
    return r


def phase_preproc_train(pre_futures, rows) -> None:
    """[preproc-train]: the preprocessor trainers on the card at full width
    (detector 1->8->16->32->4, conv landmarker width 1.0, batch 64, the
    presence head full batch): the first steps of each card against CPU
    (from one start and one set of numpy indices; the landmarker with
    roi_loss_weight 0 and 1, and a planted fault, the ROI term's landmarks
    detached); ms a step and device share of each; the detector's 1500
    steps and held-out box error; the presence head's 600 steps on the
    shipped trunk and held-out confidences; ERT boosting on the host; the
    JAX test's 700-step distillation (< 3 px) with its teacher pass's ROI
    launches and the kernel against its plain version at the teacher
    crop's shape; the gate metrics card vs CPU; the transcript gate card
    vs CPU."""
    import io

    import numpy as np
    import torch

    from lipreading_tpu_torch import preproc_training as pt
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.ops.detector import detect, params_to_torch
    from lipreading_tpu_torch.ops.landmarker import (
        CROP,
        init_landmarker,
        round_face_boxes,
    )
    from lipreading_tpu_torch.oracle.roi import grayscale
    from lipreading_tpu_torch.oracle.detector import init_detector
    from lipreading_tpu_torch.oracle.ert_train import landmark_error, train_ert
    from lipreading_tpu_torch.train_landmarker import gate_transcript_cer
    from lipreading_tpu_torch.train_presence import max_conf, negatives

    t_phase = time.perf_counter()
    clips = {k: [f.result(timeout=600) for f in v]
             for k, v in pre_futures.items()}
    det_np, ert_np = load_assets()
    wrappers = counted_wrappers()
    summary = {}

    # the detector, on train_all's corpus
    gray, boxes, lms = pt._collect_frames(clips["det"])
    tg, tb, tl = pt._collect_frames(clips["det_held"], stride=4)
    log(f"[preproc-train] detector corpus {gray.shape[0]} frames of "
        f"{len(clips['det'])} clips; held-out {tg.shape[0]} frames")
    preproc_compare("detector", lambda d: pt.train_detector(
        gray, boxes, steps=PRE_CMP_STEPS, device=d), init_detector(0))
    summary["detector"] = trainer_times(
        "detector (batch 64)",
        lambda k: pt.train_detector(gray, boxes, steps=k, device=DEV))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = pt.train_detector(gray, boxes, device=DEV)
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    err = pt.detector_box_error(det, tg, tb, DEV)
    shipped_err = pt.detector_box_error(det_np, tg, tb, DEV)
    log(f"[preproc-train] train_detector 1500 steps at batch 64: "
        f"{det_s:.2f} s; held-out box error {err:.3f} px (the shipped "
        f"detector: {shipped_err:.3f} px)")
    check(np.isfinite(err), f"detector box error {err}")

    # ERT boosting on the host
    t0 = time.perf_counter()
    ert = train_ert(gray, boxes, lms, **PRE_ERT)
    ert_s = time.perf_counter() - t0
    log(f"[preproc-train] train_ert {PRE_ERT} on the host: {ert_s:.2f} s; "
        f"held-out landmark error {landmark_error(ert, tg, tb, tl):.5f} box "
        f"units")

    # the presence head on the shipped trunk, as scripts/train_presence.py
    pg, pb, _ = pt._collect_frames(clips["presence"], stride=3)
    H, W = pg.shape[1:]
    neg = negatives(0, H, W, 0.0)
    feats = {d: pt.presence_features(det_np, pg, neg, pb, d)
             for d in (DEV, "cpu")}
    init = pt.init_presence_head(feats["cpu"][0].shape[-1], 0)
    preproc_compare("presence head", lambda d: pt.fit_presence_head(
        init, *feats[d], steps=PRE_CMP_STEPS), init)
    summary["presence"] = trainer_times(
        f"presence head (full batch, {feats['cpu'][0].shape[0]} frames)",
        lambda k: pt.fit_presence_head(init, *feats[DEV], steps=k))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head = pt.train_presence_head(det_np, pg, neg, pb, device=DEV)
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t0
    hg, _, _ = pt._collect_frames(clips["presence_held"], stride=4)
    detc = params_to_torch(det_np, DEV)
    headc = {k: torch.as_tensor(v, device=DEV) for k, v in head.items()}
    pos_c = max_conf(detc, headc, hg, DEV)
    neg_c = max_conf(detc, headc, negatives(500, H, W, 0.0)[:24], DEV)
    log(f"[preproc-train] train_presence_head 600 steps: {head_s:.2f} s; "
        f"held-out face conf min {pos_c.min():.3f} mean {pos_c.mean():.3f}, "
        f"faceless max {neg_c.max():.3f} mean {neg_c.mean():.3f}")
    check(np.isfinite(pos_c).all() and np.isfinite(neg_c).all(),
          "presence confidences")

    # the conv landmarker: first steps card vs CPU, roi_loss_weight 0 and 1
    cmp_clips = clips["lmk"][:PRE_CMP_CLIPS]
    cg = np.stack([grayscale(c.frames[t]) for c in cmp_clips
                   for t in range(c.num_frames)]).astype(np.float32)
    start = init_landmarker(0, mean_shape=pt.teacher_pass(
        det_np, ert_np, cg, "cpu")[1].mean(axis=0))

    def lmk_run(device, w, k=PRE_CMP_STEPS, batch=64):
        return pt.train_conv_landmarker(det_np, ert_np, cmp_clips, steps=k,
                                        batch=batch, roi_loss_weight=w,
                                        verbose=False, device=device)

    real = pt.roi_term_rois

    def detached(lm, *a):          # the planted fault
        return real(lm.detach(), *a)

    def faulty():
        with planted(pt, "roi_term_rois", detached):
            return lmk_run(DEV, 1.0)

    for w in (0.0, 1.0):
        preproc_compare(f"conv landmarker roi_loss_weight={w:g}",
                        lambda d, w=w: lmk_run(d, w), start,
                        fault=faulty if w else None)
        summary[f"landmarker roi={w:g}"] = trainer_times(
            f"conv landmarker (batch 64, roi_loss_weight={w:g})",
            lambda k, w=w: lmk_run(DEV, w, k))

    # the JAX test's distillation: 6 clips, 700 steps at batch 32
    torch.cuda.synchronize()
    lg = np.stack([grayscale(c.frames[t]) for c in clips["lmk"]
                   for t in range(c.num_frames)]).astype(np.float32)
    lm, ms, n = counted_call(wrappers, lambda: pt.train_conv_landmarker(
        det_np, ert_np, clips["lmk"], steps=LMK_STEPS, batch=LMK_BATCH,
        verbose=False, device=DEV))
    want = -(-lg.shape[0] // pt.TEACHER_CHUNK)
    path_launches(rows, "preproc-train teacher", n)
    held = clips["lmk_held"]
    err = {k: pt.conv_landmarker_error(lm, det_np, ert_np, held, device=d)
           for k, d in (("card", DEV), ("cpu", "cpu"))}
    agree = {k: pt.conv_box_agreement(lm, det_np, ert_np, held, device=d)
             for k, d in (("card", DEV), ("cpu", "cpu"))}
    total = sum(c.num_frames for c in held)
    log(f"[preproc-train] train_conv_landmarker {LMK_STEPS} steps at batch "
        f"{LMK_BATCH} on {lg.shape[0]} frames of make_clip(9100..9105): "
        f"{ms / 1e3:.2f} s; launches {n} (the teacher pass: {want} expected, "
        f"one a {pt.TEACHER_CHUNK} frames); held-out make_clip(9300, 9301) "
        f"error vs the ERT {err['card']:.4f} px on the card, "
        f"{err['cpu']:.4f} on the CPU (limit {LMK_ERR_PX} px; card vs CPU "
        f"{abs(err['card'] - err['cpu']):.3g}, limit {LMK_ERR_LIMIT:g}); "
        f"rounded-box agreement {agree['card']:.4f} / {agree['cpu']:.4f} of "
        f"{total} frames")
    check(err["card"] < LMK_ERR_PX, f"distilled error {err['card']} px")
    check(abs(err["card"] - err["cpu"]) <= LMK_ERR_LIMIT,
          f"landmarker error card {err['card']} vs CPU {err['cpu']}")
    check(abs(agree["card"] - agree["cpu"]) * total <= 1 + 1e-9,
          f"box agreement card {agree['card']} vs CPU {agree['cpu']}")
    check(n["roi_sampler"] == want and sum(n.values()) == want,
          f"teacher pass launches {n}, want {want} ROI launches")

    # kernel 1 at the teacher crop's own shape (a chunk of 512 frames)
    g = torch.as_tensor(lg[:pt.TEACHER_CHUNK], device=DEV)
    with torch.no_grad():
        ibox = round_face_boxes(detect(detc, g), *g.shape[1:])
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=DEV)
    crop = roi_times("preproc-train teacher crop", g, ibox, CROP,
                     dict(mean=0.421, std=0.165, normalize=False), flush,
                     launch_floor_ms())
    del flush
    row = next(r for r in rows if r["name"] == "roi_sampler")
    row["preproc-train"] = dict(
        N=g.shape[0], R=CROP, normalize=0, max_abs_err=crop["err"],
        **{k: crop[k] for k in ("ms", "ms_raw", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "wrapper_ms")})
    row["max_abs_err"] = max(row["max_abs_err"], crop["err"])

    # the transcript gate: the release behind both paths, card vs CPU
    hyps = {}
    for k, d in (("card", DEV), ("cpu", "cpu")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, hyps[k] = gate_transcript_cer(
                lm, det_np, ert_np, PRE_GATE_RELEASE, 0.0, 0,
                n_clips=PRE_GATE_CLIPS, device=d)
        log(f"[preproc-train] {k}: {buf.getvalue().strip()} {hyps[k]}")
    check(hyps["card"] is not None and hyps["card"] == hyps["cpu"],
          f"transcript gate card {hyps['card']} != CPU {hyps['cpu']}")
    log(f"[preproc-train] ms a step: " + ", ".join(
        f"{k} {v['ms_step']:.3f} (device share {v['share']:.1%})"
        for k, v in summary.items()))
    log(f"[preproc-train] phase {time.perf_counter() - t_phase:.1f} s")


def mg_wrappers() -> dict:
    """The wrappers of kernel rows 3-7, by row name."""
    from lipreading_tpu_torch.ops import ctc, flash_attention as fa

    return {w.__name__: w for w in (ctc.ctc_lattice_fwd, ctc.ctc_lattice_bwd,
                                    *fa.WRAPPERS)}


def mg_cfg(base, name: str, batch, one: bool = False):
    """A layout's config: the release's, ``MG_BASE``, the layout's
    overrides (``one``: its model's alone, for one process) and the global
    batch's size."""
    over = {k: v for k, v in MG_LAYOUTS[name][0].items()
            if not one or k.startswith("model.")}
    rows = (len(batch["frame_lengths"]) if isinstance(batch, dict)
            else len(batch.frame_lengths))
    return base.override(**MG_BASE, **over, **{"data.batch_size": rows})


def mg_grads(tr) -> dict:
    """The trainer's reduced gradients, whole (a collective under tensor
    parallelism), on the host."""
    out = {}
    for k, p in tr.model.named_parameters():
        g = p.grad.detach()
        out[k] = (tr.tp.full(k, g) if tr.tp is not None else g).float().cpu()
    return out


def mg_readings(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| over every leaf (grad_rel) and the largest
    over the leaves but the k biases (leaf_rel: their true gradient is 0,
    softmax ignoring a constant shift, so they hold rounding noise)."""
    import torch

    g = torch.cat([got[k].reshape(-1) for k in want])
    w = torch.cat([want[k].reshape(-1) for k in want])
    leaf = max(float((got[k] - v).norm() / v.norm().clamp_min(1e-30))
               for k, v in want.items() if not k.endswith(".k.b"))
    return {"grad_rel": float((g - w).norm() / w.norm()), "leaf_rel": leaf}


def mg_reference(tree, base, name: str, batch: dict, path: str) -> dict:
    """The layout's global batch through a one-process Trainer on the card:
    MG_STEPS steps' losses and norms, the first step's gradients, the
    parameters after; saved to ``path`` for the ranks."""
    import torch

    from lipreading_tpu_torch.train.loop import Trainer

    cfg = mg_cfg(base, name, batch, one=True)
    tr = Trainer(cfg, os.path.join(os.path.dirname(path), f"one_{name}"),
                 device="cuda")
    tr.logger.echo = False
    tr.warm_start(tree)
    ref = {"loss": [], "grad_norm": [], "ms": []}
    for i in range(MG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        ref["ms"].append((time.perf_counter() - t0) * 1e3)
        ref["loss"].append(float(m["loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            ref["grads"] = mg_grads(tr)
    ref["params"] = {k: v.float().cpu()
                     for k, v in tr.model.state_dict().items()}
    torch.save(ref, path)
    return ref


def multigpu_rank(rank: int, world: int, tmp: str, backend: str) -> dict:
    """One rank of ``[multigpu]`` (spawned): every layout's MG_STEPS steps
    on this rank's rows, with its readings against the one-process steps
    (``mg_reference``), its launches of rows 3-7 and rank 0's ms a step;
    the TP checkpoint; then each planted fault's first-step reading."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from lipreading_tpu_torch.io import load_preprocessors
    from lipreading_tpu_torch.models import lipreader
    from lipreading_tpu_torch.ops.roi import sample_rois
    from lipreading_tpu_torch.parallel import comm
    from lipreading_tpu_torch.parallel.mesh import shard_batch
    from lipreading_tpu_torch.train import loop

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init(backend, rank, world, store=dist.FileStore(
        os.path.join(tmp, "store"), world))
    try:
        data = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        tree, base = data["tree"], data["cfg"]
        wrappers = mg_wrappers()
        out = {}

        def trainer(name):
            batch = data[MG_LAYOUTS[name][1]]
            cfg = mg_cfg(base, name, batch)
            tr = loop.Trainer(cfg, os.path.join(tmp, name), device=device)
            tr.logger.echo = False
            tr.warm_start(tree)
            return tr, shard_batch(batch, tr.mesh)

        for name in MG_LAYOUTS:
            ref = torch.load(os.path.join(tmp, f"ref_{name}.pt"),
                             weights_only=False)
            tr, local = trainer(name)
            rec = {"loss": [], "grad_norm": [], "ms": []}
            reset(wrappers.values())
            for i in range(MG_STEPS):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                m = tr.train_step(local)
                torch.cuda.synchronize(device)
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                if i == 0:
                    rec.update(mg_readings(mg_grads(tr), ref["grads"]))
            rec["launches"] = {k: w.launches / MG_STEPS
                               for k, w in wrappers.items()}
            params = {k: v.float().cpu()
                      for k, v in tr.whole_state_dict().items()}
            p = torch.cat([params[k].reshape(-1) for k in ref["params"]])
            q = torch.cat([v.reshape(-1) for v in ref["params"].values()])
            rec["param_rel"] = float((p - q).norm() / q.norm())
            rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                                  zip(rec["loss"], ref["loss"]))
            rec["norm_rel"] = max(abs(a - b) / abs(b) for a, b in
                                  zip(rec["grad_norm"], ref["grad_norm"]))
            if name == "dp2tp2":
                rec["ckpt"] = tr.save()
            out[name] = rec
            del tr

        # the fused DP 4 step: each rank preprocesses its own rows
        det, ert, _ = load_preprocessors("ert", "default", False, device)
        vb = data["video"]
        cfg = mg_cfg(base, "dp4", vb)
        tr = loop.FusedTrainer(cfg, os.path.join(tmp, "fused"), det, ert,
                               device=device)
        tr.logger.echo = False
        tr.warm_start(tree)
        sample_rois.launches = 0
        m = tr.train_step(shard_batch(vb, tr.mesh))
        out["fused"] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "roi_launches": sample_rois.launches}
        del tr

        sum_flat = loop._sum_flat
        faults = {
            "data all-reduce dropped": (loop, "_sum_flat", lambda mesh: (
                lambda ts, axis: None if axis is mesh.data
                else sum_flat(ts, axis))),
            "local mean, not the global denominator": (
                lipreader, "data_total", lambda mesh: (
                    lambda x, mesh=None: x)),
            "frontend summed over the model axis (PP)": (
                loop, "model_reduced", lambda mesh: (
                    lambda names, cfg, mp: [n for n in names if n.startswith(
                        ("frontend.", "encoder.layers."))])),
        }
        out["faults"] = {}
        for fault, name in MG_FAULTS.items():
            ref = torch.load(os.path.join(tmp, f"ref_{name}.pt"),
                             weights_only=False)
            tr, local = trainer(name)
            module, attr, make = faults[fault]
            with planted(module, attr, make(tr.mesh)):
                tr.train_step(local)
            out["faults"][fault] = mg_readings(mg_grads(tr), ref["grads"])
            del tr
        return out
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(world: int, fn, args: tuple, tmp: str) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; a rank that
    fails ends them all; every join has a time limit."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, fn, args, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MG_JOIN_S
    try:
        while any(p.is_alive() for p in procs):
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    errors = [open(os.path.join(tmp, f"err{r}.txt")).read()
              for r in range(world)
              if os.path.exists(os.path.join(tmp, f"err{r}.txt"))]
    check(not errors, "a rank failed:\n" + "\n".join(errors))
    check(all(p.exitcode == 0 for p in procs),
          f"ranks' exit codes {[p.exitcode for p in procs]} (a rank past "
          f"{MG_JOIN_S:g} s is killed)")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_entry(rank, world, fn, args, tmp):
    import pickle
    import traceback

    try:
        out = fn(rank, world, tmp, *args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def mg_nccl_world1(tmp: str, tree, base, batch, ref: dict) -> None:
    """One DP step over NCCL with one rank: the process group, the mesh's
    groups and the step's collectives (replicate's broadcast, the
    denominators', the gradients' and the losses' all-reduces) run on the
    card; its loss equals the one-process step's."""
    import torch
    import torch.distributed as dist

    from lipreading_tpu_torch.parallel import comm
    from lipreading_tpu_torch.parallel.mesh import make_mesh
    from lipreading_tpu_torch.train.loop import Trainer

    calls = {"all_reduce_": 0, "broadcast_": 0}

    def counting(name):
        real = getattr(comm, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    comm.init("nccl", 0, 1, store=dist.FileStore(
        os.path.join(tmp, "nccl_store"), 1))
    try:
        check(dist.get_backend() == "nccl", "the NCCL group is not NCCL")
        cfg = mg_cfg(base, "dp4", batch, one=True)
        with planted(comm, "all_reduce_", counting("all_reduce_")), \
                planted(comm, "broadcast_", counting("broadcast_")):
            tr = Trainer(cfg, os.path.join(tmp, "nccl"), device="cuda",
                         mesh=make_mesh(cfg.mesh))
            tr.logger.echo = False
            tr.warm_start(tree)
            m = tr.train_step(batch)
            x = torch.arange(4.0, device="cuda")
            got = comm.gather_cat(comm.psum(x, tr.mesh.world), tr.mesh.world,
                                  0)
            torch.cuda.synchronize()
        check(torch.equal(got, x), "NCCL psum/all_gather over one rank")
        rel = abs(float(m["loss"]) - ref["loss"][0]) / abs(ref["loss"][0])
        log(f"[multigpu] NCCL, world size 1: a DP step ran {calls} "
            f"collectives on the card; loss {float(m['loss']):.6f}, one "
            f"process {ref['loss'][0]:.6f} (rel {rel:.2e})")
        check(calls["all_reduce_"] >= 3 and calls["broadcast_"] >= 1,
              f"the NCCL step ran too few collectives: {calls}")
        check(rel <= MG_LIMITS["loss_rel"], f"NCCL step loss rel {rel:.3e}")
    finally:
        dist.destroy_process_group()


def phase_multigpu(gpu, long, rows) -> None:
    """Multi-GPU training: the four layouts on MG_RANKS ranks against the
    one-process steps, the planted faults, the TP checkpoint and a DP step
    over NCCL with one rank."""
    import dataclasses
    import filecmp
    import tempfile

    import numpy as np
    import torch

    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
        video_batch_to_device,
    )
    from lipreading_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MG_RANKS else "gloo"
    log(f"[multigpu] {n_cards} CUDA device(s): "
        + (f"{MG_RANKS} ranks over NCCL, one card each" if backend == "nccl"
           else f"{MG_RANKS} ranks share cuda:0 over gloo (NCCL takes one "
           "rank a device; its collectives are staged through host "
           "memory), so the step times below are ranks sharing one card, "
           "not a scaling figure"))
    tree, base = release_train_cfg()
    ds = FixtureVideoDataset(4, seed=1, cfg=base.data)
    vb = next(VideoBatchIterator(ds, base.data.batch_size, seed=0))
    # the labels rolled by one sample (the release already fits the
    # fixtures' own: loss ~3e-5), each CTC label cut to what its frames
    # can align
    vb = dataclasses.replace(vb, **{k: np.roll(getattr(vb, k), 1, 0) for k in
                                    ("targets", "target_lengths",
                                     "ctc_labels", "ctc_lengths")})
    vb.ctc_lengths = np.minimum(vb.ctc_lengths, np.maximum(
        (vb.frame_lengths - 1) // 2, 1)).astype(vb.ctc_lengths.dtype)
    fused = make_trainer(mg_cfg(base, "dp4", vb, one=True), tree, gpu,
                         "cuda", os.path.join(ROOT, "runs", "chip_smoke_mg"))

    def model_batch(v):
        with torch.no_grad():
            mb = fused.model_batch(video_batch_to_device(v, fused.device))
        return {k: t.cpu() for k, t in mb.items()}

    lb = long_batch(long, base.override(**{"data.max_chars": LONG_MAX_CHARS}))
    lb = dataclasses.replace(lb, **{k: np.roll(getattr(lb, k), 1, 0) for k in
                                    ("targets", "target_lengths",
                                     "ctc_labels", "ctc_lengths")})
    inputs = {"short": model_batch(vb), "long": model_batch(lb),
              "video": vb, "tree": tree, "cfg": base}
    fused_loss = float(fused.train_step(vb)["loss"])
    del fused
    tmp = tempfile.mkdtemp(prefix="mg_", dir=os.path.join(ROOT, "runs"))
    try:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        refs = {}
        for name, (_, kind) in MG_LAYOUTS.items():
            refs[name] = mg_reference(tree, base, name, inputs[kind],
                                      os.path.join(tmp, f"ref_{name}.pt"))
        t0 = time.perf_counter()
        res = spawn_ranks(MG_RANKS, multigpu_rank, (backend,), tmp)
        log(f"[multigpu] {MG_RANKS} ranks ran every layout and fault in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in MG_LAYOUTS:
            recs = [r[name] for r in res]
            r0 = recs[0]
            worst = {k: max(r[k] for r in recs) for k in
                     ("grad_rel", "leaf_rel", "loss_rel", "norm_rel",
                      "param_rel")}
            log(f"[multigpu] {name}: loss {r0['loss']} (one process "
                f"{refs[name]['loss']}), grad_norm {r0['grad_norm']}; worst "
                f"over ranks {worst}; rank 0 ms a step "
                f"{[round(x, 2) for x in r0['ms']]} (one process "
                f"{[round(x, 2) for x in refs[name]['ms']]}); launches a rank "
                f"a step {r0['launches']}")
            for r in recs:
                check(r["loss"] == r0["loss"] and
                      r["grad_norm"] == r0["grad_norm"],
                      f"{name}: the ranks read other losses or norms")
            for k, v in worst.items():
                check(v <= MG_LIMITS[k], f"{name}: {k} {v:.3e} above "
                      f"{MG_LIMITS[k]:g}")
            path_launches(rows, f"multigpu {name} (a rank a step)",
                          r0["launches"])
            check(r0["launches"]["ctc_lattice_fwd"] == 1
                  and r0["launches"]["ctc_lattice_bwd"] == 1,
                  f"{name}: not one launch of each CTC kernel a step")
        check(res[0]["dp2pp2"]["launches"]["flash_fwd"] > 0,
              "dp2pp2: no flash launch")
        rel = max(abs(r["fused"]["loss"] - fused_loss) / abs(fused_loss)
                  for r in res)
        log(f"[multigpu] fused DP 4 step (each rank preprocesses its own "
            f"rows): loss {res[0]['fused']['loss']:.6f}, one process "
            f"{fused_loss:.6f} (rel {rel:.2e}); ROI launches a rank "
            f"{[r['fused']['roi_launches'] for r in res]}")
        check(all(r["fused"]["roi_launches"] == 1 for r in res),
              "fused DP 4: not one ROI launch a rank")
        check(rel <= MG_LIMITS["loss_rel"], f"fused DP 4 loss rel {rel:.3e}")
        path_launches(rows, "multigpu fused dp4 (a rank a step)",
                      {"roi_sampler": res[0]["fused"]["roi_launches"]})
        for fault, reading in res[0]["faults"].items():
            log(f"[multigpu] planted fault, {fault}: {reading}")
            check(reading["grad_rel"] > MG_LIMITS["grad_rel"]
                  or reading["leaf_rel"] > MG_LIMITS["leaf_rel"],
                  f"the planted fault ({fault}) passes the limits")
        path = res[0]["dp2tp2"]["ckpt"]
        one = Trainer(mg_cfg(base, "dp2tp2", inputs["short"], one=True),
                      os.path.join(tmp, "one_ckpt"), device="cuda")
        one.logger.echo = False
        one.restore(path)
        same = filecmp.cmp(one.save(), path, shallow=False)
        log(f"[multigpu] the DP 2 x TP 2 checkpoint rank 0 wrote, restored "
            f"and saved by one process: byte-equal {same}")
        check(same, "the TP checkpoint is not the one-process file")
        mg_nccl_world1(tmp, tree, base, inputs["short"], refs["dp4"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[multigpu] phase {time.perf_counter() - t_phase:.1f} s")


def load_torch_ref():
    """``tests/torch_ref.py`` (the reference-shaped model and its host
    decodes; numpy and torch only) loaded by its path: on the card's
    machine another package named ``tests`` shadows the repo's."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "torch_ref.py")
    spec = importlib.util.spec_from_file_location("torch_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gate_cfg(decoder: str):
    """The parity gate's small float32 bi-GRU (``tests/test_parity_gate.py``
    ``_gate_cfg``)."""
    from lipreading_tpu_torch.config import preset

    cfg = preset("bigru-ctc")
    cfg.decoder = decoder
    m = cfg.model
    m.frontend_channels = (8, 16, 24)
    m.frontend_dim, m.gru_hidden, m.gru_layers = 64, 48, 2
    m.attn_dim, m.decoder_hidden = 32, 48
    m.dtype = "float32"
    cfg.train.max_decode_len = 24
    cfg.train.length_penalty = 0.6
    return cfg


def gate_clips():
    """The per-frame oracle's ROIs of make_clip(33000 + i), zero-padded to
    their longest -> (rois [B, T, R, R], lengths [B]), as the gate pads."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.oracle.pipeline import run_clip

    det, ert = load_assets()
    rois = [run_clip(make_clip(PG_FIRST_SEED + i).frames, det, ert).roi
            for i in range(PG_CLIPS)]
    lengths = np.asarray([r.shape[0] for r in rois], np.int32)
    T = int(lengths.max())
    return np.stack([np.pad(r, ((0, T - len(r)), (0, 0), (0, 0)))
                     for r in rois]).astype(np.float32), lengths


def prefix_search(lp, lengths, width: int) -> list[str]:
    """The numpy CTC prefix search on host log-posteriors [B, T, V]."""
    from lipreading_tpu_torch.ops.ctc_beam import ctc_prefix_beam_search
    from lipreading_tpu_torch.text import Vocab

    out = []
    for b in range(lp.shape[0]):
        ids, _ = ctc_prefix_beam_search(lp[b, :int(lengths[b])],
                                        beam_width=width,
                                        prune_topk=lp.shape[-1])
        out.append(Vocab().decode(ids))
    return out


def ref_logits(ref, rois, lengths):
    """The reference model's float32 CTC logits [B, T, V] on the host."""
    import torch

    with torch.no_grad():
        return ref.ctc_head(ref.encode(rois, lengths)).float().cpu()


def near_tie_frames(card_lp, cpu_logits, length: int) -> list:
    """The frames of one clip where the card's argmax parts from the CPU
    reference's -> [(frame, the CPU's two best logits' gap)]."""
    a = card_lp[:length].argmax(-1)
    b = cpu_logits[:length].argmax(-1)
    top2 = cpu_logits[:length].topk(2, dim=-1).values
    return [(int(t), float(top2[t, 0] - top2[t, 1]))
            for t in (a != b).nonzero().flatten().tolist()]


def gate_ctc(tag, got, want, card_lp, cpu_logits, lengths, card_want):
    """CTC transcripts card vs the CPU reference, clip by clip. A clip that
    differs only at frames whose CPU logits' two best lie within
    ``NEAR_TIE_LOGIT`` is a near tie: its margins are printed and the card
    reference (``card_want``, computed on demand) is its gate."""
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        frames = near_tie_frames(card_lp[b], cpu_logits[b], int(lengths[b]))
        check(frames and all(m < NEAR_TIE_LOGIT for _, m in frames),
              f"{tag} clip {b}: card {g!r} != CPU reference {w!r} "
              f"(argmax parts at (frame, CPU margin) {frames[:8]})")
        cw = card_want()[b]
        log(f"{tag} clip {b}: NEAR TIE at (frame, CPU logit margin) {frames}: "
            f"card {g!r}, CPU reference {w!r}, card reference {cw!r}")
        check(g == cw, f"{tag} clip {b}: card {g!r} != card reference {cw!r}")
        ties.append(b)
    return ties


def swapped_rz_import(real):
    """A planted fault: the GRU cell importer with the r and z gates'
    blocks swapped."""
    import numpy as np

    def fake(sd, prefix, layer=0, reverse=False):
        cell = real(sd, prefix, layer, reverse)
        H = cell["w_hh"].shape[0]
        return {k: np.concatenate([a[..., H:2 * H], a[..., :H],
                                   a[..., 2 * H:]], axis=-1)
                for k, a in cell.items()}

    return fake


def phase_parity_gate(rows) -> None:
    """[parity-gate]: the fp32 transcript parity gate on the card. The
    ``bigru_ctc`` release at full width in float32 is exported to the
    reference-shaped torch model of ``tests/torch_ref.py`` (strict load);
    on the per-frame oracle's ROIs of make_clip(33000-33004) the port's
    transcripts on the card (greedy through kernel 2, prefix beam 16) must
    equal the reference's own (greedy; the numpy prefix search, width 64)
    run on the CPU, a near tie excepted (then the reference on the card is
    the gate). Then the gate's four seeded legs at its small widths, and a
    planted fault: the GRU's r and z gates swapped in the import must change
    a transcript. TF32 off for the phase."""
    import copy

    import torch

    from lipreading_tpu_torch.infer import ctc_log_probs, transcribe
    from lipreading_tpu_torch.io import load_release_model
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.text import Vocab
    from lipreading_tpu_torch.train import importer

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tref = load_torch_ref()
        vocab = Vocab()
        wrappers = {"ctc_greedy": ctc_greedy_ids}
        greedy_launches = 0
        rois, lengths = gate_clips()
        rois_c, lens_c = torch.from_numpy(rois), torch.from_numpy(lengths)
        rois_d, lens_d = rois_c.to(DEV), lens_c.to(DEV)
        log(f"[parity-gate] the oracle's ROIs of make_clip({PG_FIRST_SEED}-"
            f"{PG_FIRST_SEED + PG_CLIPS - 1}): {tuple(rois.shape)}, lengths "
            f"{lengths.tolist()} ({time.perf_counter() - t_phase:.1f} s)")

        # the release leg, full width, float32
        model, cfg = load_release_model(BIGRU_RELEASE, device=DEV,
                                        overrides={"model.dtype": "float32"})
        m = cfg.model
        sd = importer.export_model_state_dict(model, cfg)
        ref = tref.TorchLipReader(cfg).eval()
        ref.load_state_dict(sd, strict=True)
        back = importer.lipreader_from_state_dict(sd, cfg, device=DEV)
        for k, v in model.state_dict().items():
            check(torch.equal(back.state_dict()[k], v),
                  f"[parity-gate] {k} changed over export and import")
        log(f"[parity-gate] {BIGRU_RELEASE}: frontend {m.frontend_channels}, "
            f"GRU {m.gru_hidden} x {m.gru_layers}, V {m.vocab_size}, float32; "
            f"{len(sd)} reference tensors, strict load; export -> import "
            "bit-exact")
        transcribe(model, cfg, rois_d, lens_d, beam=1)          # warm-up
        greedy, ms, n = counted_call(
            wrappers, lambda: transcribe(model, cfg, rois_d, lens_d, beam=1))
        check(n["ctc_greedy"] == 1, f"[parity-gate] greedy launches {n}")
        greedy_launches += n["ctc_greedy"]
        beam, beam_ms, nb = counted_call(
            wrappers, lambda: transcribe(model, cfg, rois_d, lens_d,
                                         beam=16))
        check(nb["ctc_greedy"] == 0, f"[parity-gate] beam launches {nb}")
        t0 = time.perf_counter()
        want_g = tref.ctc_greedy_transcripts(ref, rois_c, lens_c, vocab)
        lg_cpu = ref_logits(ref, rois_c, lens_c)
        want_b = prefix_search(torch.log_softmax(lg_cpu, -1).numpy(),
                               lengths, PG_RELEASE_SEARCH)
        cpu_s = time.perf_counter() - t0
        ref_d = copy.deepcopy(ref).to(DEV)
        card_g = tref.ctc_greedy_transcripts(ref_d, rois_d, lens_d, vocab)
        lg_card = ref_logits(ref_d, rois_d, lens_d)
        card_lp = ctc_log_probs(model, cfg, rois_d, lens_d).float().cpu()
        for b in range(len(greedy)):
            log(f"[parity-gate]   clip {b}: greedy {greedy[b]!r} beam16 "
                f"{beam[b]!r} | reference CPU {want_g[b]!r} / {want_b[b]!r}"
                f", card {card_g[b]!r}")
        ties = gate_ctc("[parity-gate] release greedy", greedy, want_g,
                        card_lp, lg_cpu, lengths, lambda: card_g)
        ties += gate_ctc(
            "[parity-gate] release prefix beam", beam, want_b, card_lp,
            lg_cpu, lengths, lambda: prefix_search(
                torch.log_softmax(lg_card, -1).numpy(), lengths,
                PG_RELEASE_SEARCH))
        log(f"[parity-gate] release leg: greedy (kernel 2, {ms:.1f} ms host) "
            f"and prefix beam 16 ({beam_ms:.1f} ms) string-identical to the "
            f"reference model's greedy and width-{PG_RELEASE_SEARCH} prefix "
            f"search on the CPU ({cpu_s:.1f} s){', near ties at clips ' + str(sorted(set(ties))) if ties else ''}"
            f"; the reference on the card "
            f"{'agrees' if card_g == want_g else 'DIFFERS: ' + str(card_g)}; "
            f"launches greedy {n}, beam {nb}")

        # the planted fault: r and z swapped in the import
        with planted(importer, "import_gru_cell",
                     swapped_rz_import(importer.import_gru_cell)):
            bad = importer.lipreader_from_state_dict(sd, cfg, device=DEV)
        bad_g = transcribe(bad, cfg, rois_d, lens_d, beam=1)
        changed = sum(a != b for a, b in zip(bad_g, greedy))
        log(f"[parity-gate] planted fault (GRU r and z swapped in the import):"
            f" {changed} of {len(greedy)} transcripts change, e.g. "
            f"{bad_g[0]!r}")
        check(changed > 0, "[parity-gate] the swapped-gate import changed no "
              "transcript")
        del model, back, bad, ref_d

        # the gate's seeded legs at its small widths
        for name, decoder, seed, width in PG_LEGS:
            gcfg = gate_cfg(decoder)
            torch.manual_seed(seed)
            ref = tref.TorchLipReader(gcfg).eval()
            r_c, l_c = rois_c, lens_c
            if name == "ctc prefix beam":
                with torch.no_grad():
                    ref.ctc_head.weight *= 64.0
                    ref.ctc_head.bias *= 64.0
                r_c, l_c = rois_c[:, :24].contiguous(), lens_c.clamp(max=24)
                gcfg.train.max_decode_len = 32
            port = importer.lipreader_from_state_dict(ref.state_dict(), gcfg,
                                                      device=DEV)
            r_d, l_d = r_c.to(DEV), l_c.to(DEV)
            got, _, n = counted_call(
                wrappers, lambda: transcribe(port, gcfg, r_d, l_d,
                                             beam=width))
            greedy_launches += n["ctc_greedy"]
            check(n["ctc_greedy"] == (1 if name == "ctc greedy" else 0),
                  f"[parity-gate] {name}: launches {n}")
            if decoder == "ctc":
                lg = ref_logits(ref, r_c, l_c)
                lp_card = ctc_log_probs(port, gcfg, r_d, l_d).float().cpu()
                ref_d = copy.deepcopy(ref).to(DEV)
                if width == 1:
                    want = tref.ctc_greedy_transcripts(ref, r_c, l_c, vocab)
                    card_want = lambda: tref.ctc_greedy_transcripts(  # noqa: E731
                        ref_d, r_d, l_d, vocab)
                else:
                    want = prefix_search(torch.log_softmax(lg, -1).numpy(),
                                         l_c.numpy(), PG_SEEDED_SEARCH)
                    card_want = lambda: prefix_search(  # noqa: E731
                        torch.log_softmax(ref_logits(ref_d, r_d, l_d),
                                          -1).numpy(), l_c.numpy(),
                        PG_SEEDED_SEARCH)
                ties += gate_ctc(f"[parity-gate] {name}", got, want, lp_card,
                                 lg, l_c.numpy(), card_want)
            elif width == 1:
                want = tref.attention_greedy_transcripts(
                    ref, r_c, l_c, vocab, gcfg.train.max_decode_len)
            else:
                want = tref.attention_beam_transcripts(
                    ref, r_c, l_c, vocab, beam=width,
                    max_len=gcfg.train.max_decode_len,
                    length_penalty=gcfg.train.length_penalty)
            if decoder == "attention":
                check(got == want, f"[parity-gate] {name}: card {got} != "
                      f"reference {want}")
            log(f"[parity-gate] seed {seed} {name} (beam {width}): "
                f"{'equal' if got == want else 'equal but for near ties'} "
                f"to the reference's; launches {n}; {got}")
        path_launches(rows, "parity-gate", {"ctc_greedy": greedy_launches})
        log(f"[parity-gate] kernel 2 launched {greedy_launches} times in the "
            f"phase's counted calls; phase {time.perf_counter() - t_phase:.1f}"
            " s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def trace_names(path: str) -> set:
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def phase_oracle(smi: str, rows) -> None:
    """[oracle]: the per-frame oracle on the card machine's host equal to
    ``tests/golden/clip0.npz`` exactly; the port's batched
    ``preprocess_frames`` on the card (kernel 1) over clip 0's first 48
    frames against it (face boxes and landmarks within 1e-2, mouth boxes
    equal, ROIs within 1e-3: ``parity_max_diff``), which a mouth box shifted
    one pixel must break; the host C++ oracle against it; frames/s of the
    numpy oracle, the C++ oracle and the card's preprocess by
    ``profiling.Timer``; a ``profiling.capture`` trace of a card preprocess
    that names the ROI kernel."""
    import numpy as np
    import torch

    from lipreading_tpu_torch import native, profiling
    from lipreading_tpu_torch.config import PreprocessConfig
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_frames
    from lipreading_tpu_torch.ops.roi import grayscale, sample_rois
    from lipreading_tpu_torch.oracle.pipeline import load_golden, run_clip

    t_phase = time.perf_counter()
    det, ert = load_assets()
    clip = make_clip(0)
    res = run_clip(clip.frames, det, ert)
    golden = load_golden(os.path.join(ROOT, "tests", "golden", "clip0.npz"))
    for k in ("gray", "face_boxes", "landmarks", "mouth_boxes", "roi"):
        check(np.array_equal(getattr(res, k), golden[k]),
              f"[oracle] run_clip's {k} differs from tests/golden/clip0.npz")
    log(f"[oracle] run_clip on clip 0 ({len(clip.frames)} frames) equals "
        "tests/golden/clip0.npz exactly (gray, face boxes, landmarks, mouth "
        "boxes, ROIs)")

    n = ORACLE_FRAMES
    frames = clip.frames[:n]
    pcfg = PreprocessConfig()
    det_d, ert_d = params_to_torch(det, DEV), model_to_torch(ert, DEV)
    fr = torch.as_tensor(frames, device=DEV)

    def card():
        with torch.inference_mode():
            return preprocess_frames(det_d, ert_d, fr, pcfg, return_aux=True)

    card()                                                     # warm-up
    (rois, aux), ms, cnt = counted_call({"roi_sampler": sample_rois}, card)
    check(cnt["roi_sampler"] == 1, f"[oracle] ROI launches {cnt}, want 1")
    def per_frame(v, k):
        d = (v.float().cpu() - torch.from_numpy(getattr(res, k)[:n])).abs()
        return d.reshape(n, -1).amax(1)

    fb_err, lm_err = (per_frame(aux[k], k) for k in ("face_boxes",
                                                       "landmarks"))
    roi_err = float(per_frame(rois, "roi").max())
    mouth_equal = bool(np.array_equal(aux["mouth_boxes"].cpu().numpy(),
                                      res.mouth_boxes[:n]))
    with torch.inference_mode():
        mb = aux["mouth_boxes"]
        shifted = mb + torch.tensor([1, 0, 0], device=DEV, dtype=mb.dtype)
        bad = sample_rois(grayscale(fr), shifted, pcfg.roi_size,
                          mean=pcfg.normalize_mean, std=pcfg.normalize_std)
    fault = float((bad.cpu() - torch.from_numpy(res.roi[:n])).abs().max())
    lim = ORACLE_LIMITS
    edges = (lm_err > lim["landmarks"]).nonzero().flatten().tolist()
    lm_rest = float(lm_err[lm_err <= lim["landmarks"]].max())
    log(f"[oracle] preprocess_frames on the card ({n} frames, {ms:.1f} ms "
        f"host, ROI launches {cnt['roi_sampler']}) against run_clip: face "
        f"boxes {float(fb_err.max()):.3g} px (limit {lim['face_boxes']:g}), "
        f"landmarks {lm_rest:.3g} px (limit {lim['landmarks']:g}) off "
        f"{len(edges)} ERT knife-edge frame(s), mouth boxes "
        f"{'equal' if mouth_equal else 'DIFFER'}, ROIs {roi_err:.3g} (limit "
        f"{lim['roi']:g}); planted fault (mouth boxes shifted 1 px) ROIs "
        f"{fault:.3g}")
    for t in edges:
        log(f"[oracle]   ERT knife edge at frame {t}: landmarks "
            f"{float(lm_err[t]):.3g} px with the face box "
            f"{float(fb_err[t]):.3g} px apart (a nearest-pixel lookup of the "
            "cascade flips; the JAX package's batched preprocess parts from "
            "its oracle there as well on the CPU)")
        check(fb_err[t] <= ORACLE_KNIFE_BOX,
              f"[oracle] frame {t}: landmarks {float(lm_err[t])} px apart "
              f"with the face box {float(fb_err[t])} px apart")
    log(f"[oracle] parity_max_diff {roi_err!r}")
    check(len(edges) <= ORACLE_KNIFE_EDGES, f"[oracle] landmarks beyond "
          f"{lim['landmarks']} px at frames {edges}")
    check(float(fb_err.max()) <= lim["face_boxes"],
          f"[oracle] face boxes card vs oracle {float(fb_err.max())}")
    check(mouth_equal, "[oracle] mouth boxes card != oracle")
    check(roi_err <= lim["roi"], f"[oracle] ROIs card vs oracle {roi_err}")
    check(fault > lim["roi"], f"[oracle] the shifted box's ROIs {fault} are "
          f"within {lim['roi']}")

    nat_rois, nat_lms = native.preprocess_clip(
        ert, frames, res.face_boxes[:n], return_landmarks=True)
    nat = (float(np.abs(nat_lms - res.landmarks[:n]).max()),
           float(np.abs(nat_rois - res.roi[:n]).max()))
    log(f"[oracle] the host C++ oracle (g++ build) from the oracle's face "
        f"boxes: landmarks {nat[0]:.3g} px (limit 1e-2), ROIs {nat[1]:.3g} "
        "(limit 1e-3)")
    check(nat[0] <= 1e-2 and nat[1] <= 1e-3,
          f"[oracle] the C++ oracle against run_clip: {nat}")

    fb = res.face_boxes[:n]
    fps = {
        "numpy oracle (detector, ERT, ROI per frame)": n / profiling.Timer(
            lambda: run_clip(frames, det, ert), warmup=1).measure(reps=3),
        "C++ oracle (gray, ERT, ROI per frame; boxes given)":
            n / profiling.Timer(lambda: native.preprocess_clip(
                ert, frames, fb), warmup=1).measure(reps=10),
        "card preprocess_frames (batched, kernel 1)": n / profiling.Timer(
            card, warmup=3).measure(reps=20),
    }
    for k, v in fps.items():
        log(f"[oracle] {k}: {v:.1f} frames/s over {n} frames (one reading; "
            f"{smi})")

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profiling.capture(ORACLE_DIR) as path:
            with profiling.span("oracle_card_preprocess"):
                card()
        names = trace_names(path)
        hit = sorted(x for x in names if "roi_sample" in x)
        if hit and "oracle_card_preprocess" in names:
            break
        log(f"[oracle] capture {attempt} of {PROFILE_ATTEMPTS} names no ROI "
            "kernel: taken again")
        time.sleep(1.0)
    check(bool(hit), f"[oracle] no capture of {PROFILE_ATTEMPTS} named the "
          "ROI kernel")
    log(f"[oracle] profiling.capture wrote {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(path)} bytes, attempt {attempt}): "
        f"{len(names)} event names, the ROI kernel as {hit[0][:60]!r}")
    path_launches(rows, "oracle", cnt)
    log(f"[oracle] phase {time.perf_counter() - t_phase:.1f} s")


def measure_rows(entry: str, out) -> list[tuple[str, dict, dict]]:
    """An entry's result as [(row name, {value name: value}, launches)] in
    its printed order."""
    if entry == "microbench":
        return [(r["op"], {"ms": r["ms"], "items/s": r["items_per_s"]},
                 r["launches"]) for r in out]
    if entry == "roofline_preprocess":
        keep = ("ms", "fps", "gbs", "gflops", "bw_pct", "f32_pct")
        return ([(r["stage"], {k: r[k] for k in keep if k in r},
                  r["launches"]) for r in out["rows"]]
                + [("gather10", out["gather10"], {}),
                   ("copy", out["copy"], {})])
    if entry == "bench_flash":
        return [(f"{r['T']} {r['bwd']}", {"fwd_ms": r["fwd_ms"],
                                          "fwd_bwd_ms": r["fwd_bwd_ms"]},
                 r["launches"]) for r in out]
    if entry == "bench_stem":
        return [(r["stem"], {k: r[k] for k in ("ms_per_step", "fps", "mfu",
                                               "loss", "params_m")},
                 r["launches"]) for r in out]
    if entry == "profile_train":
        return ([(r["name"], {"ms": r["ms"], "share_pct": r["share_pct"]},
                  r["launches"]) for r in out["rows"]]
                + [("sum of parts", {"ms": out["sum_ms"],
                                     "share_pct": out["sum_pct"]}, {})])
    if entry == "profile_decode":
        return [(r["name"], {"ms": r["ms"]}, r["launches"])
                for r in out["rows"]]
    if entry == "bench_decode_knee":
        return [(f"{r['section']} {r['B']}",
                 {k: r[k] for k in ("ms_per_call", "fps", "rescored_frac")
                  if k in r}, r["launches"]) for r in out]
    if entry == "bench_ingest":
        return [(k, {"frames/s": v}, {}) for k, v in out["rates"].items()]
    raise KeyError(entry)


def measure_printed(entry: str, name: str) -> str:
    """The text that names row ``name`` in ``entry``'s printed table."""
    if entry == "bench_flash":
        T, b = name.split()
        return f"{int(T):6d} {b:>7s}"
    if entry == "bench_decode_knee":
        sec, B = name.split()
        return f'"section": "{sec}", "B": {B}'
    return name


def measure_value_ok(name: str, key: str, v) -> bool:
    """A reading of [measure]: finite, and above 0 unless it is the decode
    profile's residual (a difference) or a share that may print as 0.0."""
    import math

    ok = isinstance(v, (int, float)) and math.isfinite(v)
    if name.endswith("(residual)") or key in ("bw_pct", "f32_pct",
                                               "rescored_frac"):
        return ok
    return ok and v > 0


def phase_measure(rows) -> None:
    """[measure]: the eight measurement entries at cut sizes (docstring)."""
    import importlib
    import io

    from lipreading_tpu_torch import flops

    t_phase = time.perf_counter()
    wrappers = mg_wrappers()
    wrappers.update(path_wrappers())
    mfu_known = flops.device_peak_flops("float32") is not None
    for entry, argv in MEASURE_ARGS.items():
        mod = importlib.import_module(f"lipreading_tpu_torch.{entry}")
        # transformer_hybrid's shapes from weights the smoke reads anyway
        kw = ({"release": MEASURE_RELEASE}
              if entry in ("profile_decode", "bench_decode_knee") else {})
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out, _, counts = counted_call(
                wrappers, lambda m=mod, kw=kw: m.main(argv, **kw))
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.rstrip().splitlines():
            log(f"[measure] {entry}: {line}")
        got = measure_rows(entry, out)
        names = [n for n, _, _ in got]
        check(names == MEASURE_ROWS[entry],
              f"[measure] {entry}: rows {names}, want {MEASURE_ROWS[entry]}")
        pos = 0
        for n in names:
            p = measure_printed(entry, n)
            check(p in text[pos:], f"[measure] {entry}: {p!r} not printed "
                  "in its order")
            pos = text.index(p, pos) + len(p)
        no_codec = entry == "bench_ingest" and out["no_codec"]
        for n, vals, launched in got:
            for k, v in vals.items():
                if v is None and no_codec and not n.startswith("null_"):
                    continue            # a codec key without OpenCV
                if k == "mfu" and not mfu_known:
                    continue
                check(measure_value_ok(n, k, v),
                      f"[measure] {entry} {n}: {k} = {v}")
            if "plain" in n.split("_"):
                check(not launched, f"[measure] {entry} {n}: a plain row "
                      f"launched {launched}")
            for kname in MEASURE_ROW_KERNELS.get(n, ()):
                check(launched.get(kname, 0) > 0,
                      f"[measure] {entry} {n}: no {kname} launch "
                      f"({launched})")
        launched = {k: v for k, v in counts.items() if v}
        for kname in MEASURE_KERNELS[entry]:
            check(counts[kname] > 0, f"[measure] {entry}: no {kname} launch "
                  f"in its run ({launched})")
        path_launches(rows, f"measure {entry}", counts)
        log(f"[measure] {entry}: {secs:.1f} s, launches {launched}")
    log(f"[measure] passed: every entry's rows in order, finite times, "
        f"every kernel of each entry launched, no plain-row launch "
        f"({time.perf_counter() - t_phase:.1f} s)")


def main() -> int:
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        log(f"chip_smoke: FAIL: {e}")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: FAIL: no CUDA device (this script never falls back "
            "to the CPU)")
        return 1
    try:
        import lipreading_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: FAIL: the port is not beside this script: {e}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "matmul and cuDNN TF32 off")
    pool = None
    try:
        pool, long_futures = start_long_clips()
        pre_futures = start_preproc_clips(pool)
        phase_build()
        smi = nvidia_smi_line()
        log(f"[card] {smi}")
        frames, lengths, texts = fixture_batch()
        gpu = load_port("cuda")
        rows = phase_kernels(frames, lengths, gpu)
        rows += phase_ctc_kernels(gpu["cfg"])
        rows += phase_flash_kernels()
        rows += phase_conv_dgrad()
        phase_path(frames, lengths, texts, gpu, rows)
        t0 = time.perf_counter()
        long = long_clips(long_futures)
        log(f"[path-flash] long clips rendered in worker processes "
            f"(waited {time.perf_counter() - t0:.1f} s)")
        flash = phase_path_flash(frames, lengths, gpu, long)
        phase_cascade(frames, lengths, gpu, flash)
        del flash
        gpu_t, cpu_t = phase_tracked(frames, lengths, rows)
        phase_segmented(gpu_t, cpu_t)
        phase_serve(gpu_t, cpu_t, rows)
        del gpu_t, cpu_t
        phase_train(gpu, rows)
        phase_train_avsr()
        phase_train_flash(gpu, long, rows)
        phase_train_parity(gpu)
        views = phase_dataview(rows)
        phase_train_dataview(views, rows)
        phase_train_tracked(rows)
        phase_remat(gpu, long, rows)
        phase_evaluate(rows)
        gpu_b, cpu_b = phase_bigru(frames, lengths, texts, rows)
        phase_conv3d(frames, lengths, texts, gpu, rows)
        phase_serve_bigru(rows)
        phase_train_bigru(gpu_b, cpu_b, rows)
        del gpu_b, cpu_b
        phase_stream(rows)
        phase_demo(rows)
        phase_preproc_train(pre_futures, rows)
        phase_parity_gate(rows)
        phase_oracle(smi, rows)
        phase_measure(rows)
        phase_multigpu(gpu, long, rows)
    except Exception as e:  # every phase failure ends here, without a result
        import traceback

        traceback.print_exc()
        log(f"chip_smoke: FAIL: {type(e).__name__}: {e}")
        return 1
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
